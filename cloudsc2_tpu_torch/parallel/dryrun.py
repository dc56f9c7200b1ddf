# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The multi-device dry run: the golden NL step and the full NL + TL + AD
step column-sharded over a mesh at the real workload's shape, with the real
gates; the port of ``dryrun_multichip`` (``__graft_entry__.py:34-134``).

nlev 137 and 128 columns a shard, f32; both factorings of the
``('node', 'device')`` mesh, ``(2, n / 2)`` and ``(1, n)``, where ``n`` is
even; the inputs placed on every shard; the NL outputs against the goldens
of the synthetic workload (:func:`cloudsc2_tpu_torch.oracle.synthetic_golden`,
in process) at the CPU single-precision gate of ``drivers/run_nonlinear.py``
(atol 1e-8, rtol 2e-3); ``full_step``'s per-column norms finite, not all
zero, and within the symmetry protocol's ``1e4`` f32 machine epsilons
(reference ``adjoint/validation.py:155-165``).  Any failure raises.

Usage:  python -m cloudsc2_tpu_torch.parallel.dryrun 4 --device cpu
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from cloudsc2_tpu_torch.iox import synthetic_input
from cloudsc2_tpu_torch.oracle import synthetic_golden
from cloudsc2_tpu_torch.parallel.mesh import column_mesh, gather_columns, shard_state
from cloudsc2_tpu_torch.parallel.step import forward_step, full_step, make_sharded_fn
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.utils.validation import validate

#: columns a shard: one block of 128 threads of the kernels
COLS_PER_SHARD = 128


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[tuple, Dict[str, float]]:
    """Run the dry run on ``n_devices`` shards of ``device`` (cards on
    ``"cuda"``, virtual shards on ``"cpu"``); returns, by mesh shape, the
    symmetry error in f32 machine epsilons and the largest norm."""
    ncols = COLS_PER_SHARD * n_devices
    _, state_np, dt, c = synthetic_input(ncols, "single")
    tends_ref, diags_ref = synthetic_golden(ncols, "single")
    host = state_from_numpy(state_np, torch.device("cpu"), torch.float32)
    # eta before sharding, from the global column 0
    host["eta"] = eta_levels(host["ap"], host["aph"])

    factorings = [1]
    if n_devices % 2 == 0 and n_devices > 1:
        factorings.insert(0, 2)
    readings = {}
    for n_nodes in factorings:
        mesh = column_mesh(n_devices, n_nodes=n_nodes, device=device)
        if mesh.shape != (n_nodes, n_devices // n_nodes):
            raise AssertionError(f"mesh shape {mesh.shape}, want {(n_nodes, n_devices // n_nodes)}")
        state = shard_state(host, mesh)
        ap = state["ap"]
        if len(ap.shards) != n_devices or [s.device for s in ap.shards] != list(mesh.devices):
            raise AssertionError(f"the inputs are not on every shard: {[s.device for s in ap.shards]}")

        # golden NL under sharding
        tends, diags = make_sharded_fn(forward_step, mesh, state, dt=dt, c=c)(state)
        tends_np = {k: gather_columns(v).cpu().numpy() for k, v in tends.items() if k in tends_ref}
        diags_np = {k: gather_columns(v).cpu().numpy() for k, v in diags.items() if k in diags_ref}
        failing = validate(tends_np, tends_ref, atol=1e-8, rtol=2e-3, verbose=False)
        failing += validate(diags_np, diags_ref, atol=1e-8, rtol=2e-3, verbose=False)
        if failing:
            raise AssertionError(f"golden NL validation failed under sharding {mesh.shape}: {failing}")

        # the full NL + TL + AD step with the symmetry gate
        _, norm1, norm2 = make_sharded_fn(full_step, mesh, state, dt=dt, c=c)(state)
        n1 = gather_columns(norm1).cpu().numpy().astype(np.float64)
        n2 = gather_columns(norm2).cpu().numpy().astype(np.float64)
        if n1.shape != (ncols,) or not (np.isfinite(n1).all() and np.isfinite(n2).all()):
            raise AssertionError(f"norms of shape {n1.shape}, finite {np.isfinite(n1).all()}")
        if not np.abs(n1).max() > 0:
            raise AssertionError("dead TL/AD pipeline: all norms zero")
        eps = float(np.finfo(np.float32).eps)
        err = float((np.abs(n1 - n2) / (eps * np.maximum(np.abs(n2), 1e-30))).max())
        if not err < 1e4:
            raise AssertionError(f"symmetry gate violated under sharding {mesh.shape}: {err:.1f} eps")
        readings[mesh.shape] = {"symmetry_eps": err, "norm1_max": float(np.abs(n1).max())}
        print(f"[dryrun] mesh {dict(zip(mesh.axis_names, mesh.shape))} on {device}: {ncols} x "
              f"{host['ap'].shape[0]}, golden NL at atol 1e-8 rtol 2e-3, symmetry {err:.4f} eps")
    return readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The port's multi-device dry run.")
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    dryrun_multichip(a.n_devices, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
