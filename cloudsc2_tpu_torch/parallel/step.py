# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Step functions: the NL hot-loop step and the full NL + TL + AD pipeline,
and their column-sharded forms; the port of :mod:`cloudsc2_tpu.parallel.step`
(``forward_step:61``, ``full_step:111``, ``make_sharded_fn:147``,
``make_sharded_physics:160``, ``make_sharded_forward_step:211``).

The framework's "training step" analogue is the complete symmetry-test
pipeline (reference ``physics/adjoint/validation.py:132-165``): saturation
-> state increment -> tangent-linear -> adjoint -> the two per-column
norms.  Both functions call :mod:`cloudsc2_tpu_torch.dispatch` directly,
not the component layer, whose every call ends in a device sync: on CUDA
tensors they enqueue the kernels on PyTorch's current stream and return
without waiting, so a caller can overlap them with copies
(:func:`cloudsc2_tpu_torch.parallel.stream.stream_columns`).

The sharded forms run a step on every local shard of a
:class:`~cloudsc2_tpu_torch.parallel.mesh.ColumnMesh`, each on its own
device, enqueued one after the other without a sync: the counterpart of
JAX's ``shard_map`` over the mesh.  No data crosses shards: columns are
independent.  The one global quantity is eta, defined from the global
column 0 (reference ``common/diagnostics.py:28-45``); a shard-local eta is
wrong wherever ``ap / aph_s`` varies by column, so each wrapper derives
eta before it splits the state when the state lacks it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from cloudsc2_tpu_torch import dispatch
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.parallel.mesh import ColumnMesh, ShardedTensor, gather_columns, shard_state, state_shardings
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.validation.symmetry import DIAG_NAMES, TEND_NAMES, SymmetryTest

Tensor = torch.Tensor


def forward_step(
    state: Dict[str, Tensor], dt: float, c: Constants, fuse_saturation: bool = True
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Saturation + nonlinear scheme (the reference hot loop,
    ``drivers/run_nonlinear.py:115-119``); ``diags["qsat"]`` carries the
    saturation.

    With ``fuse_saturation`` (the default) one NL step diagnoses ``qsat``
    itself, a single kernel launch on CUDA tensors; it is bitwise
    ``Saturation`` followed by the unfused step, which ``fuse_saturation=
    False`` runs.  ``kflag`` is 1 and ``c.LPHYLIN`` picks the branch, as in
    the JAX step; ``c.FAST_DIV`` is the kernel's divide mode.

    A caller-provided ``state["eta"]`` is used as-is; eta is derived here
    only when missing.  It is defined from column 0 of the whole state
    (reference ``common/diagnostics.py:28-45``), so a caller that hands in
    a subset of the columns passes it in, as the stream does.
    """
    s = dict(state)
    if "eta" not in s:
        s["eta"] = eta_levels(s["ap"], s["aph"])
    if fuse_saturation:
        s.pop("qsat", None)
        return dispatch.cloudsc2_nl(s, dt, c, fuse_saturation=True, kflag=1)
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    tends, diags = dispatch.cloudsc2_nl(s, dt, c)
    diags["qsat"] = s["qsat"]
    return tends, diags


def full_step(
    state: Dict[str, Tensor], dt: float, c: Constants, factor: float = 0.01
) -> Tuple[Dict[str, Tensor], Tensor, Tensor]:
    """The complete NL + TL + AD pipeline with symmetry norms.

    Returns ``(nl_tendencies, norm1, norm2)``, the norms the per-column
    ``<Mx, Mx>`` and ``<x, M*(Mx)>`` of the symmetry test
    (:meth:`SymmetryTest.get_norm1` / ``get_norm2``), on the state's device.
    The TL computes the forward trajectory beside the directional
    derivative and returns the forward tendencies, so they are the NL
    tendencies: no NL step runs apart (the reference's symmetry protocol
    does the same, ``adjoint/validation.py:132-151``).
    """
    s = dict(state)
    if "eta" not in s:
        s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)

    incr = state_increment(s, factor, ignore_supsat=True)
    s.update(incr)
    tends_tl, diags_tl = dispatch.cloudsc2_tl(s, dt, c)
    tends_nl = {n: tends_tl[n] for n in TEND_NAMES}
    norm1 = SymmetryTest.get_norm1(tends_tl, diags_tl)

    for name in TEND_NAMES:
        s["tnd_" + name] = tends_tl[name]
        s["tnd_" + name + "_i"] = tends_tl[name + "_i"]
    for name in DIAG_NAMES:
        s[name + "_i"] = diags_tl[name + "_i"]
    tends_ad, diags_ad = dispatch.cloudsc2_ad(s, dt, c)
    norm2 = SymmetryTest.get_norm2(incr, tends_ad, diags_ad)
    return tends_nl, norm1, norm2


def _with_global_eta(state: Dict[str, Any]) -> Dict[str, Any]:
    """``state`` with eta from the global column 0, derived where missing:
    from the whole fields, or from the shard that holds column 0."""
    if "eta" in state or "ap" not in state:
        return state
    state = dict(state)
    ap, aph = state["ap"], state["aph"]
    if not isinstance(ap, ShardedTensor):
        state["eta"] = eta_levels(ap, aph)
        return state
    if ap.mesh.first_shard != 0:
        raise ValueError("eta is defined from the global column 0, which another process holds: "
                         "derive it before sharding")
    eta = eta_levels(ap.shards[0], aph.shards[0])
    state["eta"] = ShardedTensor(ap.mesh, tuple(eta.shape), tuple(eta.to(d) for d in ap.mesh.devices), False)
    return state


def _stack(outs: list, mesh: ColumnMesh) -> Any:
    """The local shards' outputs (one tree a shard) as one tree of
    ShardedTensors: every output is column-sharded along its last axis
    (``full_step``'s ``(ncols,)`` norms too)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs], mesh) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([o[i] for o in outs], mesh) for i in range(len(first)))
    return ShardedTensor(mesh, (*first.shape[:-1], first.shape[-1] * mesh.size), tuple(outs), True)


def _run_sharded(fn: Callable[[Dict[str, Tensor]], Any], state: Dict[str, Any], mesh: ColumnMesh) -> Any:
    """``fn`` on each local shard of ``state`` (eta global), enqueued in
    shard order; the outputs as ShardedTensors."""
    sharded = shard_state(_with_global_eta(state), mesh)
    return _stack([fn({k: v.shards[d] for k, v in sharded.items()}) for d in range(len(mesh.devices))], mesh)


def make_sharded_fn(fn, mesh: ColumnMesh, state: Dict[str, Any], *, dt: float, c: Constants):
    """``fn(state, dt=dt, c=c)`` on every local shard of ``mesh``, the
    outputs column-sharded ShardedTensors.

    ``state`` fixes which fields are column-sharded
    (:func:`~cloudsc2_tpu_torch.parallel.mesh.state_shardings`, JAX's
    ``in_shardings``): a call with other fields or ranks raises.  A call
    takes the state whole or sharded.
    """
    spec = state_shardings(state)

    def step(s: Dict[str, Any]) -> Any:
        if state_shardings(s) != spec:
            raise ValueError(f"the state's fields {state_shardings(s)} are not the step's {spec}")
        return _run_sharded(lambda local: fn(local, dt=dt, c=c), s, mesh)

    return step


def make_sharded_physics(fn, mesh: ColumnMesh):
    """Wrap a physics scheme ``fn(state, dt, c) -> (dict, dict)`` to run
    column-sharded on ``mesh``: the generic sibling of
    :func:`make_sharded_forward_step` that the Taylor and symmetry
    protocols use (driver ``--sharded``).  2-D fields are column-sharded,
    1-D fields (eta) replicated, and each shard runs the scheme on its
    columns (the CUDA kernels on a card, the plain versions on the CPU).
    The outputs come back gathered in column order on the state's device,
    so the protocols' reductions run unchanged; that needs every shard in
    this process (a single-process mesh, as JAX's single-host meshes).
    """
    if mesh.process_count > 1:
        raise ValueError("make_sharded_physics gathers every shard: it needs a single-process mesh")

    def step(state: Dict[str, Any], dt: float, c: Constants):
        ap = state["ap"]
        device = ap.shards[0].device if isinstance(ap, ShardedTensor) else ap.device
        outs = _run_sharded(lambda local: fn(local, dt, c), state, mesh)
        return tuple({k: gather_columns(v, device) for k, v in d.items()} for d in outs)

    return step


def make_sharded_forward_step(mesh: ColumnMesh, *, dt: float, c: Constants, fuse_saturation: bool = True):
    """The column-sharded :func:`forward_step`: on every local shard, on its
    device (one NL launch a shard on CUDA), no sync and no communication.
    Returns ``call(state)`` for a state whole or already sharded (shard it
    once, outside a hot loop), which gives ``(tendencies, diagnostics)``
    as dicts of column-sharded ShardedTensors.  eta is derived once from
    the global column 0 where the state lacks it.
    """

    def call(state: Dict[str, Any]):
        return _run_sharded(lambda local: forward_step(local, dt, c, fuse_saturation), state, mesh)

    return call
