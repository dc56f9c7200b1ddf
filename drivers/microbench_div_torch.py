#!/usr/bin/env python3
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Divide strategies on the card through the port's chain probe: the
counterpart of ``benchmarks/microbench_div.py``.

Each variant of ``x -> 1.25 / (x + 1)`` (``div``: one IEEE division;
``rcp``: the correctly rounded reciprocal and a product; ``rcpx``: the
approximate reciprocal, ``rcp.approx.ftz.f32``; ``rcpx1`` / ``rcpx2``: it and
one / two Newton steps) is applied in registers by the chain kernel
(``cloudsc2_tpu_torch.kernels.microbench.chain``), which goes through the
divide policies of the physics kernels (``csrc/scalar_math.h``).  At the
JAX script's shape (137 x 65,536, REPS = 64 launches a run, chains of
LONG = 96 and SHORT = 16 steps) it prints, as the JAX script does:

* each variant's ``chain_rel_err``: REPS launches of one step on a wide
  operand range (half of the columns in [1e-6, 1], half in [1, 1e6])
  against the same chain in float64 numpy (the chain settles every operand
  at the map's fixed point, so this reads about one operand), and beside it
  ``step_ulp_err``: one launch of one step over the whole wide range
  against the float64 map, in ulps, with its bound ``step_ulp_bound``;
* each variant's ``ns_per_elem`` (the chain difference: the LONG run less
  the SHORT run, over LONG - SHORT steps and REPS launches, per element,
  median of 3), ``vs_div``, ``t_short_ms`` and ``t_long_ms``; each run
  timed with CUDA events behind a sleep kernel.

Beside them each line carries its launch time and its bound (the larger of
the launch's bytes at 3.35 TB/s and its operations at 67 TFLOP/s; the
latter is loose for the reciprocals, which issue on the special-function
unit), and the card's name and power limit.  Then, as a reading, the same
chain difference with one warp on each of 132 SMs (132 x 32 elements, 32
threads a block): there the latency of the dependent chain shows rather
than throughput, in ``ns_per_step``.  Every launch of that reading records
the SM of each block, and its lines say whether each launch put one block
on each of 132 SMs (``one_warp_per_sm``).

On ``--device cpu`` the plain version runs, with the approximate reciprocal
of Pallas interpret mode (``1/bf16(x)``), and the times are host-clock times
of PyTorch's CPU kernels, which say nothing of a device.

Usage:  python drivers/microbench_div_torch.py [--device cuda|cpu] [--rows R --cols C --reps N]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cloudsc2_tpu_torch.kernels import microbench as mb  # noqa: E402
from cloudsc2_tpu_torch.utils.card import HBM_BYTES_PER_S, PEAK_F32_FLOPS, card_label, run_ms  # noqa: E402

ROWS, COLS = 137, 65536
LONG, SHORT = 96, 16
REPS = 64
SAMPLES = 3
#: the latency reading: one warp of 32 threads on each of the H100's 132 SMs
LATENCY_SHAPE = (132, 32)


def launch_bound_ms(variant: str, nelem: int, n: int) -> tuple:
    """``(bound ms, bound_by)`` of one launch of ``n`` steps on ``nelem``
    elements: each element read and written once at the HBM rate, against
    the variant's operations at the float32 peak."""
    t_bytes = 8 * nelem / HBM_BYTES_PER_S * 1e3
    t_ops = mb.CHAIN_OPS[variant] * n * nelem / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: a bound on one step's error against the float64 map of its float32
#: operand, in ulps of the float32 result: the sum of the step's own
#: operations' bounds.  ``x + 1`` is rounded once (a relative error below
#: 2**-24: under 1 ulp of the result); then ``div`` divides once (0.5 ulp);
#: ``rcp`` rounds 1/b (under 1) and the product by 1.25 (0.5);
#: ``rcpx``'s hardware reciprocal is within 1 ulp of 1/b (the PTX bound:
#: under 2 of the result); ``rcpx1`` / ``rcpx2`` end within 2 ulps of 1/b
#: (the Newton step's own roundings, ``chip_smoke.py``'s ``rcp_checks``).
#: On the card only: the plain versions' ``1/bf16(x)`` is far coarser.
STEP_ULP_BOUND = {"div": 1.5, "rcp": 2.5, "rcpx": 3.5, "rcpx1": 5.5, "rcpx2": 5.5}


def wide_operands(rows: int, cols: int, seed: int = 0) -> np.ndarray:
    """``(rows, cols)`` float32 operands over the JAX script's wide range:
    in each row half of the columns in [1e-6, 1], half in [1, 1e6]."""
    rng = np.random.default_rng(seed)
    half = cols // 2
    return np.concatenate([rng.uniform(1e-6, 1.0, (rows, half)),
                           rng.uniform(1.0, 1e6, (rows, cols - half))], axis=1).astype(np.float32)


def step_ulps(x: torch.Tensor, y: torch.Tensor) -> float:
    """The largest error of ``y``, one chain step of ``x`` in float32,
    against the float64 map ``1.25 / (x + 1)`` of the same operands, in
    ulps of the float32 result."""
    ref = 1.25 / (x.double() + 1.0)
    want = ref.float()
    ulp = (torch.nextafter(want, torch.full_like(want, float("inf"))) - want).double()
    return float(((y.double() - ref).abs() / ulp).max())


def chain_run(x: torch.Tensor, variant: str, n: int, reps: int, block: int, sm=None) -> torch.Tensor:
    """``reps`` launches of ``n`` steps, each on the last one's output; with
    ``sm`` (a CUDA int32 tensor of ``reps`` rows), launch ``r`` records the
    SM of each block in row ``r``."""
    for r in range(reps):
        x = mb.chain(x, variant, n, block) if sm is None else mb.chain_cuda(x, variant, n, block, sm[r])
    return x


def accuracy(device: torch.device, rows: int, cols: int, reps: int) -> Dict[str, Dict[str, float]]:
    """Each variant's ``chain_rel_err``: the largest relative error after
    ``reps`` one-step launches against the float64 chain (row 0, as the JAX
    script reads it); and its ``step_ulp_err``: one launch of one step over
    the whole wide operand range against the float64 map, in ulps
    (:func:`step_ulps`).  The chain settles every operand at the map's
    fixed point within a few dozen steps, so only the one-step reading
    tells the variants' errors apart."""
    rng = np.random.default_rng(0)
    row = np.concatenate([rng.uniform(1e-6, 1.0, cols // 2), rng.uniform(1.0, 1e6, cols - cols // 2)])
    xs = torch.from_numpy(row.astype(np.float32).reshape(1, cols).repeat(rows, 0)).to(device)
    ref = row.astype(np.float32).astype(np.float64)
    for _ in range(reps):
        ref = 1.25 / (ref + 1.0)
    wide = torch.from_numpy(wide_operands(rows, cols)).to(device)
    out = {}
    for name in mb.VARIANTS:
        got = chain_run(xs, name, 1, reps, 128)[0].cpu().numpy().astype(np.float64)
        out[name] = {"chain_rel_err": float((np.abs(got - ref) / np.abs(ref)).max()),
                     "step_ulp_err": step_ulps(wide, mb.chain(wide, name, 1))}
    return out


def timing(device: torch.device, shape, reps: int, block: int, record_sm: bool = False):
    """Per variant ``(per-step ms of one launch, t_short ms, t_long ms,
    SMs)``: the chain difference, median of SAMPLES.  With ``record_sm``
    (CUDA only), SMs is ``(the fewest distinct SMs a launch ran on, the
    most blocks one SM ran in a launch)`` over every timed launch, else
    None."""
    x0 = torch.full(shape, 1.2345, dtype=torch.float32, device=device)
    nblocks = -(-x0.numel() // block)
    sm = torch.full((reps, nblocks), -1, dtype=torch.int32, device=device) if record_sm else None
    out = {}
    for name in mb.VARIANTS:
        placed = []

        def run(n, name=name):
            ms = run_ms(lambda: chain_run(x0, name, n, reps, block, sm), 1, device)
            if sm is not None:
                placed.extend(np.unique(row, return_counts=True) for row in sm.cpu().numpy())
            return ms

        run(SHORT)
        run(LONG)
        per = []
        for _ in range(SAMPLES):
            ts, tl = run(SHORT), run(LONG)
            per.append((tl - ts) / (LONG - SHORT) / reps)
        sms = (min(len(ids) for ids, _ in placed), max(int(n.max()) for _, n in placed)) if placed else None
        out[name] = (statistics.median(per), ts, tl, sms)
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=COLS)
    ap.add_argument("--reps", type=int, default=REPS, help="launches a run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("microbench_div_torch: --device cuda needs an NVIDIA GPU "
                         "(torch.cuda.is_available() is False); --device cpu runs the plain version")
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    card = card_label(device)
    lines: List[Dict[str, object]] = []

    def emit(line):
        line = {**line, "device": device.type, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)

    for name, err in accuracy(device, args.rows, args.cols, args.reps).items():
        bound = {"step_ulp_bound": STEP_ULP_BOUND[name]} if device.type == "cuda" else {}
        emit({"variant": name, **err, **bound})
    nelem = args.rows * args.cols
    times = timing(device, (args.rows, args.cols), args.reps, 128)
    base = times["div"][0]
    for name, (per, ts, tl, _) in times.items():
        bound_ms, bound_by = launch_bound_ms(name, nelem, LONG)
        emit({"variant": name, "ns_per_elem": per / nelem * 1e6, "vs_div": per / base,
              "t_short_ms": ts, "t_long_ms": tl, "launch_ms": tl / args.reps, "steps": LONG,
              "elements": nelem, "bound_ms": bound_ms, "bound_by": bound_by})
    rows, cols = LATENCY_SHAPE
    for name, (per, ts, tl, sms) in timing(device, LATENCY_SHAPE, args.reps, cols, device.type == "cuda").items():
        placement = {} if sms is None else {"fewest_sms": sms[0], "most_blocks_per_sm": sms[1],
                                            "one_warp_per_sm": sms == (rows, 1)}
        emit({"variant": name, "reading": "latency, one warp per SM", "elements": rows * cols,
              "block": cols, "ns_per_step": per * 1e6, "t_short_ms": ts, "t_long_ms": tl, **placement})
    return lines


if __name__ == "__main__":
    main()
