#!/usr/bin/env python3
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Read bandwidth of the card through the port's reader probe: the
counterpart of ``benchmarks/microbench_hbm.py``.

S float32 streams of 137 levels are summed per column by the reader kernel
(``cloudsc2_tpu_torch.kernels.microbench.reader``, the physics kernels'
access pattern: one thread per column, the levels in a loop, S loads a
level), in the ``global`` layout (each stream ``(137, ncols)``, the port's)
and the ``tile`` layout (``(nj, 137, 4096)``).  Timing is the JAX script's
chain difference: 32 against 4 back-to-back launches, median of 5, each run
timed with CUDA events (behind a sleep kernel, so the device runs the
launches back to back).  One JSON line per size and layout, with the JAX
script's keys (``ncols``, ``tile``, ``streams``, ``step_bytes_gb``,
``per_step_ms``, ``read_gb_per_s``), and beside them the share of the card's
published 3.35 TB/s, the reader's byte bound, ``library_ms`` (one
``torch.sum`` over the same streams held as one tensor, the same bytes
read), whether the streams fit in the 50 MB L2 (``l2_resident``: then the
line measures L2, not HBM), and the card's name and power limit.

On ``--device cpu`` the plain version runs and the times are host-clock
times of PyTorch's CPU kernels, which say nothing of a device.

Usage:  python drivers/microbench_hbm_torch.py [lg2_ncols ...] [--streams S] [--layout global|tile|both]
        [--device cuda|cpu]      (default 12 16, 10 streams, both layouts, cuda)
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import torch  # noqa: E402

from cloudsc2_tpu_torch.kernels import microbench as mb  # noqa: E402
from cloudsc2_tpu_torch.utils.card import HBM_BYTES_PER_S, L2_BYTES, card_label, run_ms  # noqa: E402

NLEV = 137
LONG, SHORT = 32, 4
REPEATS = 5


def chain_difference_ms(fn, device: torch.device) -> float:
    """Milliseconds per call of ``fn``: the median over REPEATS of the time
    of LONG calls less that of SHORT calls, over LONG - SHORT."""
    run_ms(fn, SHORT, device)
    run_ms(fn, LONG, device)
    per = []
    for _ in range(REPEATS):
        ts = run_ms(fn, SHORT, device)
        tl = run_ms(fn, LONG, device)
        per.append((tl - ts) / (LONG - SHORT))
    return statistics.median(per)


def run(ncols: int, layout: str, streams: int, device: torch.device, card: str) -> Dict[str, object]:
    """One line: the reader over ``streams`` seeded streams of ``ncols``
    columns in ``layout``, timed, with ``torch.sum`` beside it."""
    shape = mb.reader_shape(layout, NLEV, ncols)
    gen = torch.Generator(device=device).manual_seed(0)
    big = torch.rand((streams, *shape), generator=gen, dtype=torch.float32, device=device)
    parts = list(big.unbind(0))
    seq = [0]

    def step():
        # a new seq each launch, as the JAX loop passes its index
        seq[0] += 1
        return mb.reader(parts, float(seq[0]), layout, ncols)

    dims = (0, 1) if layout == "global" else (0, 2)
    per_ms = chain_difference_ms(step, device)
    library_ms = chain_difference_ms(lambda: torch.sum(big, dim=dims), device)
    gbytes = streams * NLEV * ncols * 4 / 1e9
    del big, parts
    return {
        "ncols": ncols, "tile": layout == "tile", "streams": streams,
        "step_bytes_gb": gbytes, "per_step_ms": per_ms, "read_gb_per_s": gbytes / per_ms * 1e3,
        "peak_share": gbytes / per_ms * 1e3 / (HBM_BYTES_PER_S / 1e9),
        "bound_ms": mb.reader_bytes(streams, NLEV, ncols) / HBM_BYTES_PER_S * 1e3,
        "library_ms": library_ms, "library_gb_per_s": gbytes / library_ms * 1e3,
        "l2_resident": streams * 4 * NLEV * ncols < L2_BYTES,
        "layout": layout, "device": device.type, "card": card,
    }


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lg2_ncols", nargs="*", type=int, default=[12, 16],
                    help="log2 of the column counts (default 12 16)")
    ap.add_argument("--streams", type=int, default=10,
                    help=f"streams read per column (1 to {mb.MAX_STREAMS}; default 10, the JAX script's)")
    ap.add_argument("--layout", choices=("global", "tile", "both"), default="both")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("microbench_hbm_torch: --device cuda needs an NVIDIA GPU "
                         "(torch.cuda.is_available() is False); --device cpu runs the plain version")
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    card = card_label(device)
    layouts = mb.LAYOUTS if args.layout == "both" else (args.layout,)
    lines = []
    for lg in args.lg2_ncols:
        for layout in layouts:
            line = run(1 << lg, layout, args.streams, device, card)
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
