#!/usr/bin/env python3
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Time the default forms of the port's kernels in one checkout, for an A/B
of two checkouts on one card.

Times, with CUDA events over batches of back-to-back calls, the NL kernel
(unfused), the TL kernel and the AD's forward (the NL kernel with its
trajectory) and reverse kernels at 65,536 x 137 (by default), f32 and f64,
default switches and the exact divide, on the seeded synthetic state, the
AD's seeds from the TL kernel.  It imports ``cloudsc2_tpu_torch`` from
``--tree`` (by default this checkout), so one copy of the script times any
checkout whose kernels have these entry points.  Compare two checkouts only
inside one call on one card, in turns::

    for t in PARENT . . PARENT; do python3 drivers/kernel_ab_torch.py --tree $t; done

Needs an NVIDIA GPU and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import statistics
import sys
import time
from pathlib import Path


def _card_module():
    """``cloudsc2_tpu_torch/utils/card.py`` of this script's own checkout,
    loaded from its file, so that the package under test still comes from
    ``--tree`` (which may predate the module)."""
    path = Path(__file__).resolve().parents[1] / "cloudsc2_tpu_torch" / "utils" / "card.py"
    spec = importlib.util.spec_from_file_location("_kernel_ab_card", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose cloudsc2_tpu_torch is timed")
    ap.add_argument("--num-cols", type=int, default=65536)
    ap.add_argument("--runs", type=int, default=10, help="batches per kernel (the median is reported)")
    ap.add_argument("--batch", type=int, default=10, help="back-to-back calls per batch")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab_torch: needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cloudsc2_tpu_torch.kernels import adjoint as adk
    from cloudsc2_tpu_torch.kernels import nonlinear as nlk
    from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
    from cloudsc2_tpu_torch.params import make_constants
    from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
    from cloudsc2_tpu_torch.physics.increment import state_increment
    from cloudsc2_tpu_torch.physics.saturation import saturation
    from cloudsc2_tpu_torch.state import synthesize_state

    cardmod = _card_module()
    device = torch.device("cuda:0")
    card = cardmod.card_label(device)
    label = f"[kernel-ab {args.tree}]"
    c = make_constants(lphylin=True, ldrain1d=False)
    t0 = time.perf_counter()
    nlk.load_cuda()
    tlk.load_cuda()
    adk.load_cuda()
    print(f"{label} built and loaded in {time.perf_counter() - t0:.1f} s; {card}", flush=True)

    def ms(fn):
        for _ in range(3):
            fn()
        runs = [cardmod.run_ms(fn, args.batch, device, hold=False) / args.batch for _ in range(args.runs)]
        return statistics.median(runs), runs

    for dtype in (torch.float32, torch.float64):
        _, s, dt = synthesize_state(args.num_cols, 137, 2, device, dtype)
        s["eta"] = eta_levels(s["ap"], s["aph"])
        s["qsat"] = saturation(s["ap"], s["t"], c=c)
        s.update(state_increment(s, 0.01, ignore_supsat=True))
        tends, diags = tlk.cloudsc2_tl_cuda(s, dt, c)
        for n in ("t", "q", "ql", "qi"):
            s["tnd_" + n] = tends[n]
            s["tnd_" + n + "_i"] = tends[n + "_i"]
        for n in ("clc", "covptot", "fhpsl", "fhpsn", "fplsl", "fplsn"):
            s[n + "_i"] = diags[n + "_i"]
        traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)[2]
        res = {
            "nl": ms(lambda: nlk.cloudsc2_nl_cuda(s, dt, c)),
            "tl": ms(lambda: tlk.cloudsc2_tl_cuda(s, dt, c)),
            "ad forward": ms(lambda: nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)),
            "ad reverse": ms(lambda: adk.cloudsc2_ad_reverse_cuda(s, traj, dt, c)),
        }
        print(f"{label} {str(dtype)[6:]} {args.num_cols}x137: "
              + "; ".join(f"{k} {v[0]:.4f} ms (runs {[round(x, 4) for x in v[1]]})" for k, v in res.items())
              + f"; {card}", flush=True)
        del s, traj
    return 0


if __name__ == "__main__":
    sys.exit(main())
