#!/usr/bin/env python3
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Compare the outputs of every kernel form of this checkout with those of
another checkout, bitwise, in one process on one card.

At 65,536 x 137 (by default), f32 and f64, on the seeded synthetic state:
the NL kernel unfused, fused, with its trajectory, ``traj_only``, fused
under ``CUADJ_COMPACT=False`` and with ``LEVAPLS2`` (and in f32 fused under
the faithful and approx divides); the TL kernel in the default switches,
``tangent_only``, with ``LEVAPLS2`` and under ``CUADJ_COMPACT=False`` (f32:
faithful, approx); the two-kernel AD likewise, ``cotangent_only`` for
``tangent_only``; the fused AD rolled, resident and with ``LEVAPLS2``.
The checkout at ``--tree`` runs first: its ``cloudsc2_tpu_torch`` makes
the states (the AD's seeds from its TL kernel) and runs each form, its
outputs kept on the card; then this checkout's package is imported in its
place and runs each form on the same tensors.  Each form prints one JSON
line: its outputs, whether every one is bitwise the other checkout's, and
how many elements differ in those that are not; the last line says whether
all were.  Exit status 1 where any output differs.  For a change that must
leave the kernels' numbers as they were::

    python3 drivers/outputs_ab_torch.py --tree PARENT

Needs an NVIDIA GPU and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_ab_torch import _card_module, seed_ad  # noqa: E402

PACKAGE = "cloudsc2_tpu_torch"
MODULES = {"nlk": "kernels.nonlinear", "tlk": "kernels.tangent_linear", "adk": "kernels.adjoint",
           "params": "params", "diag": "physics.diagnostics", "incr": "physics.increment",
           "sat": "physics.saturation", "state": "state"}


def import_port(tree: Path):
    """The port's modules of ``MODULES`` from ``tree``, any copy already
    imported dropped first."""
    for name in [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree))
    try:
        mods = {k: importlib.import_module(f"{PACKAGE}.{m}") for k, m in MODULES.items()}
    finally:
        sys.path.remove(str(tree))
    assert Path(mods["nlk"].__file__).resolve().is_relative_to(tree.resolve()), mods["nlk"].__file__
    return mods


def build(mods) -> float:
    """Build and load every library the forms launch; the seconds it took."""
    nlk, tlk, adk = mods["nlk"], mods["tlk"], mods["adk"]
    loads = [nlk.load_cuda, lambda: nlk.load_cuda(False)]
    for load in (tlk.load_cuda, adk.load_cuda, adk.load_fused_cuda):
        loads += [lambda f=load: f(True, False), lambda f=load: f(True, True), lambda f=load: f(False, False)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loads)) as pool:
        for f in [pool.submit(load) for load in loads]:
            f.result()
    return time.perf_counter() - t0


def flat(out):
    """A wrapper's outputs (a dict or a tuple of dicts) as one dict."""
    found = {}
    for i, d in enumerate(out if isinstance(out, tuple) else (out,)):
        found.update({f"{i}.{k}": v for k, v in d.items()})
    return found


def forms(mods, c, dtype, torch):
    """``{name: call(states) -> outputs}`` of every form at ``dtype``."""
    nlk, tlk, adk = mods["nlk"], mods["tlk"], mods["adk"]
    variants = {"": c, " levapls2": c.replace(LEVAPLS2=True), " ref": c.replace(CUADJ_COMPACT=False)}
    if dtype == torch.float32:
        variants.update({f" {m}": c.replace(FAST_DIV=m) for m in ("faithful", "approx")})
    out = {
        "nl": lambda st: nlk.cloudsc2_nl_cuda(st["nl"], st["dt"], c),
        "nl trajectory": lambda st: nlk.cloudsc2_nl_cuda(st["nl"], st["dt"], c, with_trajectory=True),
        "nl traj_only": lambda st: nlk.cloudsc2_nl_cuda(st["nl"], st["dt"], c, with_trajectory=True,
                                                        traj_only=True),
        "tl tangent_only": lambda st: tlk.cloudsc2_tl_cuda(st["tl"], st["dt"], c, tangent_only=True),
        "ad cotangent_only": lambda st: adk.cloudsc2_ad_cuda(st["ad"], st["dt"], c, cotangent_only=True),
        "ad fused": lambda st: adk.cloudsc2_ad_fused_cuda(st["ad"], st["dt"], c),
        "ad fused resident": lambda st: adk.cloudsc2_ad_fused_cuda(st["ad"], st["dt"], c, resident=True),
        "ad fused levapls2": lambda st: adk.cloudsc2_ad_fused_cuda(st["ad"], st["dt"], variants[" levapls2"]),
    }
    for tag, cf in variants.items():
        out["nl fused" + tag] = lambda st, cf=cf: nlk.cloudsc2_nl_cuda(st["nl"], st["dt"], cf, fuse_saturation=True)
        out["tl" + tag] = lambda st, cf=cf: tlk.cloudsc2_tl_cuda(st["tl"], st["dt"], cf)
        out["ad" + tag] = lambda st, cf=cf: adk.cloudsc2_ad_cuda(st["ad"], st["dt"], cf)
    return out


def states(mods, c, ncols, dtype, device):
    """The NL, TL and AD states of one seed, made by ``mods``."""
    _, s, dt = mods["state"].synthesize_state(ncols, 137, 2, device, dtype)
    s["eta"] = mods["diag"].eta_levels(s["ap"], s["aph"])
    s["qsat"] = mods["sat"].saturation(s["ap"], s["t"], c=c)
    tl = {**s, **mods["incr"].state_increment(s, 0.01, ignore_supsat=True)}
    return {"nl": s, "tl": tl, "ad": seed_ad(mods["tlk"], tl, dt, c), "dt": dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="the checkout whose outputs this one's are compared with")
    ap.add_argument("--num-cols", type=int, default=65536)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("outputs_ab_torch: needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    device = torch.device("cuda:0")
    card = _card_module().card_label(device)

    def bits(t):
        return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)

    trees = {"other": Path(args.tree), "this": HERE}
    ok, count = True, 0
    for dtype in (torch.float32, torch.float64):
        kept, st = {}, None
        for side in ("other", "this"):
            mods = import_port(trees[side])
            took = build(mods)
            print(f"[outputs-ab] {side} {trees[side]}: built and loaded in {took:.1f} s; {card}", flush=True)
            c = mods["params"].make_constants(lphylin=True, ldrain1d=False)
            st = st or states(mods, c, args.num_cols, dtype, device)
            for name, call in forms(mods, c, dtype, torch).items():
                outs = flat(call(st))
                if side == "other":
                    kept[name] = outs
                    continue
                want = kept.pop(name)
                differ = {k: int((bits(v) != bits(want[k])).sum()) for k, v in outs.items()
                          if k in want and not torch.equal(bits(v), bits(want[k]))}
                same = outs.keys() == want.keys() and not differ
                ok, count = ok and same, count + 1
                print(json.dumps({"form": name, "dtype": str(dtype)[6:], "ncols": args.num_cols,
                                  "outputs": len(outs), "bitwise": same, "differing": differ,
                                  "names_equal": outs.keys() == want.keys()}), flush=True)
            torch.cuda.synchronize()
        del kept, st
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "forms": count, "tree": args.tree, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
