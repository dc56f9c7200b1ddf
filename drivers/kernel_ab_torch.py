#!/usr/bin/env python3
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Time the default forms of the port's kernels in one checkout, for an A/B
of two checkouts on one card.

Times, with CUDA events over batches of back-to-back calls, at 65,536 x 137
(by default), f32 and f64, default switches, on the seeded synthetic state
(the AD's seeds from the TL kernel): the NL kernel in its forms -- unfused,
fused (saturation diagnosed in the kernel: the main path's form), with its
trajectory (the AD's forward), ``traj_only`` (the gradient-only AD's
forward), fused under ``CUADJ_COMPACT=False``, and in f32 fused under the
faithful and approx divides -- the TL kernel (also with ``LEVAPLS2``) and
the AD's reverse kernel, the exact divide unless named.  ``ad`` times the
reverse kernel in the default switches, with ``LEVAPLS2``, with
``CUADJ_COMPACT=False`` and in f32 under the faithful and approx divides,
beside the two-kernel AD (default and ``LEVAPLS2``) and the
``cotangent_only`` step, and prints for each reverse form a checksum of
its 16 outputs (their bits summed as integers, so two checkouts whose
outputs are bitwise equal print the same), the wrapper's host milliseconds
a call (read before the device is synchronized) and what the card makes of
it: ``kernels.adjoint.reverse_occupancy`` (registers, local bytes, blocks
per SM, shared bytes, ring depth), with ptxas's spills where this process
built the library.  Each NL form's registers, blocks per SM and ring depth
(``kernels.nonlinear.occupancy``) are printed beside its time, and, as a
yardstick of a rate with writes, ``torch.add(a, b, out=o)`` over the fused
NL kernel's f32 bytes; each NL form's outputs are checksummed too, and its
blocks per SM and the blocks its carveout is sized for are read at the
launch's column count.
``--kernels nl`` times the NL kernel alone (and builds only its
libraries).  ``--kernels ad_fused`` times the fused AD kernel, rolled and
resident, in the default switches and with ``LEVAPLS2``, beside the
two-kernel AD on the same state, and prints next to each time what
``kernels.adjoint.fused_occupancy`` reads from the card (block, blocks and
threads per SM, registers, local and shared bytes) and the scratch bytes
of the kernel's stack.  ``--kernels launch``
times the main path's launch path (:func:`launch_readings`): at
``--num-cols`` (65,536 by default) and 100 columns, f32 and f64, the fused
NL wrapper and the ``cotangent_only`` AD step, each its host milliseconds a call (asynchronous
calls, read before the device is synchronized), its device milliseconds a
call (CUDA events behind a sleep kernel) and the wall of one synchronized,
unprofiled step (the ``Cloudsc2NL(fuse_saturation=True)`` component; the
AD through ``dispatch.cloudsc2_ad`` and ``device_sync``); and checksums of
every NL form's and every two-kernel AD form's outputs.  The same step's
host time by stage is the port's own spans' (``portbench``'s
``wrapper_us.*``).  It imports ``cloudsc2_tpu_torch`` from ``--tree`` (by
default this checkout), so one copy of the script times any checkout whose
kernels have these entry points.  Compare two checkouts only
inside one call on one card, in turns::

    for t in PARENT . . PARENT; do python3 drivers/kernel_ab_torch.py --tree $t; done

Needs an NVIDIA GPU and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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


def host_times(torch, fn, runs, batch):
    """Host milliseconds a call of ``fn`` in each of ``runs`` batches of
    ``batch`` back-to-back calls, each read before the device is
    synchronized."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / batch)
    torch.cuda.synchronize()
    return times



def step_ms(fn, steps):
    """``(median, mean)`` wall milliseconds of one call of ``fn``, a step
    that ends in a device synchronization, over ``steps`` steps."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), statistics.fmean(times)


def checksum(torch, outs):
    """The bits of every tensor of ``outs`` (a dict of tensors, or a tuple
    of them), summed as integers tensor by tensor in the order of the
    dicts' sorted names, folded into one hex string: equal for
    bitwise-equal outputs."""
    h = 0
    for d in outs if isinstance(outs, tuple) else (outs,):
        for n in sorted(d):
            bits = d[n].contiguous().view(torch.int32).to(torch.int64).sum()
            h = (h * 1_000_003 + int(bits)) % (2**61 - 1)
    return f"{h:016x}"


def nl_forms(c):
    """The NL forms the script times: ``(constants, options of
    cloudsc2_nl_cuda)`` by name; f64 runs those of the exact divide."""
    return {
        "nl": (c, {}),
        "nl fused": (c, {"fuse_saturation": True}),
        "ad forward": (c, {"with_trajectory": True}),
        "traj_only": (c, {"with_trajectory": True, "traj_only": True}),
        "nl fused ref": (c.replace(CUADJ_COMPACT=False), {"fuse_saturation": True}),
        "nl fused faithful": (c.replace(FAST_DIV="faithful"), {"fuse_saturation": True}),
        "nl fused approx": (c.replace(FAST_DIV="approx"), {"fuse_saturation": True}),
    }


def seed_ad(tlk, s, dt, cf):
    """The state with the AD's output cotangent seeds: the TL kernel's
    outputs under the constants ``cf``."""
    s = dict(s)
    tends, diags = tlk.cloudsc2_tl_cuda(s, dt, cf)
    for n in ("t", "q", "ql", "qi"):
        s["tnd_" + n] = tends[n]
        s["tnd_" + n + "_i"] = tends[n + "_i"]
    for n in ("clc", "covptot", "fhpsl", "fhpsn", "fplsl", "fplsn"):
        s[n + "_i"] = diags[n + "_i"]
    return s


def launch_readings(torch, device, card, label, runs=10, batch=10, columns=(65536, 100)):
    """The main path's launch path, for each type and column count of
    ``columns``: the fused NL wrapper and the ``cotangent_only`` AD step,
    each its host ms a call (:func:`host_times`), device ms a call (CUDA
    events behind a sleep kernel), synchronized unprofiled step wall (median and mean,
    :func:`step_ms`; the NL step is the ``Cloudsc2NL(fuse_saturation=True)``
    component, the AD step ``dispatch.cloudsc2_ad`` then ``device_sync``),
    and checksums of the outputs of every NL form and every two-kernel AD
    form.  Prints a line each and returns the readings."""
    from cloudsc2_tpu_torch import components as comps
    from cloudsc2_tpu_torch import dispatch
    from cloudsc2_tpu_torch.kernels import adjoint as adk
    from cloudsc2_tpu_torch.kernels import nonlinear as nlk
    from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
    from cloudsc2_tpu_torch.params import make_constants
    from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
    from cloudsc2_tpu_torch.physics.increment import state_increment
    from cloudsc2_tpu_torch.physics.saturation import saturation
    from cloudsc2_tpu_torch.state import synthesize_state
    from cloudsc2_tpu_torch.utils import card as cardmod
    from cloudsc2_tpu_torch.utils import timing

    c = make_constants(lphylin=True, ldrain1d=False)
    c_lin = c.replace(LPHYLIN=False)
    forms = {
        **nl_forms(c),
        "nl ref": (c.replace(CUADJ_COMPACT=False), {}),
        "nl faithful": (c.replace(FAST_DIV="faithful"), {}),
        "nl fused kflag 2": (c_lin, {"fuse_saturation": True, "kflag": 2}),
    }
    ad_forms = {
        "ad": (c, {}),
        "cotangent_only": (c, {"cotangent_only": True}),
        "ad levapls2": (c.replace(LEVAPLS2=True), {}),
        "cotangent_only levapls2": (c.replace(LEVAPLS2=True), {"cotangent_only": True}),
        "ad ref": (c.replace(CUADJ_COMPACT=False), {}),
        "ad faithful": (c.replace(FAST_DIV="faithful"), {}),
        "ad approx": (c.replace(FAST_DIV="approx"), {}),
        "ad lphylin=False": (c_lin, {}),
    }
    readings = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        for ncols in columns:
            grid, s, dt = synthesize_state(ncols, 137, 2, device, dtype)
            s["eta"] = eta_levels(s["ap"], s["aph"])
            s["qsat"] = saturation(s["ap"], s["t"], c=c)
            s.update(state_increment(s, 0.01, ignore_supsat=True))
            sa = seed_ad(tlk, s, dt, c)
            bare = {k: v for k, v in s.items() if k != "qsat"}
            nl = comps.Cloudsc2NL(grid, c, fuse_saturation=True)
            paths = {
                "nl fused": (lambda: nlk.cloudsc2_nl_cuda(bare, dt, c, fuse_saturation=True),
                             lambda: nl(bare, dt)),
                "ad cotangent_only": (lambda: adk.cloudsc2_ad_cuda(sa, dt, c, cotangent_only=True),
                                      lambda: timing.device_sync(dispatch.cloudsc2_ad(sa, dt, c, cotangent_only=True))),
                "ad cotangent_only lphylin=False": (
                    lambda: adk.cloudsc2_ad_cuda(sa, dt, c_lin, cotangent_only=True), None),
            }
            steps = 200 if ncols <= 4096 else 50
            for path, (call, step) in paths.items():
                for _ in range(3):
                    call()
                hosts = host_times(torch, call, 3 * runs, batch)
                r = {"host_ms": statistics.median(hosts), "host_min_ms": min(hosts),
                     "device_ms": statistics.median(
                         cardmod.run_ms(call, batch, device, hold=True) / batch for _ in range(runs))}
                if step is not None:
                    r["step_ms"], r["step_mean_ms"] = step_ms(step, steps)
                    r["busy_share"] = r["device_ms"] / r["step_ms"]
                readings[f"{tag} {ncols} {path}"] = r
                print(f"{label} launch {tag} {ncols}x137 {path}: host {r['host_ms']:.4f} ms a call (least "
                      f"{r['host_min_ms']:.4f}), device "
                      f"{r['device_ms']:.4f} ms a call"
                      + (f", synchronized step {r['step_ms']:.4f} ms (mean {r['step_mean_ms']:.4f}), device busy "
                         f"{r['busy_share']:.3f} of it" if step else "")
                      + f"; {card}", flush=True)
            sums = {}
            for name, (cf, opts) in forms.items():
                if dtype == torch.float64 and cf.FAST_DIV != "exact":
                    continue
                x = bare if opts.get("fuse_saturation") else s
                sums[name] = checksum(torch, nlk.cloudsc2_nl_cuda(x, dt, cf, **opts))
            for name, (cf, opts) in ad_forms.items():
                if dtype == torch.float64 and cf.FAST_DIV != "exact":
                    continue
                x = sa if not cf.LEVAPLS2 else seed_ad(tlk, s, dt, cf)
                sums[name] = checksum(torch, adk.cloudsc2_ad_cuda(x, dt, cf, **opts))
            readings[f"{tag} {ncols} checksums"] = sums
            print(f"{label} launch {tag} {ncols}x137 outputs checksums: {sums}", flush=True)
            del s, sa, bare
            torch.cuda.empty_cache()
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose cloudsc2_tpu_torch is timed")
    ap.add_argument("--num-cols", type=int, default=65536)
    ap.add_argument("--runs", type=int, default=10, help="batches per kernel (the median is reported)")
    ap.add_argument("--batch", type=int, default=10, help="back-to-back calls per batch")
    ap.add_argument("--kernels", default="nl,tl,ad", help="comma-separated: nl, tl, ad, ad_fused, launch")
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
    kernels = set(args.kernels.split(","))
    loads = [nlk.load_cuda, lambda: nlk.load_cuda(False)]
    ad = bool(kernels & {"ad", "ad_fused", "launch"})
    loads += [tlk.load_cuda] * ("tl" in kernels or ad) + [adk.load_cuda] * ad
    loads += [lambda: adk.load_cuda(True, True), lambda: adk.load_cuda(False)] * bool(kernels & {"ad", "launch"})
    loads += [adk.load_fused_cuda] * ("ad_fused" in kernels)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loads)) as pool:
        for f in [pool.submit(load) for load in loads]:
            f.result()
    print(f"{label} built and loaded in {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    if "launch" in kernels:
        readings = launch_readings(torch, device, card, label, args.runs, args.batch, (args.num_cols, 100))
        print(json.dumps({"tree": args.tree, "launch": readings, "card": card}), flush=True)
        kernels.discard("launch")
        if not kernels:
            return 0
    nl_timed = nl_forms(c)

    def ms(fn):
        for _ in range(3):
            fn()
        runs = [cardmod.run_ms(fn, args.batch, device, hold=False) / args.batch for _ in range(args.runs)]
        return statistics.median(runs), runs

    def reverse_checksum(outs):
        """The reverse kernel's outputs' bits summed as integers, output by
        output in the order of ``AD_OUTPUTS``, folded into one hex string."""
        h = 0
        for n in adk.AD_OUTPUTS:
            h = (h * 1_000_003 + int(outs[n].contiguous().view(torch.int32).to(torch.int64).sum())) % (2**61 - 1)
        return f"{h:016x}"

    def spills(dtype, cf):
        """``(spill stores, spill loads)`` bytes ptxas reported for the
        reverse kernel's instantiation, where this process built its
        library (else None)."""
        from cloudsc2_tpu_torch.kernels.nonlinear import div_switch

        lib = "cloudsc2_ad" + adk.build.form(bool(cf.CUADJ_COMPACT), div_switch(cf, dtype) != 0)[0]
        key = (f"BodyI{'d' if dtype == torch.float64 else 'f'}Lb{int(bool(cf.LEVAPLS2 or cf.LDRAIN1D))}E"
               f"Lb{int(bool(cf.LREGCL))}ELi{div_switch(cf, dtype)}E")
        entry, found = "", None
        for line in adk.build.logs.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif key in entry:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                found = (int(m[1]), int(m[2])) if m else found
        return found

    def reverse_reading(dtype, cf):
        """What the card makes of the reverse kernel's instantiation."""
        o = dict(adk.reverse_occupancy(dtype, cf))
        o["spills"] = spills(dtype, cf)
        return o

    def fused_reading(dtype, cf, resident):
        """What the card makes of the fused kernel's instantiation, and its
        stack's scratch bytes."""
        occ = dict(adk.fused_occupancy(dtype, cf, resident, 137))
        evap = bool(cf.LEVAPLS2 or cf.LDRAIN1D)
        occ["scratch_bytes"] = adk.fused_plan(137, args.num_cols, dtype, evap, resident,
                                              occ["registers"])["scratch_bytes"]
        return occ

    for dtype in (torch.float32, torch.float64):
        _, s, dt = synthesize_state(args.num_cols, 137, 2, device, dtype)
        s["eta"] = eta_levels(s["ap"], s["aph"])
        s["qsat"] = saturation(s["ap"], s["t"], c=c)
        s.update(state_increment(s, 0.01, ignore_supsat=True))
        res, occ = {}, {}
        if "nl" in kernels:
            for name, (cf, opts) in nl_timed.items():
                if dtype == torch.float64 and cf.FAST_DIV != "exact":
                    continue
                res[name] = ms(lambda cf=cf, opts=opts: nlk.cloudsc2_nl_cuda(s, dt, cf, **opts))
                occ[name] = nlk.occupancy(dtype, cf, ncols=args.num_cols, **opts)
                occ[name]["checksum"] = checksum(torch, nlk.cloudsc2_nl_cuda(s, dt, cf, **opts))
        if "nl" in kernels and dtype == torch.float32:
            # a yardstick with writes: torch.add(a, b, out=o), 2 reads to 1
            # write, over the bytes the fused NL kernel's function moves
            # (26 values a column-level, 4 a column more) at this shape
            n = args.num_cols * (137 * 26 + 5) // 3
            a, b, o = (torch.rand(n, device=device) for _ in range(3))
            res["add yardstick"] = ms(lambda: torch.add(a, b, out=o))
            rate = 3 * n * 4 / res["add yardstick"][0] / 1e6
            print(f"{label} yardstick torch.add, 2 reads : 1 write, {3 * n * 4 / 1e9:.4f} GB: "
                  f"{res['add yardstick'][0]:.4f} ms, {rate:.1f} GB/s; {card}", flush=True)
            del a, b, o
        if "ad_fused" in kernels:
            for cname, cf in (("default", c), ("levapls2", c.replace(LEVAPLS2=True))):
                sa = seed_ad(tlk, s, dt, cf)
                res[f"two-kernel ad {cname}"] = ms(lambda: adk.cloudsc2_ad_cuda(sa, dt, cf))
                for form, resident in (("rolled", False), ("resident", True)):
                    name = f"fused {form} {cname}"
                    res[name] = ms(lambda: adk.cloudsc2_ad_fused_cuda(sa, dt, cf, resident=resident))
                    occ[name] = fused_reading(dtype, cf, resident)
                del sa
                torch.cuda.empty_cache()
        if "tl" in kernels:
            for name, cf in (("tl", c), ("tl levapls2", c.replace(LEVAPLS2=True))):
                res[name] = ms(lambda cf=cf: tlk.cloudsc2_tl_cuda(s, dt, cf))
        if "ad" in kernels:
            forms = [("", c), (" levapls2", c.replace(LEVAPLS2=True)), (" ref", c.replace(CUADJ_COMPACT=False))]
            if dtype == torch.float32:
                forms += [(f" {m}", c.replace(FAST_DIV=m)) for m in ("faithful", "approx")]
            for suffix, cf in forms:
                sa = seed_ad(tlk, s, dt, c.replace(LEVAPLS2=cf.LEVAPLS2))
                traj = nlk.cloudsc2_nl_cuda(sa, dt, cf, with_trajectory=True)[2]
                name = "ad reverse" + suffix
                res[name] = ms(lambda: adk.cloudsc2_ad_reverse_cuda(sa, traj, dt, cf))
                occ[name] = reverse_reading(dtype, cf)
                occ[name]["checksum"] = reverse_checksum(adk.cloudsc2_ad_reverse_cuda(sa, traj, dt, cf))
                occ[name]["host_ms"] = round(statistics.median(host_times(
                    torch, lambda: adk.cloudsc2_ad_reverse_cuda(sa, traj, dt, cf), args.runs, args.batch)), 4)
                if suffix in ("", " levapls2") and "ad_fused" not in kernels:  # else timed there
                    res["two-kernel ad" + (suffix or " default")] = ms(lambda: adk.cloudsc2_ad_cuda(sa, dt, cf))
                if suffix == "":
                    res["cotangent_only"] = ms(lambda: adk.cloudsc2_ad_cuda(sa, dt, cf, cotangent_only=True))
                del sa, traj
                torch.cuda.empty_cache()
        tag = str(dtype)[6:]
        print(f"{label} {tag} {args.num_cols}x137: "
              + "; ".join(f"{k} {v[0]:.4f} ms (runs {[round(x, 4) for x in v[1]]})" for k, v in res.items())
              + f"; {card}", flush=True)
        for name, o in occ.items():
            if name.startswith("fused "):
                print(f"{label} {tag} {name}: {res[name][0]:.4f} ms; block {o['block']}, {o['blocks_per_sm']} "
                      f"blocks and {o['threads_per_sm']} threads per SM, {o['registers']} registers, "
                      f"{o['local_bytes']} B local, {o['shared_bytes']} B shared a block, "
                      f"{o['scratch_bytes']} B scratch", flush=True)
                continue
            if name.startswith("ad reverse"):
                print(f"{label} {tag} {name}: {res[name][0]:.4f} ms; outputs checksum {o['checksum']}; "
                      + ", ".join(f"{k} {v}" for k, v in o.items() if k != "checksum"), flush=True)
                continue
            print(f"{label} {tag} {name}: {o['registers']} registers, {o['local_bytes']} B local, "
                  f"{o['blocks_per_sm']} blocks of 128 per SM (carveout for {o['carveout_blocks']}), "
                  f"{o['shared_bytes']} B shared a block, ring depth {o['depth']}; outputs checksum "
                  f"{o['checksum']}", flush=True)
        print(json.dumps({"tree": args.tree, "dtype": tag, "ncols": args.num_cols, "card": card,
                          "ms": {k: v[0] for k, v in res.items()}, "occupancy": occ}), flush=True)
        del s
    return 0


if __name__ == "__main__":
    sys.exit(main())
