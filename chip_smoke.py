#!/usr/bin/env python3
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

Phases, each timed; any failure raises and the script exits non-zero:

1. card: CUDA must be available; prints ``nvidia-smi`` name and power limit.
2. build: compiles the NL, TL, AD (reverse) and fused AD kernels from the
   sources in this checkout, one library per form
   (``cloudsc2_tpu_torch.kernels.build.form``: the NL's two, one per
   saturation-adjustment form, each with every divide mode; the TL's and
   AD's three, compact with the exact divide, compact with faithful and
   approx, and CUADJ_COMPACT=False with every divide), and the probes'
   library (``microbench.cu``), twelve nvcc processes at once, and beside
   them the launch path every launch plan calls (``launcher.cpp``, g++
   against the installed torch); prints each library's build time, and
   ptxas's registers and spills for every instantiation.
3. NL kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the same CUDA tensors, f64 and f32, for the three switch configurations
   (default, LEVAPLS2, LDRAIN1D) at 4096 x 137 and the default at
   65,536 x 137; prints the worst abs/rel error per field.  The fused
   kernel (``fuse_saturation``) against ``Saturation`` + the unfused kernel,
   f64 and f32, the three configurations and LPHYLIN=False with kflag 1
   and 2 (a convective ramp apart from foealfa's, so the two branches
   differ) at 4096 x 137 and the default at 65,536 x 137: bitwise
   (printed), or its reading printed and held at the NL tolerances with
   qsat at rtol 1e-6, atol 1e-10 (f32); at the default and 4096 x 137 its
   ``with_trajectory`` and ``traj_only`` forms bitwise the fused launch and
   the unfused trajectory.  The divide modes: the faithful and approx f32
   kernels, fused and unfused (the three configurations at 4096 x 137, and
   fused the default at 65,536 x 137), against the plain exact version,
   per field in units of its largest magnitude, at the gate of their form
   (``cloudsc2_tpu_torch.utils.compare.div_gate``), and not bitwise the
   exact kernel; f64 with FAST_DIV set bitwise the exact kernel.  The
   kernel's reciprocal alone (``rcp_cuda``) at 2**20 points: exact the
   correctly rounded 1/x, approx (``rcp.approx.ftz.f32``) within 1 ulp and
   not 1/x everywhere, faithful bitwise one Newton step of approx, within 2
   ulps, and not approx everywhere.  CUADJ_COMPACT=False: the NL kernel
   against the plain NL in that form, f64 and f32, the three configurations
   at 4096 x 137 and the default at 65,536 x 137, at the NL tolerances; at
   the default and 4096 x 137 its fused form bitwise Saturation + the
   unfused kernel, its trajectory forms, and its faithful and approx f32
   forms against the plain exact NL in that form at ``div_gate``.
4. TL kernel vs plain: the same for the TL kernel, each configuration with
   LREGCL on and off at 4096 x 137 and the default at 65,536 x 137, and
   ``tangent_only`` against the ``*_i`` outputs of the full launch
   (bitwise).  The divide modes: the faithful and approx f32 TL kernel (the
   three configurations at 4096, the default at 65,536) against the plain
   exact TL, per field in units of its largest magnitude, at
   ``div_gate(field, "tl")``, not bitwise the exact kernel, its
   ``tangent_only`` form bitwise its full launch; f64 with FAST_DIV set
   bitwise the exact kernel.  CUADJ_COMPACT=False: the TL kernel against the
   plain TL in that form (f64 and f32, the same shapes) at the TL
   tolerances.
5. NL trajectory: with ``with_trajectory`` the NL kernel's outputs are
   bitwise those of the launch without it, its trajectory is held against
   the plain NL's at the NL tolerances of the fluxes (printed as bitwise
   where it is), and ``traj_only`` returns that trajectory bitwise and
   nothing else; the three configurations, at 4096 x 137 in f64 and f32 and
   at 100 x 137 in f64 (and at 65,536 x 137 in phase 10).
6. AD kernels vs plain: the forward and reverse kernels against the plain
   AD (the vjp of the plain TL), the three configurations with LREGCL on
   and off, at the shapes of phase 5, the default at a ragged 4000 x 137
   (and at 65,536 x 137 in phase 10), per field in units of its largest
   magnitude, lu_i and lude_i in f32 also point by point
   (``cloudsc2_tpu_torch.utils.compare.ad_limit``), and f32 at 4096 and
   4000 columns also against the f64 plain AD on the same inputs (a
   reading); at each of these the
   fused kernel, rolled and resident, bitwise against the two-kernel AD
   and within those limits of the plain AD, its plan printed (block, blocks
   and threads per SM, levels in shared memory, scratch bytes) and held by
   the card, and ``cotangent_only`` bitwise
   the full AD's cotangents; f32 at 1000 x 137 with the seed of
   tests/test_torch_cuda.py (LEVAPLS2 and LDRAIN1D, LREGCL on), held the
   same way and, kernel and plain f32 AD, against the f64 plain AD (a
   reading); zero seeds give exactly zero cotangents.  ``LPHYLIN=False``
   (f64 and f32, the three configurations at 4096 x 137): the two-kernel
   AD, ``cotangent_only``, the fused kernel rolled and resident and the
   ``Cloudsc2AD`` component on CUDA tensors launch the kernels and are
   bitwise the ``LPHYLIN=True`` launch on the same state, and within
   ``ad_limit`` of the plain AD under LPHYLIN=False.  The divide modes (f32,
   the three configurations at 4096 and the default at 65,536): the
   two-kernel AD against the plain exact AD at ``div_gate(field, "ad")``,
   not bitwise the exact kernels, the fused kernel (rolled, resident) and
   ``cotangent_only`` bitwise it; f64 with FAST_DIV set bitwise the exact
   kernels.  CUADJ_COMPACT=False (f64 and f32, the same shapes): the
   two-kernel AD against the plain AD in that form at ``ad_limit``, the
   fused kernel and ``cotangent_only`` bitwise it.
7. NL main path: the port's driver (``drivers/run_nonlinear_torch.py``
   core()) through EtaLevels -> Cloudsc2NL with saturation fused in (the
   driver's default) on the card, double and single, at 100 and 65,536
   columns, validated against the golden outputs (HOORAY), which are
   built in process as drivers/generate_reference.py builds them (no h5py
   needed); then the two-stage path (``--no-fuse-saturation``: Saturation
   -> Cloudsc2NL) in single at 65,536, and ``--fast-div faithful`` and
   ``approx`` in single at 100 and 65,536 columns, at the driver's single
   gate; the NL kernel's launch count must grow, and that under a
   non-exact divide too.  Then the NL cell's launch, 262,144 columns in
   float32, unfused and fused: each bitwise its plain version, and with the
   counts set to 0 just before, every launch counted in
   ``cloudsc2_nl_cuda.wide_launches`` (its carveout sized for more than 4
   blocks an SM).
8. TL path: the Taylor protocol (``drivers/run_taylor_test_torch.py``
   core()) through the NL and TL kernels on the card: double at 1 column;
   double per column at 65,536 columns; single with column 0 tiled over
   4096 columns and the f32 floors -- each must print HOORAY; and, as a
   reading, single per column at 65,536 columns.  Both launch counts must
   grow.
9. AD path: the symmetry protocol (``drivers/run_symmetry_test_torch.py``
   core()) through the TL kernel and the AD's forward (NL) and reverse
   kernels: double at 100 and 65,536 columns and single at 4096 columns
   must print HOORAY; single at 65,536 columns is a reading.  The launch
   counts of all three must grow.  Then the same protocol (the TL kernel,
   ``SymmetryTest.get_norm1`` / ``get_norm2`` / ``validate``) through the
   fused AD kernel, rolled and resident (its plan printed and held by the
   card), and through the ``cotangent_only``
   AD, double at 65,536 columns and single at 4096: HOORAY, and the fused
   kernel's launch count must grow.  Then this slice's forms, at 65,536
   columns through the drivers, each with the launch counts at 0 before it
   and read after (its kernels must have launched in its form): symmetry
   HOORAY under LPHYLIN=False (double, single), faithful and approx
   (single) and CUADJ_COMPACT=False (double, single); Taylor HOORAY under
   faithful (single, column 0 tiled, the f32 floors) and CUADJ_COMPACT=False
   (double, per column); Taylor under approx (single, per column) a
   reading, with its pass and strict fractions; and the fused symmetry path
   at 4096 columns under each of the four forms.
10. timing at 65,536 x 137, f32 and f64, with CUDA events, beside the
   card's name and power limit: each kernel against its plain version
   (kernel runs are batches of KERNEL_BATCH back-to-back calls, median of
   10; the NL plain version median of 10, the TL and AD plain versions,
   slower, median of 3), the TL kernel also with ``tangent_only``, the AD's
   forward and reverse kernels apart (after holding the AD, the fused AD
   and the trajectory against their plain versions at this shape), the
   ``cotangent_only`` step and its ``traj_only`` forward, the fused kernel
   rolled and resident with its plan (block, blocks and threads per SM,
   levels of the stack in shared memory, scratch bytes), the card's
   occupancy held to the plan at the card's registers, each AD kernel's registers
   and local memory (the card's) and spills (ptxas), the reverse kernel's
   blocks per SM, ring depth and shared bytes (``reverse_occupancy``, held
   to ``reverse_plan``) and its time with LEVAPLS2, each beside its bound
   by bytes and by operations (the bytes each input read once and each
   output written once) and, as a reading, the operations of the
   hand-transposed reverse level by its hand count; and each wrapper's host
   time per call (host clock around KERNEL_BATCH asynchronous calls, before
   the synchronize); the fused NL kernel against its bound, beside the
   two-stage Saturation + unfused kernel, and in f32 the faithful and
   approx fused kernels beside the exact one; for each NL instantiation
   timed (unfused, fused, fused faithful / approx, with trajectory,
   ``traj_only``, the unfused forms below), the card's reading of it
   (``kernels.nonlinear.occupancy``: registers and local bytes a thread,
   blocks of 128 per SM at 65,536 and at 262,144 columns, which must be at
   least 4 so that 65,536 columns run in one wave, with the float32
   carveout sized for 4 blocks there, the pipelined scan's ring depth and
   shared bytes a block), and the NL launches since the counts were last
   set to 0 whose carveout was sized for more than 4 blocks
   (``cloudsc2_nl_cuda.wide_launches``).
   This slice's forms: the NL
   kernel, the TL kernel, the two-kernel AD (the reverse kernel also alone)
   and the fused AD rolled under faithful and approx (f32) and
   CUADJ_COMPACT=False (f32 and f64), beside the exact compact form's times
   of this run, with the reverse and fused kernels' registers and the
   fused kernel's block held to the plan.
11. profile: torch.profiler over NL main-path steps, fused (Cloudsc2NL
   with saturation fused in) and two-stage (Saturation + Cloudsc2NL), f32,
   65,536 x 137: wall time, device time of the NL kernel and of the rest,
   and the device's busy share.
   Then the main path's launch path unprofiled (``drivers/kernel_ab_torch.py``
   ``launch_readings``), the launch counts from 0 over it: at 65,536 x 137
   and 100 x 137, f32 and f64, the fused NL wrapper and the
   ``cotangent_only`` AD step, each its host ms a call (asynchronous calls),
   device ms a call (CUDA events behind a sleep kernel) and the wall of one
   synchronized step (the ``Cloudsc2NL(fuse_saturation=True)`` component; the
   AD through ``dispatch.cloudsc2_ad`` and ``device_sync``) with the device's
   busy share of it, checksums of every NL and two-kernel AD form's
   outputs, and the launch plans' caches (``kernels/nonlinear.py``
   ``_nl_plan``, ``kernels/adjoint.py`` ``_reverse_plan``) held within
   their bound.
12. probes (``cloudsc2_tpu_torch.kernels.microbench``): the reader kernel
   bitwise its plain version at every instantiation and shape its path
   runs (S = 1-32 in both layouts at a ragged 4000 columns, S = 3 and 10 at
   4096, at 65,536 S = 10 in both layouts and each port kernel's input
   stream count; 137 levels); every chain variant bitwise its plain version
   given the card's approximate reciprocal, at 137 x 65,536 on the wide
   operand range, one step of each within its ulp bound of the float64
   map, ``rcpx1`` and ``rcpx2`` apart from ``rcpx``; then each probe
   through its driver, with its launch count at 0 before and read after
   (both must grow): ``drivers/microbench_hbm_torch.py`` at the JAX
   script's defaults and at 65,536 x 137 at each port kernel's input stream
   count (GB/s, share of 3.35 TB/s, ``torch.sum`` beside it),
   ``drivers/microbench_div_torch.py`` at the JAX script's shape, every
   variant within 1e-6 of the float64 chain, the latency reading's SM
   placement printed; the plain versions timed once each.

13. stream (``cloudsc2_tpu_torch.parallel``): the column-chunked stream
   through pinned host rings of 4 slots of 65,536 x 137, f32 over
   10,485,760 columns (160 chunks) and f64 over 2,097,152 (32), each in half
   and in full duplex, the NL kernel's launch count from 0 (one a chunk and
   one warm-up); each checksum bitwise the same reduction of the one-shot
   ``forward_step`` outputs of ring slot ``i % 4`` on device-resident
   copies of the slots, chunk 0's sample bitwise slot 0's one-shot output
   and HOORAY against the goldens at the driver's gates; ``torch.profiler``
   over 8 chunks: every host-to-device copy pinned, on another stream than
   the NL kernel's, and one at least overlapping an NL kernel, with the NL
   kernel's and the copies' busy shares of the window; the yardsticks
   (each ring slot's pinned copy to the device, a chunk's outputs back,
   both at once on two streams, the NL step on a resident chunk, the
   host's sum of a chunk; medians of 10) and the sweep's bound, a chunk per
   the mean over the slots of max(copy, kernel), each the fastest of its
   10 runs, the copy one way in half duplex and both ways at once in full
   duplex, with the stream's columns/s and share of it;
   the driver's ``--stream-chunk 65536`` path (f32 full duplex over 16
   chunks, f64 half duplex over 8) with HOORAY and its launches; then
   ``full_step`` at 65,536 x 137, f32 and f64, with the NL, TL and AD
   launch counts from 0: its per-column norms bitwise the symmetry
   protocol's on the same state, its NL tendencies bitwise the TL
   kernel's forward tendencies.  ``--only-stream`` builds the NL, TL and
   AD libraries and runs this phase alone.

The line before the last is a JSON summary of the kernels, each with its
forms of this slice under ``forms``; the last line is
``{"ok": true, "device": {...}}``.

14. mesh (``cloudsc2_tpu_torch.parallel.mesh``, ``step``, ``dryrun``), the
   launch counts from 0 over the phase: the sharded forward step at
   65,536 x 137, f32 and f64, on the mesh of the one card and on a
   hand-made mesh of 4 shards of its columns, bitwise the unsharded fused
   NL step with one launch a shard, each timed beside the unsharded step;
   ``dryrun_multichip(1, device="cuda")`` (golden NL at the CPU single
   gate, ``full_step``'s symmetry gate); the three drivers with
   ``--sharded`` (NL HOORAY at 65,536 in f32 and f64, Taylor per column at
   4096 in f64, symmetry at 65,536 in f64 and f32); two processes of the NL
   driver sharing the card over a gloo group (``--distributed``, 4096
   columns, f32), each with HOORAY on its column block and its NL launches.
   ``--only-mesh`` builds the NL, TL and AD libraries and runs this phase
   alone.

Usage:  python3 chip_smoke.py [--only-stream | --only-mesh]
"""
from __future__ import annotations

import functools
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

NLEV = 137
BIG = 65536
#: the benchmark cells' columns a call (2,048 blocks of 128: more than one wave)
WIDE = 262_144
SMALL = 4096
#: a column count that fills no block of the AD kernels (128, 64, 32, 16)
RAGGED = 4000
#: kernel calls per timed batch: the wrapper's host work (checks,
#: allocation, launch; phase 10 measures it) overlaps the previous call's
#: kernel, so the batch times the device
KERNEL_BATCH = 10


def tolerances(torch, dtype, c):
    """NL field -> (rtol, atol).  f64: the driver's double gate (rtol 1e-10,
    atol 1e-16).  f32: the Pallas-kernel gate of tests/test_pallas.py
    (rtol 2e-5; atol 1e-8 on tendencies, 1e-6 on diagnostics).  fhps* are
    fpls* scaled by L ~ 2.5e6, so their atol covers a flux residue
    (cloudsc2_tpu_torch.utils.compare.flux_residue) times L."""
    from cloudsc2_tpu_torch.utils.compare import nl_tolerances

    if dtype == torch.float64:
        return nl_tolerances((1e-10, 1e-16), (1e-10, 1e-16), c, "float64")
    return nl_tolerances((2e-5, 1e-8), (2e-5, 1e-6), c, "float32")


def tl_tolerances(torch, dtype, c):
    """TL field (and its ``*_i``) -> (rtol, atol).  f64 as the NL; f32 the
    TL Pallas gate of tests/test_pallas.py (rtol 3e-5; atol 1e-7 on
    tendencies, 1e-5 on diagnostics); fhps* with the flux-residue atol."""
    from cloudsc2_tpu_torch.utils.compare import nl_tolerances

    if dtype == torch.float64:
        return nl_tolerances((1e-10, 1e-16), (1e-10, 1e-16), c, "float64", perturbations=True)
    return nl_tolerances((3e-5, 1e-7), (3e-5, 1e-5), c, "float32", perturbations=True)


def compare(got, want, tol, label):
    """Print the worst abs/rel error of each field (one line when every
    field is bitwise equal); raise beyond tolerance.  Returns the largest
    abs error over all fields."""
    from cloudsc2_tpu_torch.utils.compare import field_errors

    errs = field_errors({k: v.cpu().numpy() for k, v in got.items()},
                        {k: v.cpu().numpy() for k, v in want.items()}, tol)
    if all(e[0] == 0.0 for e in errs.values()):
        print(f"  {label} all {len(errs)} fields bitwise equal (max_abs 0, max_rel 0): {' '.join(errs)}")
    else:
        for n, (max_abs, max_rel, share) in errs.items():
            rtol, atol = tol[n]
            print(f"  {label} {n:8s} max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
                  f"(rtol {rtol:g}, atol {atol:g}: {share:.3f} of the limit)")
    bad = [n for n, e in errs.items() if not e[2] <= 1.0]
    if bad:
        raise AssertionError(f"{label}: kernel differs from the plain version in {bad}")
    return max(e[0] for e in errs.values())


@functools.lru_cache(maxsize=6)
def synthetic(ncols, seed):
    """The seeded synthetic input in numpy, made once per shape and seed
    (6.5 s at 65,536 columns on one core)."""
    from cloudsc2_tpu_torch import iox

    return iox.synthesize_input(ncols=ncols, nlev=NLEV, seed=seed)


def make_state(torch, ncols, dtype, c, seed, increment=False):
    """``(grid, state, dt)``: a seeded synthetic state on the card, with
    ``eta`` and ``qsat`` diagnosed as the main path does, and with
    ``increment`` the TL's perturbations (0.01 times each field)."""
    from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
    from cloudsc2_tpu_torch.physics.increment import state_increment
    from cloudsc2_tpu_torch.physics.saturation import saturation
    from cloudsc2_tpu_torch.state import state_from_numpy

    grid, st, dt = synthetic(ncols, seed)
    s = state_from_numpy(st, torch.device("cuda:0"), dtype)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    if increment:
        s.update(state_increment(s, 0.01))
    return grid, s, dt


def flat(out):
    tends, diags = out
    return {**tends, **diags}


def time_ms(torch, fn, calls):
    """Milliseconds between CUDA events around ``calls`` back-to-back calls
    of ``fn`` (device time once the queue stays full): ``utils/card.run_ms``
    without its hold, the yardstick of phases 3-11 since the port began, so
    that their times stay comparable from run to run and a plain version's
    host time between its launches counts.  Phase 12 times with the hold."""
    from cloudsc2_tpu_torch.utils.card import run_ms

    return run_ms(fn, calls, torch.device("cuda", torch.cuda.current_device()), hold=False)


def host_ms(torch, fn, calls):
    """Host milliseconds per call of ``fn`` over ``calls`` asynchronous
    calls, read before the device is synchronized (the queue is short
    enough that no launch waits for the device)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def time_kernel(torch, kernel, plain, plain_runs):
    """``(kernel ms, plain ms, wrapper host ms, kernel runs, plain runs)``:
    medians over alternating runs; a kernel run is a batch of KERNEL_BATCH
    calls, timed by CUDA events."""
    for fn in (kernel, kernel, plain):
        fn()
    torch.cuda.synchronize()
    k_ms, p_ms, h_ms = [], [], []
    for i in range(10):
        if i < plain_runs:
            p_ms.append(time_ms(torch, plain, 1))
        k_ms.append(time_ms(torch, kernel, KERNEL_BATCH) / KERNEL_BATCH)
        h_ms.append(host_ms(torch, kernel, KERNEL_BATCH))
    return statistics.median(k_ms), statistics.median(p_ms), statistics.median(h_ms), k_ms, p_ms


def build_kernels(build, loaders, card):
    """Build and load every kernel library at once (one nvcc each); print
    each library's build time, and ptxas's registers, spills and stack for
    every instantiation."""
    def timed(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        futures = {name: pool.submit(timed, load) for name, load in loaders.items()}
        took = {name: f.result() for name, f in futures.items()}  # raises the build's error, if any
    print(f"[build] {', '.join(loaders)} built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{n} {t:.1f} s' for n, t in took.items())}, at once); {card}")
    for name in loaders:
        entry = ""
        for line in build.logs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build]   {name} {entry}: {line.strip()}")


def is_nl_kernel(name):
    """Whether a profiled kernel's name is the NL kernel's: the pipelined
    scan (``levelscan.cuh`` ``level_scan_pipelined_kernel``) over
    ``NLPipeBody``; the AD's reverse kernel is the same scan over another
    body."""
    return "level_scan_pipelined_kernel" in name and "NLPipeBody" in name


def profile_main_path(torch, c, card, fused, steps=20):
    """Profile ``steps`` main-path steps (f32, 65,536 x 137), ``fused``
    (Cloudsc2NL with saturation fused in, the driver's default) or
    two-stage (Saturation + Cloudsc2NL): wall time per step, device time
    per step split into the NL kernel and the rest, and the device's busy
    share.  Returns ``(wall, device, NL kernel, other)`` ms per step."""
    from torch.profiler import ProfilerActivity, profile

    from cloudsc2_tpu_torch.components import Cloudsc2NL, Saturation

    grid, s, dt = make_state(torch, BIG, torch.float32, c, seed=2)
    if fused:
        del s["qsat"]
        nl = Cloudsc2NL(grid, c, fuse_saturation=True)

        def step():
            return nl(dict(s), dt)
    else:
        sat, nl = Saturation(grid, c), Cloudsc2NL(grid, c)

        def step():
            x = dict(s)
            x.update(sat(x))
            return nl(x, dt)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernel_us = other_us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if is_nl_kernel(e.key):
            kernel_us += us
        else:
            other_us += us
    busy = (kernel_us + other_us) / 1e3 / steps
    path = "fused (Cloudsc2NL with saturation)" if fused else "two-stage (Saturation + Cloudsc2NL)"
    print(f"[profile f32 {BIG}x{NLEV}] {path} main-path step: wall {wall:.4f} ms (host clock, "
          f"synchronized components), device {busy:.4f} ms = NL kernel {kernel_us / 1e3 / steps:.4f} + other "
          f"kernels {other_us / 1e3 / steps:.4f}; device busy share {busy / wall:.3f}; {card}")
    if kernel_us == 0.0:
        raise AssertionError(f"the profile of the {path} path shows no NL kernel time")
    return wall, busy, kernel_us / 1e3 / steps, other_us / 1e3 / steps


def nl_wide_checks(torch, nlk, plain_nl, c, card):
    """Phase 7, the NL cell's launch: WIDE columns in float32, unfused and
    fused, each launch's outputs bitwise its plain version's on the same
    CUDA tensors; with the NL counts set to 0 just before, every launch
    must count in ``wide_launches`` (its shared-memory carveout sized for
    more than 4 blocks an SM).  Returns ``(launches, wide launches)``."""
    _, s, dt = make_state(torch, WIDE, torch.float32, c, seed=1)
    bare = {k: v for k, v in s.items() if k != "qsat"}
    reset_counts(nlk.cloudsc2_nl_cuda)
    for form, state, opts in (("unfused", s, {}), ("fused", bare, {"fuse_saturation": True})):
        got = flat(nlk.cloudsc2_nl_cuda(state, dt, c, **opts))
        want = flat(plain_nl(state, dt, c, **opts))
        torch.cuda.synchronize()
        label = f"[nl-wide f32 {form} {WIDE}x{NLEV}]"
        assert_bitwise(torch, got, want, f"{label} against the plain version")
        print(f"  {label} all {len(want)} fields bitwise equal to the plain version")
        del got, want
    counts = nlk.cloudsc2_nl_cuda.launches, nlk.cloudsc2_nl_cuda.wide_launches
    print(f"[nl-wide] NL launches {counts[0]}, of them with the carveout sized for more than 4 blocks an SM "
          f"{counts[1]}; {card}")
    if counts != (2, 2):
        raise AssertionError(f"[nl-wide] {counts[1]} of {counts[0]} NL launches at {WIDE:,} columns sized the "
                             f"carveout for more than 4 blocks an SM; want 2 of 2")
    return counts


def launch_phase(torch, nlk, adk, card):
    """Phase 11, the launch path: :func:`drivers.kernel_ab_torch.
    launch_readings` on this checkout, the NL and AD launch counts from 0
    over it (both must grow), and the launch plans' caches held within their
    bound.  Returns ``(readings, launches)``."""
    from drivers.kernel_ab_torch import launch_readings

    reset_counts(nlk.cloudsc2_nl_cuda, adk.cloudsc2_ad_cuda)
    readings = launch_readings(torch, torch.device("cuda:0"), card, "[launch]", runs=5)
    launches = {"cloudsc2_nl_cuda": nlk.cloudsc2_nl_cuda.launches, "cloudsc2_ad_cuda": adk.cloudsc2_ad_cuda.launches}
    caches = {"NL": nlk._nl_plan.cache_info(), "AD reverse": adk._reverse_plan.cache_info()}
    print(f"[launch] launches in this phase: {launches}; launch plans: "
          + ", ".join(f"{k} {i.currsize} kept (bound {i.maxsize}), {i.hits} hits, {i.misses} builds"
                      for k, i in caches.items()) + f" in this process; {card}")
    if not all(launches.values()):
        raise AssertionError(f"[launch] a kernel of the launch path never launched: {launches}")
    if any(i.currsize > i.maxsize for i in caches.values()):
        raise AssertionError(f"[launch] launch plans kept above their bound: {caches}")
    return readings, launches


def taylor_gates(torch, nlk, tlk, card):
    """Phase 8: the Taylor protocol through the driver on the card.  Returns
    ``(NL launches, TL launches)`` of the phase."""
    from cloudsc2_tpu_torch.config import Config, TorchConfig
    from cloudsc2_tpu_torch.validation.taylor import FLOORS_PER_COLUMN
    from drivers.run_nonlinear_torch import synthetic_input
    from drivers.run_taylor_test_torch import core

    cases = [  # (precision, columns, options, gate)
        ("double", 1, {}, True),
        ("double", BIG, {"per_column": True}, True),
        ("single", SMALL, {"tile_column": True, "floors": "auto"}, True),
        ("single", BIG, {"per_column": True, "floors": "auto"}, False),
    ]
    nlk.cloudsc2_nl_cuda.launches = 0
    tlk.cloudsc2_tl_cuda.launches = 0
    for precision, ncols, opts, gate in cases:
        t0 = time.perf_counter()
        rc, tt = core(
            Config(precision=precision, num_cols=ncols, num_runs=1),
            TorchConfig(device="cuda:0", precision=precision),
            inputs=synthetic_input(ncols, precision), **opts,
        )
        label = f"[taylor {precision} {ncols} columns{''.join(' ' + k for k in sorted(opts))}]"
        extra = ""
        if opts.get("per_column"):
            mode = "f32" if precision == "single" and opts.get("floors") == "auto" else "f64"
            pen = tt.column_penalties(tt.norms, *FLOORS_PER_COLUMN[mode])
            strict = tt.column_penalties(tt.norms, *FLOORS_PER_COLUMN[mode], strict=True)
            extra = (f"; pass fraction {int((pen <= 5).sum())}/{ncols} = {float((pen <= 5).mean()):.4f}, "
                     f"strict fraction {int((strict <= 5).sum())}/{ncols} = {float((strict <= 5).mean()):.4f}")
        print(f"{label} exit {rc}{extra} ({'gate' if gate else 'reading'}; {time.perf_counter() - t0:.1f} s "
              f"host clock; {card})")
        if gate and rc != 0:
            raise AssertionError(f"{label} failed: the Taylor verdict is not HOORAY")
    launches = nlk.cloudsc2_nl_cuda.launches, tlk.cloudsc2_tl_cuda.launches
    print(f"[taylor] launches in this phase: cloudsc2_nl_cuda {launches[0]}, cloudsc2_tl_cuda {launches[1]}")
    if min(launches) == 0:
        raise AssertionError("the Taylor path did not launch both CUDA kernels")
    return launches


def scaled_errors(got, want):
    """Per field of ``want``: the largest abs difference over the field's
    largest magnitude (inf where ``got`` is not finite)."""
    out = {}
    for n, w in want.items():
        g, w = got[n].double(), w.double()
        finite = bool(g.isfinite().all())
        out[n] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-300) if finite else float("inf")
    return out


def nl_fused_checks(torch, nlk, configs, card):
    """Phase 3, the fused kernel: against ``Saturation`` + the unfused
    kernel on the same CUDA tensors; at the default and 4096 x 137 also its
    ``with_trajectory`` and ``traj_only`` forms.  Returns the largest abs
    error by ``(dtype tag, configuration, columns)`` (0 where bitwise)."""
    from cloudsc2_tpu_torch.physics.saturation import saturation

    c0 = configs["default"]
    # a convective liquid-fraction ramp apart from foealfa's, so that the
    # kflag 1 (foeewmcu) and kflag 2 (foeewm) branches give different qsat
    nolph = c0.replace(LPHYLIN=False, RTICECU=c0.RTT - 38.0, RTWAT_RTICECU_R=1.0 / 38.0)
    cases = [(name, c, 1, SMALL) for name, c in configs.items()]
    cases += [("lphylin=False kflag=1", nolph, 1, SMALL), ("lphylin=False kflag=2", nolph, 2, SMALL),
              ("default", c0, 1, BIG)]
    out = {}
    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, c, kflag, ncols in cases:
            _, s, dt = make_state(torch, ncols, dtype, c, seed=1)
            qsat = saturation(s["ap"], s["t"], kflag=kflag, lphylin=c.LPHYLIN, c=c)
            s["qsat"] = qsat
            want = {**flat(nlk.cloudsc2_nl_cuda(s, dt, c)), "qsat": qsat}
            bare = {k: v for k, v in s.items() if k != "qsat"}
            got = flat(nlk.cloudsc2_nl_cuda(bare, dt, c, fuse_saturation=True, kflag=kflag))
            torch.cuda.synchronize()
            label = f"[nl-fused-vs-two-stage {tag} {name} {ncols}x{NLEV}]"
            if name == "lphylin=False kflag=2":
                other = saturation(s["ap"], s["t"], kflag=1, lphylin=False, c=c)
                if torch.equal(other, qsat):
                    raise AssertionError(f"{label}: kflag 1 and 2 give the same qsat; the case checks nothing")
            if sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want):
                print(f"  {label} all {len(want)} fields bitwise equal, qsat included")
                out[(tag, name, ncols)] = 0.0
            else:
                tol = dict(tolerances(torch, dtype, c),
                           qsat=(1e-6, 1e-10) if dtype == torch.float32 else (1e-10, 1e-16))
                out[(tag, name, ncols)] = compare(got, want, tol, f"{label} not bitwise:")
            if name == "default" and ncols == SMALL:
                tends, diags, traj = nlk.cloudsc2_nl_cuda(bare, dt, c, with_trajectory=True,
                                                          fuse_saturation=True)
                only = nlk.cloudsc2_nl_cuda(bare, dt, c, with_trajectory=True, traj_only=True,
                                            fuse_saturation=True)
                two = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)[2]
                torch.cuda.synchronize()
                assert_bitwise(torch, {**tends, **diags}, got, f"{label} with_trajectory against the fused launch")
                if only[0] or only[1]:
                    raise AssertionError(f"{label} traj_only returned step outputs")
                assert_bitwise(torch, only[2], traj, f"{label} traj_only against with_trajectory")
                if out[(tag, name, ncols)] == 0.0:
                    assert_bitwise(torch, traj, two, f"{label} fused trajectory against the unfused one")
                print(f"  {label} with_trajectory: outputs bitwise the fused launch's; traj_only: its "
                      f"{len(traj)} trajectory streams bitwise and nothing else"
                      + ("; the trajectory bitwise the unfused kernel's" if out[(tag, name, ncols)] == 0.0 else ""))
            del s, bare, got, want
    print(f"[nl-fused-vs-two-stage] {time.perf_counter() - t0:.1f} s; {card}")
    return out


def nl_divide_checks(torch, nlk, plain_nl, configs, card):
    """Phase 3, the divide modes: the faithful and approx f32 kernels, fused
    and unfused (the three configurations at 4096, and fused the default at
    65,536), against the plain exact version at the gate of their form
    (``cloudsc2_tpu_torch.utils.compare.div_gate``), per field in units of
    its largest magnitude, and not bitwise the exact kernel of their form;
    f64 with FAST_DIV set bitwise the exact kernel.  Returns the worst
    scaled and abs errors by ``(mode, configuration, columns, form)``."""
    from cloudsc2_tpu_torch.utils.compare import DIV_GATES, div_gate

    c0 = configs["default"]
    cases = [(name, c, SMALL, fused) for fused in (True, False) for name, c in configs.items()]
    cases += [("default", c0, BIG, True)]
    out = {}
    t0 = time.perf_counter()
    for name, c, ncols, fused in cases:
        _, s, dt = make_state(torch, ncols, torch.float32, c, seed=1)
        if fused:
            del s["qsat"]
        form = "fused" if fused else "unfused"
        want = flat(plain_nl(s, dt, c, fuse_saturation=fused))
        exact = flat(nlk.cloudsc2_nl_cuda(s, dt, c, fuse_saturation=fused))
        for mode in ("faithful", "approx"):
            got = flat(nlk.cloudsc2_nl_cuda(s, dt, c.replace(FAST_DIV=mode), fuse_saturation=fused))
            torch.cuda.synchronize()
            errs = scaled_errors(got, want)
            max_abs = max(float((got[k].double() - want[k].double()).abs().max()) for k in want)
            share = {k: v / div_gate(k, form) for k, v in errs.items()}
            worst = max(share, key=share.get)
            moved = sorted(k for k in exact if not torch.equal(got[k], exact[k]))
            label = f"[nl-{mode}-vs-plain-exact f32 {name} {form} {ncols}x{NLEV}]"
            print(f"  {label} worst {worst} {errs[worst]:.3e} of its scale ({share[worst]:.3f} of its gate; "
                  f"gates {DIV_GATES[form]}); max abs {max_abs:.3e}; by field "
                  f"{{{', '.join(f'{k}: {v:.2e}' for k, v in errs.items())}}}; {len(moved)} of {len(exact)} "
                  f"fields not bitwise the exact kernel's")
            if not share[worst] <= 1.0:
                raise AssertionError(f"{label}: {worst} {errs[worst]:.3e} of its scale, above its gate")
            if not moved:
                raise AssertionError(f"{label}: bitwise the exact kernel; the divide mode did not act")
            out[(mode, name, ncols, form)] = (max(errs.values()), max_abs)
            del got
        del s, want, exact
    for name in ("default", "levapls2"):
        c = configs[name]
        _, s, dt = make_state(torch, SMALL, torch.float64, c, seed=1)
        bare = {k: v for k, v in s.items() if k != "qsat"}
        exact = flat(nlk.cloudsc2_nl_cuda(s, dt, c))
        exact_fused = flat(nlk.cloudsc2_nl_cuda(bare, dt, c, fuse_saturation=True))
        for mode in ("faithful", "approx"):
            cm = c.replace(FAST_DIV=mode)
            assert_bitwise(torch, flat(nlk.cloudsc2_nl_cuda(s, dt, cm)), exact,
                           f"[nl f64 FAST_DIV={mode} {name}] against the exact kernel")
            assert_bitwise(torch, flat(nlk.cloudsc2_nl_cuda(bare, dt, cm, fuse_saturation=True)), exact_fused,
                           f"[nl f64 FAST_DIV={mode} {name} fused] against the exact kernel")
        print(f"  [nl f64 FAST_DIV {name} {SMALL}x{NLEV}] faithful and approx, fused and unfused: every "
              f"field bitwise the exact kernel's")
        del s, bare
    print(f"[nl-divide-modes] {time.perf_counter() - t0:.1f} s; {card}")
    return out


def rcp_checks(torch, nlk, card):
    """Phase 3, the kernel's reciprocal alone (``rcp_cuda``, the divide
    policies' ``rcp<D>``) at 2**20 seeded float32 points of either sign
    over 1e-30 to 1e30: exact bitwise the correctly rounded 1/x; approx (PTX
    rcp.approx.ftz.f32) within 1 ulp of 1/x (the PTX bound) and not it
    everywhere; faithful bitwise approx's ``r * (2 - x * r)`` in three
    rounded operations, within 2 ulps (the step's own roundings: x * r
    near 1 loses up to an ulp of r, the product rounds once more), and not
    approx everywhere.  Returns the largest ulp error and
    the share of points off the correctly rounded 1/x, by mode."""
    g = torch.Generator(device="cpu").manual_seed(5)
    n = 1 << 20
    x = (10.0 ** (torch.rand(n, generator=g, dtype=torch.float64) * 60 - 30)
         * torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0).double()).float().cuda()
    exact = 1.0 / x.double()
    want = exact.float()
    ulp = (torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()).double()
    r = {m: nlk.rcp_cuda(x, m) for m in ("exact", "faithful", "approx")}
    torch.cuda.synchronize()
    out = {m: (float(((v.double() - exact).abs() / ulp).max()), float((v != want).double().mean()))
           for m, v in r.items()}
    print(f"  [rcp {n} points] largest error in ulps of 1/x and share of points off its correct "
          f"rounding: {{{', '.join(f'{m}: ({u:.4f}, {f:.4e})' for m, (u, f) in out.items())}}}")
    a = r["approx"]
    if not torch.equal(r["exact"], want):
        raise AssertionError("[rcp] exact is not the correctly rounded 1/x")
    for m, lim in (("faithful", 2.0), ("approx", 1.0)):
        if not out[m][0] <= lim:
            raise AssertionError(f"[rcp] {m}: {out[m][0]:.4f} ulps from 1/x, above {lim:g}")
    if not out["approx"][1] > 0:
        raise AssertionError("[rcp] approx is the IEEE divide at every point")
    if not torch.equal(r["faithful"], a * (2.0 - x * a)):
        raise AssertionError("[rcp] faithful is not one Newton step r * (2 - x * r) of approx")
    if torch.equal(r["faithful"], a):
        raise AssertionError("[rcp] faithful is approx at every point: no Newton step")
    print(f"  [rcp] exact the correctly rounded 1/x; approx within 1 ulp; faithful within 2, one Newton step of "
          f"approx, bitwise, and {float((r['faithful'] != a).double().mean()):.4e} of its points apart "
          f"from it; {card}")
    return out


def ad_state(torch, ncols, dtype, c, seed):
    """``(grid, state, dt)``: the AD's input as the symmetry protocol
    assembles it on the card: the state with eta and qsat, its increments
    (supsat zeroed) and the TL's outputs as the cotangent seeds, from the TL
    kernel (bitwise the plain TL's on the card, phase 4)."""
    from cloudsc2_tpu_torch.kernels.tangent_linear import cloudsc2_tl_cuda
    from cloudsc2_tpu_torch.physics.increment import state_increment
    from cloudsc2_tpu_torch.validation.symmetry import DIAG_NAMES, TEND_NAMES

    grid, s, dt = make_state(torch, ncols, dtype, c, seed)
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    tends, diags = cloudsc2_tl_cuda(s, dt, c)
    for n in TEND_NAMES:
        s["tnd_" + n] = tends[n]
        s["tnd_" + n + "_i"] = tends[n + "_i"]
    for n in DIAG_NAMES:
        s[n + "_i"] = diags[n + "_i"]
    return grid, s, dt


def compare_ad(got, want, dtype, label):
    """Hold the AD outputs ``got`` against ``want`` at the limits of
    ``cloudsc2_tpu_torch.utils.compare.ad_limit``: print the worst field,
    every field above 1e-7 of its scale, and for the fields held point by
    point their absolute gate beside the median magnitude of their nonzero
    points; raise beyond a limit.  Returns ``(worst scaled error, worst abs
    error)``."""
    import numpy as np

    from cloudsc2_tpu_torch.utils.compare import AD_F32_KERNEL_WIDE, ad_errors, ad_limit, dtype_name

    g = {n: v.cpu().numpy().astype(np.float64) for n, v in got.items()}
    w = {n: v.cpu().numpy().astype(np.float64) for n, v in want.items()}
    errs = ad_errors(g, w, dtype)
    worst = max(errs, key=lambda n: errs[n][2])
    max_abs = max(float(np.abs(g[n] - w[n]).max()) for n in w)
    above = {n: float(f"{e[0]:.2e}") for n, e in errs.items() if e[0] > 1e-7}
    print(f"  {label} worst {worst} {errs[worst][0]:.3e} of its scale, {errs[worst][2]:.3f} of its "
          f"limit; max abs {max_abs:.3e}; fields above 1e-7 of their scale: {above}")
    if dtype_name(dtype) == "float32":
        for n in AD_F32_KERNEL_WIDE:
            a = np.abs(w[n])
            nz = a[a > 0]
            lim, med_lim = ad_limit(n, dtype)
            abs_gate = lim * float(a.max())
            print(f"  {label} {n}: {errs[n][0]:.3e} of its scale (limit {lim:g}), absolute gate "
                  f"{abs_gate:.3e} beside the median nonzero |{n}| {float(np.median(nz)) if nz.size else 0.0:.3e} "
                  f"({nz.size} of {a.size} points nonzero, {int((nz > abs_gate).sum())} above the gate); "
                  f"median relative difference {errs[n][1]:.3e} (limit {med_lim:g})")
    over = {n: (f"{e[0]:.3e}", f"{e[1]:.3e}") for n, e in errs.items() if not e[2] <= 1.0}
    if over:
        raise AssertionError(f"{label}: kernel differs from the plain version in (scaled, median "
                             f"relative) {over}")
    return max(e[0] for e in errs.values()), max_abs


def assert_bitwise(torch, got, want, label):
    """Raise unless ``got`` has the keys of ``want`` and every tensor is
    bitwise equal to its counterpart; on a difference, name the first field
    that differs, its first point and both values."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: fields {sorted(got)}, want {sorted(want)}")
    for k in want:
        if not torch.equal(got[k], want[k]):
            where = (got[k] != want[k]).nonzero()
            at = tuple(where[0].tolist())
            raise AssertionError(f"{label}: {k} differs at {len(where)} points, first {at}: "
                                 f"{got[k][at].item()!r} against {want[k][at].item()!r}")


def compare_trajectory(torch, nlk, plain_nl, s, dt, c, label):
    """Phase 5's check at one state: with ``with_trajectory`` the NL
    kernel's outputs are bitwise those without it, ``traj_only`` gives its
    trajectory bitwise and nothing else, and the trajectory is held against
    the plain NL's (the carry entering level k is the flux at interface k:
    the tolerances of fplsl, fplsn and covptot).  Returns the trajectory's
    largest abs error."""
    plain = flat(nlk.cloudsc2_nl_cuda(s, dt, c))
    tends, diags, traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)
    only = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True, traj_only=True)
    want = plain_nl(s, dt, c, with_trajectory=True)[2]
    torch.cuda.synchronize()
    assert_bitwise(torch, {**tends, **diags}, plain, f"{label} with_trajectory against the launch without it")
    if sorted(traj) != sorted(want):
        raise AssertionError(f"{label} trajectory streams {sorted(traj)}, want {sorted(want)}")
    if only[0] or only[1]:
        raise AssertionError(f"{label} traj_only returned step outputs {sorted({**only[0], **only[1]})}")
    assert_bitwise(torch, only[2], traj, f"{label} traj_only against with_trajectory")
    print(f"  {label} outputs bitwise equal to the launch without it; traj_only: its "
          f"{len(traj)} trajectory streams bitwise and nothing else")
    tol = tolerances(torch, s["t"].dtype, c)
    return compare(traj, want, {"c_rfl": tol["fplsl"], "c_sfl": tol["fplsn"], "c_cov": tol["covptot"]}
                   if "c_cov" in want else {"c_rfl": tol["fplsl"], "c_sfl": tol["fplsn"]},
                   f"{label} trajectory vs plain:")


def fused_checks(torch, adk, s, dt, c, two, label):
    """At one AD state: the fused kernel, rolled and resident, bitwise the
    two-kernel AD's outputs ``two``, and ``cotangent_only`` bitwise its
    cotangents.  Bitwise equal outputs have the two-kernel AD's errors
    against the plain AD, which ``compare_ad`` holds at ``ad_limit``: the
    fused kernel's plain-version gate is that one, on the same numbers."""
    for resident in (False, True):
        form = "resident" if resident else "rolled"
        got = flat(adk.cloudsc2_ad_fused_cuda(s, dt, c, resident=resident))
        torch.cuda.synchronize()
        assert_bitwise(torch, got, two, f"{label} fused {form} against the two-kernel AD")
        del got
    only = flat(adk.cloudsc2_ad_cuda(s, dt, c, cotangent_only=True))
    assert_bitwise(torch, only, {k: v for k, v in two.items() if k.endswith("_i")}, f"{label} cotangent_only")
    print(f"  {label} fused rolled and resident: all {len(two)} fields bitwise equal to the two-kernel AD "
          f"(so their errors against the plain AD are those above); cotangent_only: all {len(only)} "
          f"cotangents bitwise equal to the full AD's")
    for resident in (False, True):
        occ = fused_plan_reading(adk, s["ap"].dtype, c, resident, s["ap"].shape[1])
        print(f"    {label} fused {'resident' if resident else 'rolled'}: {fused_plan_text(occ)}")


def fused_plan_reading(adk, dtype, c, resident, ncols):
    """The fused kernel's occupancy on the card (``fused_occupancy``, which
    raises where it is not the plan's at the card's registers) with the
    plan's scratch bytes at ``ncols`` x NLEV."""
    occ = dict(adk.fused_occupancy(dtype, c, resident, NLEV))
    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)
    occ["scratch_bytes"] = adk.fused_plan(NLEV, ncols, dtype, evap, resident, occ["registers"])["scratch_bytes"]
    return occ


def fused_plan_text(occ):
    return (f"plan held by the card: {occ['block']} threads a block, {occ['blocks_per_sm']} blocks and "
            f"{occ['threads_per_sm']} threads per SM at {occ['registers']} registers ({occ['local_bytes']} B local), "
            f"{occ['shared_bytes']} B shared, {occ['levels_in_shared']} levels of the stack in shared memory, "
            f"{occ['scratch_bytes']} B of scratch in device memory")


def ad_checks(torch, adk, nlk, plain_ad, plain_nl, configs, card):
    """Phases 5 and 6: the NL kernel's trajectory and the AD kernels (the
    two-kernel AD, the fused kernel, ``cotangent_only``) against their plain
    versions, at 4096 x 137 in f64 and f32 and at 100 x 137 (the symmetry
    path's smallest shape) in f64, and the default at a ragged 4000 x 137.
    Returns the worst ``(scaled, abs)`` errors of the two AD designs
    against the plain AD (the same numbers: their outputs are bitwise
    equal) by ``(dtype tag, configuration, LREGCL, columns)``."""
    from cloudsc2_tpu_torch.utils.compare import AD_F32_SPREAD_WIDE, ad_errors

    shapes = ((torch.float64, SMALL), (torch.float64, 100), (torch.float32, SMALL))
    t0 = time.perf_counter()
    for dtype, ncols in shapes:
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, c in configs.items():
            _, s, dt = make_state(torch, ncols, dtype, c, seed=1)
            compare_trajectory(torch, nlk, plain_nl, s, dt, c, f"[nl-trajectory {tag} {name} {ncols}x{NLEV}]")
    print(f"[nl-trajectory] {time.perf_counter() - t0:.1f} s; {card}")

    t0 = time.perf_counter()
    ad_err = {}
    cases = [(dtype, ncols, name, c, lreg, 1) for dtype, ncols in shapes for name, c in configs.items()
             for lreg in (True, False)]
    cases += [(dtype, RAGGED, "default", configs["default"], True, 1) for dtype in (torch.float64, torch.float32)]
    # the state of tests/test_torch_cuda.py (seed 3) at which qsat_i read
    # its largest kernel-against-plain error, with evaporation and LREGCL
    cases += [(torch.float32, 1000, name, configs[name], True, 3) for name in ("levapls2", "ldrain1d")]
    for dtype, ncols, name, c, lreg, seed in cases:
        tag = "f64" if dtype == torch.float64 else "f32"
        cc = c.replace(LREGCL=lreg)
        _, s, dt = ad_state(torch, ncols, dtype, cc, seed=seed)
        got = flat(adk.cloudsc2_ad_cuda(s, dt, cc))
        want = flat(plain_ad(s, dt, cc))
        torch.cuda.synchronize()
        label = f"[ad-kernel-vs-plain {tag} {name} lregcl={int(lreg)} {ncols}x{NLEV} seed {seed}]"
        ad_err[(tag, name, lreg, ncols)] = compare_ad(got, want, dtype, label)
        fused_checks(torch, adk, s, dt, cc, got, label)
        if tag == "f32" and ((name == "default" and lreg and ncols in (SMALL, RAGGED)) or seed == 3):
            # which f32 side carries the detrainment cotangents' spread
            s64 = {k: v.double() for k, v in s.items()}
            ref = flat(plain_ad(s64, dt, cc))
            kern, pl = ({n: float(f"{e[0]:.3e}") for n, e in ad_errors(
                {n: side[n].cpu().numpy() for n in AD_F32_SPREAD_WIDE},
                {n: ref[n].cpu().numpy() for n in AD_F32_SPREAD_WIDE}, dtype, AD_F32_SPREAD_WIDE).items()}
                for side in (got, want))
            print(f"  {label} against the f64 plain AD on the same inputs (a reading): kernel "
                  f"{kern}, plain f32 AD {pl} of the scale")
        del s, got, want
    # zero seeds give exactly zero cotangents
    c0 = configs["levapls2"]
    _, s, dt = ad_state(torch, SMALL, torch.float32, c0, seed=1)
    for n in adk.AD_SEEDS:
        s[n] = torch.zeros_like(s[n])
    for fn in (adk.cloudsc2_ad_cuda, adk.cloudsc2_ad_fused_cuda):
        tends, diags = fn(s, dt, c0)
        nonzero = [k for k, v in {**tends, **diags}.items() if k.endswith("_i") and v.abs().max().item() != 0.0]
        if nonzero:
            raise AssertionError(f"[ad-kernel] {fn.__name__}: zero seeds gave nonzero cotangents in {nonzero}")
        print(f"  [ad-kernel] {fn.__name__}: zero seeds give every cotangent exactly 0")
    print(f"[ad-kernel-vs-plain] {time.perf_counter() - t0:.1f} s; {card}")
    return ad_err


def symmetry_gates(torch, nlk, tlk, adk, card):
    """Phase 9: the symmetry protocol through the driver on the card.
    Returns the launches of the phase by kernel."""
    from cloudsc2_tpu_torch.config import Config, TorchConfig
    from drivers.run_nonlinear_torch import synthetic_input
    from drivers.run_symmetry_test_torch import core

    cases = [  # (precision, columns, gate)
        ("double", 100, True),
        ("double", BIG, True),
        ("single", SMALL, True),
        ("single", BIG, False),
    ]
    for fn in (nlk.cloudsc2_nl_cuda, tlk.cloudsc2_tl_cuda, adk.cloudsc2_ad_cuda):
        fn.launches = 0
    for precision, ncols, gate in cases:
        t0 = time.perf_counter()
        rc, err = core(
            Config(precision=precision, num_cols=ncols, num_runs=1),
            TorchConfig(device="cuda:0", precision=precision),
            inputs=synthetic_input(ncols, precision),
        )
        label = f"[symmetry {precision} {ncols} columns]"
        print(f"{label} exit {rc}, error {err:.6e} machine epsilons ({'gate' if gate else 'reading'}; "
              f"{time.perf_counter() - t0:.1f} s host clock; {card})")
        if gate and rc != 0:
            raise AssertionError(f"{label} failed: the symmetry verdict is not HOORAY")
    launches = {
        "cloudsc2_nl_cuda": nlk.cloudsc2_nl_cuda.launches,
        "cloudsc2_tl_cuda": tlk.cloudsc2_tl_cuda.launches,
        "cloudsc2_ad_cuda": adk.cloudsc2_ad_cuda.launches,
    }
    print(f"[symmetry] launches in this phase: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError("the symmetry path did not launch all three CUDA kernels")
    return launches


def fused_symmetry_gates(torch, adk, card, cases=(("double", BIG, "", {}), ("single", SMALL, "", {}))):
    """Phase 9, second part: the symmetry protocol through the fused AD
    kernel, rolled and resident, and through the ``cotangent_only`` AD, as
    ``SymmetryTest.run`` assembles it (saturation, the increment with
    supsat zeroed, y = M x through the TL kernel, the TL outputs as seeds,
    x* = M* y), by default double at 65,536 columns and single at 4096
    (``cases``: precision, columns, form, constants change); each must
    print HOORAY.  Returns the fused kernel's launches in the phase (all,
    non-exact divide, CUADJ_COMPACT=False)."""
    from cloudsc2_tpu_torch import dispatch
    from cloudsc2_tpu_torch.components import EtaLevels
    from cloudsc2_tpu_torch.physics.increment import state_increment
    from cloudsc2_tpu_torch.physics.saturation import saturation
    from cloudsc2_tpu_torch.state import state_from_numpy
    from cloudsc2_tpu_torch.validation.symmetry import DIAG_NAMES, TEND_NAMES, SymmetryTest
    from drivers.run_nonlinear_torch import synthetic_input

    reset_counts(adk.cloudsc2_ad_fused_cuda)
    for precision, ncols, form_label, change in cases:
        t0 = time.perf_counter()
        grid, state_np, dt, c = synthetic_input(ncols, precision)
        c = c.replace(**change)
        s = state_from_numpy(state_np, torch.device("cuda:0"), torch.float64 if precision == "double"
                             else torch.float32)
        s.update(EtaLevels(grid, c)(s))
        st = SymmetryTest(constants=c)
        s["qsat"] = saturation(s["ap"], s["t"], kflag=st.kflag, lphylin=st.lphylin, c=c)
        incr = state_increment(s, st.factor, ignore_supsat=True)
        s.update(incr)
        tends, diags = dispatch.cloudsc2_tl(s, dt, c)
        norm1 = st.get_norm1(tends, diags).cpu().numpy()
        for n in TEND_NAMES:
            s["tnd_" + n] = tends[n]
            s["tnd_" + n + "_i"] = tends[n + "_i"]
        for n in DIAG_NAMES:
            s[n + "_i"] = diags[n + "_i"]
        del tends, diags
        for resident in (False, True):
            occ = fused_plan_reading(adk, s["ap"].dtype, c, resident, ncols)
            print(f"  [symmetry fused {'resident' if resident else 'rolled'} {form_label + ' ' if form_label else ''}"
                  f"{precision} {ncols} columns] {fused_plan_text(occ)}")
        for form, ad in (
            ("fused rolled", lambda: dispatch.cloudsc2_ad_fused(s, dt, c)),
            ("fused resident", lambda: dispatch.cloudsc2_ad_fused(s, dt, c, resident=True)),
            ("cotangent_only", lambda: dispatch.cloudsc2_ad(s, dt, c, cotangent_only=True)),
        ):
            tends_ad, diags_ad = ad()
            norm2 = st.get_norm2(incr, tends_ad, diags_ad).cpu().numpy()
            del tends_ad, diags_ad
            err = st.validate(norm1, norm2, verbose=False)
            label = f"[symmetry {form} {form_label + ' ' if form_label else ''}{precision} {ncols} columns]"
            print(f"{label} error {err:.6e} machine epsilons: {'HOORAY' if err < 1e4 else 'failed'} "
                  f"(gate; {time.perf_counter() - t0:.1f} s host clock so far; {card})")
            if not err < 1e4:
                raise AssertionError(f"{label} failed: the symmetry verdict is not HOORAY")
        del s, incr
        torch.cuda.empty_cache()
    f = adk.cloudsc2_ad_fused_cuda
    launches = (f.launches, f.fast_div_launches, f.ref_launches)
    print(f"[symmetry] fused-kernel launches in this phase (all, non-exact divide, CUADJ_COMPACT=False): "
          f"cloudsc2_ad_fused_cuda {launches}")
    if launches[0] == 0:
        raise AssertionError("the fused symmetry path did not launch the fused kernel")
    return launches


#: this slice's forms: (label, constants change); the divide modes run in f32
DIV_FORMS = (("faithful", {"FAST_DIV": "faithful"}), ("approx", {"FAST_DIV": "approx"}))
REF_FORM = ("CUADJ_COMPACT=False", {"CUADJ_COMPACT": False})


def reset_counts(*fns):
    """Set every launch count of the wrappers ``fns`` to 0, the NL's
    ``wide_launches`` among them."""
    for fn in fns:
        fn.launches = fn.fast_div_launches = fn.ref_launches = 0
        if hasattr(fn, "wide_launches"):
            fn.wide_launches = 0


def report_divide(torch, got, want, exact, form, label):
    """Hold a non-exact divide's outputs ``got`` against the plain exact
    version ``want`` at ``div_gate(field, form)`` per field in units of its
    largest magnitude, and require them not bitwise the exact kernel's
    ``exact``; print the reading.  Returns ``(worst scaled, worst abs)``."""
    from cloudsc2_tpu_torch.utils.compare import DIV_GATES, div_gate

    errs = scaled_errors(got, want)
    max_abs = max(float((got[k].double() - want[k].double()).abs().max()) for k in want)
    share = {k: v / div_gate(k, form) for k, v in errs.items()}
    worst = max(share, key=share.get)
    moved = sorted(k for k in exact if not torch.equal(got[k], exact[k]))
    top = dict(sorted(errs.items(), key=lambda kv: -kv[1])[:6])
    print(f"  {label} worst {worst} {errs[worst]:.3e} of its scale ({share[worst]:.3f} of its gate; gates "
          f"{DIV_GATES[form]}); max abs {max_abs:.3e}; largest fields "
          f"{{{', '.join(f'{k}: {v:.2e}' for k, v in top.items())}}}; {len(moved)} of {len(exact)} fields "
          f"not bitwise the exact kernel's")
    if not share[worst] <= 1.0:
        raise AssertionError(f"{label}: {worst} {errs[worst]:.3e} of its scale, above its gate")
    if not moved:
        raise AssertionError(f"{label}: bitwise the exact kernel; the divide mode did not act")
    return max(errs.values()), max_abs


def tl_form_checks(torch, tlk, plain_tl, configs, card):
    """Phase 4, this slice's forms of the TL kernel: under faithful and
    approx (f32; the three configurations at 4096 and the default at 65,536)
    against the plain exact TL at ``div_gate(field, "tl")``, not bitwise the
    exact kernel, ``tangent_only`` bitwise the full launch; f64 with
    FAST_DIV set bitwise the exact kernel; with ``CUADJ_COMPACT=False``
    (f64 and f32, the same shapes) against the plain TL of that form at the
    TL tolerances.  Returns the worst errors by ``(form, dtype tag,
    configuration, columns)``."""
    c0 = configs["default"]
    cases = [(name, c, SMALL) for name, c in configs.items()] + [("default", c0, BIG)]
    out = {}
    t0 = time.perf_counter()
    for name, c, ncols in cases:
        _, s, dt = make_state(torch, ncols, torch.float32, c, seed=1, increment=True)
        want = flat(plain_tl(s, dt, c))
        exact = flat(tlk.cloudsc2_tl_cuda(s, dt, c))
        for mode, change in DIV_FORMS:
            cm = c.replace(**change)
            got = flat(tlk.cloudsc2_tl_cuda(s, dt, cm))
            only = flat(tlk.cloudsc2_tl_cuda(s, dt, cm, tangent_only=True))
            torch.cuda.synchronize()
            label = f"[tl-{mode}-vs-plain-exact f32 {name} {ncols}x{NLEV}]"
            out[(mode, "f32", name, ncols)] = report_divide(torch, got, want, exact, "tl", label)
            assert_bitwise(torch, only, {k: v for k, v in got.items() if k.endswith("_i")},
                           f"{label} tangent_only against the full launch")
            del got, only
        del s, want, exact
    for name in ("default", "levapls2"):
        c = configs[name]
        _, s, dt = make_state(torch, SMALL, torch.float64, c, seed=1, increment=True)
        exact = flat(tlk.cloudsc2_tl_cuda(s, dt, c))
        for mode, change in DIV_FORMS:
            assert_bitwise(torch, flat(tlk.cloudsc2_tl_cuda(s, dt, c.replace(**change))), exact,
                           f"[tl f64 FAST_DIV={mode} {name}] against the exact kernel")
        print(f"  [tl f64 FAST_DIV {name} {SMALL}x{NLEV}] faithful and approx: every field bitwise the exact "
              f"kernel's; tangent_only bitwise the full launch in every f32 case above")
        del s, exact
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, c, ncols in cases:
            cr = c.replace(**REF_FORM[1])
            _, s, dt = make_state(torch, ncols, dtype, cr, seed=1, increment=True)
            got = flat(tlk.cloudsc2_tl_cuda(s, dt, cr))
            want = flat(plain_tl(s, dt, cr))
            torch.cuda.synchronize()
            label = f"[tl-kernel-vs-plain CUADJ_COMPACT=False {tag} {name} {ncols}x{NLEV}]"
            out[("ref", tag, name, ncols)] = compare(got, want, tl_tolerances(torch, dtype, cr), label)
            del s, got, want
    print(f"[tl-forms] {time.perf_counter() - t0:.1f} s; {card}")
    return out


def nl_compact_checks(torch, nlk, plain_nl, configs, card):
    """Phase 3, the NL kernel with ``CUADJ_COMPACT=False``: against the plain
    NL of that form (f64 and f32; the three configurations at 4096 and the
    default at 65,536) at the NL tolerances; at the default and 4096 x 137
    its fused form bitwise ``Saturation`` + the unfused kernel, its
    trajectory forms (``compare_trajectory``), and its faithful and approx
    f32 forms, fused and unfused, against the plain exact NL of that form at
    ``div_gate``.  Returns the worst errors by ``(form, dtype tag,
    configuration, columns)``."""
    from cloudsc2_tpu_torch.physics.saturation import saturation

    c0 = configs["default"]
    cases = [(name, c, SMALL) for name, c in configs.items()] + [("default", c0, BIG)]
    out = {}
    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, c, ncols in cases:
            cr = c.replace(**REF_FORM[1])
            _, s, dt = make_state(torch, ncols, dtype, cr, seed=1)
            got = flat(nlk.cloudsc2_nl_cuda(s, dt, cr))
            want = flat(plain_nl(s, dt, cr))
            torch.cuda.synchronize()
            label = f"[nl-kernel-vs-plain CUADJ_COMPACT=False {tag} {name} {ncols}x{NLEV}]"
            out[("ref", tag, name, ncols)] = compare(got, want, tolerances(torch, dtype, cr), label)
            if name == "default" and ncols == SMALL:
                bare = {k: v for k, v in s.items() if k != "qsat"}
                fused = flat(nlk.cloudsc2_nl_cuda(bare, dt, cr, fuse_saturation=True))
                assert_bitwise(torch, fused, {**got, "qsat": saturation(s["ap"], s["t"], c=cr)},
                               f"{label} fused against Saturation + the unfused kernel")
                print(f"  {label} fused: every field bitwise Saturation + the unfused kernel")
                compare_trajectory(torch, nlk, plain_nl, s, dt, cr, f"{label} trajectory")
                if dtype == torch.float32:
                    for fused_form in (False, True):
                        x = bare if fused_form else s
                        w = flat(plain_nl(x, dt, cr, fuse_saturation=fused_form))
                        e = flat(nlk.cloudsc2_nl_cuda(x, dt, cr, fuse_saturation=fused_form))
                        form = "fused" if fused_form else "unfused"
                        for mode, change in DIV_FORMS:
                            g = flat(nlk.cloudsc2_nl_cuda(x, dt, cr.replace(**change), fuse_saturation=fused_form))
                            out[(mode, tag, name, form)] = report_divide(
                                torch, g, w, e, form, f"[nl-{mode}-vs-plain-exact CUADJ_COMPACT=False f32 "
                                                      f"{name} {form} {ncols}x{NLEV}]")
                del bare, fused
            del s, got, want
    print(f"[nl-compact] {time.perf_counter() - t0:.1f} s; {card}")
    return out


def ad_form_checks(torch, adk, nlk, plain_ad, configs, card):
    """Phase 6, this slice's forms of the AD kernels.  ``LPHYLIN=False``
    (f64 and f32, the three configurations at 4096, on the state whose qsat
    ``Saturation(lphylin=False)`` made): the two-kernel AD, its
    ``cotangent_only`` form, the fused kernel rolled and resident and the
    ``Cloudsc2AD`` component on CUDA tensors run the kernels and are bitwise
    the ``LPHYLIN=True`` launch on the same state, and within ``ad_limit``
    of the plain AD under ``LPHYLIN=False``.  The divide modes (f32; the
    three configurations at 4096, the default at 65,536): the two-kernel AD
    against the plain exact AD at ``div_gate(field, "ad")`` and not bitwise
    the exact kernels; the fused kernel, rolled and resident, and
    ``cotangent_only`` bitwise the two-kernel AD in the same mode; f64 with
    FAST_DIV set bitwise the exact kernels.  ``CUADJ_COMPACT=False`` (f64
    and f32, the same shapes): against the plain AD of that form at
    ``ad_limit``, the fused kernel and ``cotangent_only`` bitwise.  Returns
    the worst errors by ``(form, dtype tag, configuration, columns)``."""
    from cloudsc2_tpu_torch.components import Cloudsc2AD

    c0 = configs["default"]
    out = {}
    t0 = time.perf_counter()
    counted = (nlk.cloudsc2_nl_cuda, adk.cloudsc2_ad_cuda, adk.cloudsc2_ad_fused_cuda)
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, c in configs.items():
            off = c.replace(LPHYLIN=False)
            grid, s, dt = ad_state(torch, SMALL, dtype, off, seed=1)
            on = flat(adk.cloudsc2_ad_cuda(s, dt, c))
            label = f"[ad LPHYLIN=False {tag} {name} {SMALL}x{NLEV}]"
            reset_counts(*counted)
            runs = {
                "two-kernel AD": flat(adk.cloudsc2_ad_cuda(s, dt, off)),
                "Cloudsc2AD": flat(Cloudsc2AD(grid, off)(s, dt)),
                "fused rolled": flat(adk.cloudsc2_ad_fused_cuda(s, dt, off)),
                "fused resident": flat(adk.cloudsc2_ad_fused_cuda(s, dt, off, resident=True)),
            }
            only = flat(adk.cloudsc2_ad_cuda(s, dt, off, cotangent_only=True))
            torch.cuda.synchronize()
            counts = tuple(fn.launches for fn in counted)
            if min(counts) == 0:
                raise AssertionError(f"{label}: launches (NL, AD, fused) {counts}; a kernel did not run")
            for form, got in runs.items():
                assert_bitwise(torch, got, on, f"{label} {form} against the LPHYLIN=True launch")
            assert_bitwise(torch, only, {k: v for k, v in on.items() if k.endswith("_i")},
                           f"{label} cotangent_only against the LPHYLIN=True launch")
            print(f"  {label} two-kernel AD, Cloudsc2AD, fused rolled and resident: every field bitwise the "
                  f"LPHYLIN=True launch, cotangent_only its cotangents; launches (NL, AD, fused) {counts}")
            out[("lphylin=False", tag, name, SMALL)] = compare_ad(
                runs["two-kernel AD"], flat(plain_ad(s, dt, off)), dtype, f"{label} against the plain AD")
            del s, on, runs, only
    cases = [(name, c, SMALL) for name, c in configs.items()] + [("default", c0, BIG)]
    for name, c, ncols in cases:
        _, s, dt = ad_state(torch, ncols, torch.float32, c, seed=1)
        want = flat(plain_ad(s, dt, c))
        exact = flat(adk.cloudsc2_ad_cuda(s, dt, c))
        for mode, change in DIV_FORMS:
            cm = c.replace(**change)
            got = flat(adk.cloudsc2_ad_cuda(s, dt, cm))
            torch.cuda.synchronize()
            label = f"[ad-{mode}-vs-plain-exact f32 {name} {ncols}x{NLEV}]"
            out[(mode, "f32", name, ncols)] = report_divide(torch, got, want, exact, "ad", label)
            fused_checks(torch, adk, s, dt, cm, got, label)
            del got
        del s, want, exact
    for name in ("default", "levapls2"):
        c = configs[name]
        _, s, dt = ad_state(torch, SMALL, torch.float64, c, seed=1)
        exact = flat(adk.cloudsc2_ad_cuda(s, dt, c))
        for mode, change in DIV_FORMS:
            cm = c.replace(**change)
            assert_bitwise(torch, flat(adk.cloudsc2_ad_cuda(s, dt, cm)), exact,
                           f"[ad f64 FAST_DIV={mode} {name}] against the exact kernels")
            assert_bitwise(torch, flat(adk.cloudsc2_ad_fused_cuda(s, dt, cm)), exact,
                           f"[ad f64 FAST_DIV={mode} {name} fused] against the exact kernels")
        print(f"  [ad f64 FAST_DIV {name} {SMALL}x{NLEV}] faithful and approx, two-kernel and fused: every field "
              f"bitwise the exact kernels'")
        del s, exact
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for name, c, ncols in cases:
            cr = c.replace(**REF_FORM[1])
            _, s, dt = ad_state(torch, ncols, dtype, cr, seed=1)
            got = flat(adk.cloudsc2_ad_cuda(s, dt, cr))
            want = flat(plain_ad(s, dt, cr))
            torch.cuda.synchronize()
            label = f"[ad-kernel-vs-plain CUADJ_COMPACT=False {tag} {name} {ncols}x{NLEV}]"
            out[("ref", tag, name, ncols)] = compare_ad(got, want, dtype, label)
            fused_checks(torch, adk, s, dt, cr, got, label)
            del s, got, want
    print(f"[ad-forms] {time.perf_counter() - t0:.1f} s; {card}")
    return out


def form_protocol_gates(torch, nlk, tlk, adk, card):
    """Phases 8 and 9 for this slice's forms, through the drivers at 65,536
    x 137: the symmetry protocol under LPHYLIN=False (double, single), the
    faithful and approx divides (single) and CUADJ_COMPACT=False (double,
    single); the Taylor protocol under faithful (single, column 0 tiled,
    the f32 floors) and CUADJ_COMPACT=False (double, per column): each must
    print HOORAY.  The Taylor protocol under approx (single, per column, the
    f32 floors) is a reading: the JAX package sets no gate there, and the
    hardware reciprocal is not the function whose derivative the TL takes.
    Each path is driven with the counts at 0 and read after: its kernels
    must have launched in its form.  Returns the launches by path."""
    from cloudsc2_tpu_torch.config import Config, TorchConfig
    from cloudsc2_tpu_torch.validation.taylor import FLOORS_PER_COLUMN
    from drivers.run_nonlinear_torch import synthetic_input
    from drivers.run_symmetry_test_torch import core as symmetry
    from drivers.run_taylor_test_torch import core as taylor

    counted = (nlk.cloudsc2_nl_cuda, tlk.cloudsc2_tl_cuda, adk.cloudsc2_ad_cuda)
    cases = [  # (protocol, precision, form, constants change, options, gate)
        ("symmetry", "double", "LPHYLIN=False", {"LPHYLIN": False}, {}, True),
        ("symmetry", "single", "LPHYLIN=False", {"LPHYLIN": False}, {}, True),
        ("symmetry", "single", "faithful", {"FAST_DIV": "faithful"}, {}, True),
        ("symmetry", "single", "approx", {"FAST_DIV": "approx"}, {}, True),
        ("symmetry", "double", "CUADJ_COMPACT=False", {"CUADJ_COMPACT": False}, {}, True),
        ("symmetry", "single", "CUADJ_COMPACT=False", {"CUADJ_COMPACT": False}, {}, True),
        ("taylor", "single", "faithful", {"FAST_DIV": "faithful"}, {"tile_column": True, "floors": "auto"}, True),
        ("taylor", "double", "CUADJ_COMPACT=False", {"CUADJ_COMPACT": False}, {"per_column": True}, True),
        ("taylor", "single", "approx", {"FAST_DIV": "approx"}, {"per_column": True, "floors": "auto"}, False),
    ]
    launches = {}
    for protocol, precision, form, change, opts, gate in cases:
        grid, st, dt, c = synthetic_input(BIG, precision)
        inputs = (grid, st, dt, c.replace(**change))
        reset_counts(*counted)
        t0 = time.perf_counter()
        tconfig = TorchConfig(device="cuda:0", precision=precision)
        config = Config(precision=precision, num_cols=BIG, num_runs=1)
        label = f"[{protocol} {form} {precision} {BIG} columns{''.join(' ' + k for k in sorted(opts))}]"
        extra = ""
        if protocol == "symmetry":
            rc, err = symmetry(config, tconfig, inputs=inputs)
            extra = f", error {err:.6e} machine epsilons"
        else:
            rc, tt = taylor(config, tconfig, inputs=inputs, **opts)
            if opts.get("per_column"):
                mode = "f32" if precision == "single" else "f64"
                pen = tt.column_penalties(tt.norms, *FLOORS_PER_COLUMN[mode])
                strict = tt.column_penalties(tt.norms, *FLOORS_PER_COLUMN[mode], strict=True)
                extra = (f"; pass fraction {int((pen <= 5).sum())}/{BIG} = {float((pen <= 5).mean()):.4f}, "
                         f"strict fraction {int((strict <= 5).sum())}/{BIG} = {float((strict <= 5).mean()):.4f}")
        counts = {fn.__name__: (fn.launches, fn.fast_div_launches, fn.ref_launches) for fn in counted}
        print(f"{label} exit {rc}{extra} ({'gate' if gate else 'reading'}; {time.perf_counter() - t0:.1f} s host "
              f"clock); launches (all, non-exact divide, CUADJ_COMPACT=False): {counts}; {card}")
        if gate and rc != 0:
            raise AssertionError(f"{label} failed: the verdict is not HOORAY")
        used = [tlk.cloudsc2_tl_cuda] + ([adk.cloudsc2_ad_cuda] if protocol == "symmetry" else
                                         [nlk.cloudsc2_nl_cuda])
        slot = 1 if "FAST_DIV" in change else 2 if "CUADJ_COMPACT" in change else 0
        missing = [fn.__name__ for fn in used if counts[fn.__name__][slot] == 0]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched in the form {form}")
        launches[(protocol, precision, form)] = counts
    return launches


def form_timing(torch, nlk, tlk, adk, build, c0, card):
    """Phase 10, this slice's forms at 65,536 x 137 with CUDA events (batches
    of KERNEL_BATCH calls, median of 10; the fused AD median of 3): the NL
    kernel (unfused), the TL kernel, the two-kernel AD (forward + reverse,
    the reverse also alone) and the fused AD rolled, under faithful and
    approx (f32) and with CUADJ_COMPACT=False (f32 and f64), each beside the
    default form (exact, compact) timed the same way in the same loop (the
    times of ``time_kernel`` alternate with the plain version's runs and
    read higher, so they are not set beside these); each form's
    bound is its function's, the same bytes as the exact compact form; the
    reverse and fused kernels' registers and local bytes (the card's) and
    ptxas's spills, and the fused kernel's block, rolled and resident, held
    to the plan.  Returns
    ``{(tag, form): {kernel: ms}}``."""
    from cloudsc2_tpu_torch.kernels.nonlinear import div_switch

    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        forms = (("default", {}),) + (DIV_FORMS if dtype == torch.float32 else ()) + (REF_FORM,)
        for form, change in forms:
            c = c0.replace(**change)
            _, s, dt = make_state(torch, BIG, dtype, c, seed=2, increment=True)
            res = {"nl": kernel_ms(torch, lambda: nlk.cloudsc2_nl_cuda(s, dt, c), 10)[0],
                   "tl": kernel_ms(torch, lambda: tlk.cloudsc2_tl_cuda(s, dt, c), 10)[0]}
            del s
            _, s, dt = ad_state(torch, BIG, dtype, c, seed=2)
            traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)[2]
            res["ad"] = kernel_ms(torch, lambda: adk.cloudsc2_ad_cuda(s, dt, c), 10)[0]
            res["reverse"] = kernel_ms(torch, lambda: adk.cloudsc2_ad_reverse_cuda(s, traj, dt, c), 10)[0]
            res["fused rolled"] = kernel_ms(torch, lambda: adk.cloudsc2_ad_fused_cuda(s, dt, c), 3)[0]
            div = div_switch(c, dtype)
            suffix, _ = build.form(bool(c.CUADJ_COMPACT), div != 0)
            rev = kernel_usage(build, adk, c, dtype, "cloudsc2_ad" + suffix, "reverse", reverse_entry(tag, div))
            # fused_occupancy raises where the card's blocks per SM are not
            # the plan's at its registers
            fus = kernel_usage(build, adk, c, dtype, "cloudsc2_ad_fused" + suffix, "fused rolled",
                               fused_entry(tag, False, div))
            occ = adk.fused_occupancy(dtype, c, True, NLEV)
            res["reverse registers"], res["fused registers"] = rev, fus
            print(f"[form-timing {tag} {BIG}x{NLEV} {form}] NL kernel {res['nl']:.4f} ms, TL kernel "
                  f"{res['tl']:.4f} ms, two-kernel AD {res['ad']:.4f} ms (reverse alone {res['reverse']:.4f}), "
                  f"fused AD rolled {res['fused rolled']:.4f} ms (CUDA events); reverse kernel {rev['registers']} "
                  f"registers, {rev['local_bytes']} B local, ptxas spills {rev['spill_stores']}/"
                  f"{rev['spill_loads']} B, {rev['blocks_per_sm']} blocks of 128 per SM, ring {rev['depth']} x "
                  f"{rev['shared_bytes']} B shared; "
                  f"fused {fus['registers']} registers, {fus['block']} x {fus['blocks_per_sm']} = "
                  f"{fus['threads_per_sm']} threads per SM, resident {occ['registers']} registers, "
                  f"{occ['threads_per_sm']} threads per SM (each the plan's at its registers); {card}")
            if form != "default":
                base = out[(tag, "default")]
                print(f"  [form-timing {tag} {form}] against the default form: "
                      + ", ".join(f"{k} {res[k] / base[k]:.3f}" for k in ("nl", "tl", "ad", "reverse", "fused rolled")))
            out[(tag, form)] = res
            del s, traj
            torch.cuda.empty_cache()
    return out


#: the card's peak rates (H100 SXM data sheet, at 700 W): HBM, and
#: arithmetic outside the tensor cores by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
#: flops per column-level: the NL step (the census value of
#: cloudsc2_tpu_torch.utils.output.FLOPS_PER_POINT), the TL step (the count
#: in tangent_linear.cu's note)
NL_FLOPS, TL_FLOPS = 360, 700


def bound(nbytes, flops, tag):
    """``(bound ms, bound_by)``: the larger of the byte time at the HBM rate
    and the operation time at the peak rate for the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[tag] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: flops per column-level of the AD step: the NL forward, then one NL
#: level and one transposed TL level in reverse
AD_FLOPS = NL_FLOPS + NL_FLOPS + TL_FLOPS
#: flops per column-level of the hand-transposed reverse level, without and
#: with evaporation: the hand count in the note at the top of ad_level.h,
#: not measured; printed beside the measured times as a reading only
AD_LEVEL_FLOPS = (700, 860)
def fused_entry(tag, resident, div=0):
    """The mangled-name key in ptxas's log of the fused kernel's
    instantiation without evaporation, with LREGCL: its reverse body's
    switches and divide, its type, the forward sweep's ring (f32 3 slots
    in shared memory, f64 2 in registers), its block of 128 and the blocks
    an SM its launch bounds ask for (``ad_fused.cu`` ``min_blocks``: f64
    2, f32 4 under the exact divide, else 3)."""
    t = "f" if tag == "f32" else "d"
    ring = "Li3ELb1E" if tag == "f32" else "Li2ELb0E"
    blocks = 2 if tag == "f64" else 4 if div == 0 else 3
    return f"ADFusedRevI{t}Lb0ELb1ELb{int(resident)}ELi{div}EEE{t}{ring}Li128ELi{blocks}E"


def reverse_entry(tag, div=0, evap=False):
    """The mangled-name key in ptxas's log of the reverse kernel's
    instantiation with LREGCL: its pipelined body's type, switches and
    divide."""
    return f"ADPipeBodyI{'f' if tag == 'f32' else 'd'}Lb{int(evap)}ELb1ELi{div}E"


#: the mangled-name keys of each AD kernel's default instantiation (f32 /
#: f64, no evaporation, LREGCL) in ptxas's log, by library and form
AD_ENTRIES = {
    ("cloudsc2_ad", "reverse"): (reverse_entry("f32"), reverse_entry("f64")),
    ("cloudsc2_ad_fused", "fused rolled"): (fused_entry("f32", False), fused_entry("f64", False)),
    ("cloudsc2_ad_fused", "fused resident"): (fused_entry("f32", True), fused_entry("f64", True)),
}


def ptxas_usage(build, lib, key):
    """``(registers, spill store bytes, spill load bytes)`` that ptxas
    reported for the entry of library ``lib`` whose mangled name holds
    ``key``, from this process's build log (None where this process did not
    build the library); raises where the log has no such entry (a renamed
    or re-bounded instantiation)."""
    import re

    entry, regs, spills = "", None, (None, None)
    for line in build.logs.get(lib, "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif key in entry:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m[1]), int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs = int(m[1])
    if lib in build.logs and regs is None:
        raise AssertionError(f"{lib}: no entry whose name holds {key} in ptxas's log")
    return (regs, *spills)


def kernel_usage(build, adk, c, dtype, lib, form, key):
    """Registers and local bytes a thread of an AD kernel as the card
    reports them (``cudaFuncGetAttributes``; the fused kernel's at the
    block the card picks, with that plan), and the spill bytes ptxas
    reported where this process built the library (None where not); raises
    where ptxas's registers differ from the card's.  The reverse kernel's
    reading also has its blocks per SM, ring depth and shared bytes."""
    if form == "reverse":
        # reverse_occupancy raises where the card's blocks per SM or shared
        # bytes are not the plan's at its registers and ring depth
        usage = dict(adk.reverse_occupancy(dtype, c))
    else:
        usage = dict(adk.fused_occupancy(dtype, c, form == "fused resident", NLEV))
    regs, usage["spill_stores"], usage["spill_loads"] = ptxas_usage(build, lib, key)
    if regs is not None and regs != usage["registers"]:
        raise AssertionError(f"{lib} {form}: ptxas reported {regs} registers, the card {usage['registers']}")
    return usage


def kernel_ms(torch, fn, runs):
    """``(ms per call, wrapper host ms per call, runs)``: medians over
    ``runs`` batches of KERNEL_BATCH back-to-back calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    k_ms, h_ms = [], []
    for _ in range(runs):
        k_ms.append(time_ms(torch, fn, KERNEL_BATCH) / KERNEL_BATCH)
        h_ms.append(host_ms(torch, fn, KERNEL_BATCH))
    return statistics.median(k_ms), statistics.median(h_ms), k_ms


def nl_occupancy(torch, nlk, c0, card):
    """Phase 10, what the card makes of each NL instantiation the phase
    times (``kernels.nonlinear.occupancy``: registers and local bytes a
    thread, blocks of 128 per SM, the ring's depth and shared bytes a
    block) at a launch of BIG and of WIDE columns, printed with the launches
    since the counts were last set to 0 whose shared-memory carveout was
    sized for more than 4 blocks;
    raises where fewer than 4 blocks fit an SM, which 65,536 columns need
    to run in one wave (512 blocks on 132 SMs), or where a float32 launch
    of BIG columns sizes its carveout for other than 4.  Returns
    ``{"<f32|f64> <form>": reading at BIG, with "blocks_per_sm_wide" and
    "carveout_blocks_wide" at WIDE}``."""
    fused, traj = {"fuse_saturation": True}, {"with_trajectory": True}
    forms = [("unfused", c0, {}), ("fused", c0, fused), ("with trajectory", c0, traj),
             ("traj_only", c0, dict(traj, traj_only=True))]
    forms += [(f"unfused {f}", c0.replace(**change), {}) for f, change in DIV_FORMS + (REF_FORM,)]
    forms += [(f"fused {f}", c0.replace(**change), fused) for f, change in DIV_FORMS]
    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        for form, c, opts in forms:
            if dtype == torch.float64 and c.FAST_DIV != "exact":
                continue
            o = dict(nlk.occupancy(dtype, c, ncols=BIG, **opts))
            wide = nlk.occupancy(dtype, c, ncols=WIDE, **opts)
            o["blocks_per_sm_wide"], o["carveout_blocks_wide"] = wide["blocks_per_sm"], wide["carveout_blocks"]
            out[f"{tag} {form}"] = o
            print(f"  [nl-occupancy {tag} {form}] {o['registers']} registers and {o['local_bytes']} B local memory "
                  f"a thread, blocks of 128 per SM {o['blocks_per_sm']} at {BIG:,} columns (carveout for "
                  f"{o['carveout_blocks']}) and {o['blocks_per_sm_wide']} at {WIDE:,} (carveout for "
                  f"{o['carveout_blocks_wide']}; 0: none asked), ring depth {o['depth']} levels, "
                  f"{o['shared_bytes']} B shared memory a block; {card}")
            if o["blocks_per_sm"] < 4 or (dtype == torch.float32 and o["carveout_blocks"] != 4):
                raise AssertionError(f"[nl-occupancy {tag} {form}] {o['blocks_per_sm']} blocks of 128 per SM, "
                                     f"carveout for {o['carveout_blocks']}: 65,536 columns no longer run in one "
                                     f"wave of 4")
    print(f"  [nl-occupancy] NL launches since the counts were last set to 0 whose carveout was sized for more "
          f"than 4 blocks an SM: "
          f"{nlk.cloudsc2_nl_cuda.wide_launches} of {nlk.cloudsc2_nl_cuda.launches}; {card}")
    return out


def ad_timing(torch, nlk, adk, build, plain_ad, plain_nl, c, card):
    """Phase 10, the AD at 65,536 x 137, f32 and f64: the two-kernel AD,
    the fused kernel (rolled and resident) and the trajectory held against
    their plain versions at this shape, the plain AD timed; then timed with
    CUDA events: the two-kernel AD's forward and reverse kernels apart, the
    ``cotangent_only`` step and its ``traj_only`` forward, and the fused
    kernel rolled and resident at the block the card picks (block, blocks
    and threads per SM, shared memory), which must be :func:`fused_plan`'s
    at this shape; each AD kernel's registers and local bytes a thread (the
    card's) and the spills ptxas reported.

    Each bound is that of the function the call computes: the bytes of its
    inputs read once and of its outputs written once, against its
    operations (one NL level forward; one NL and one transposed TL level in
    reverse).  The bytes this code moves (the tropopause pass's second read,
    the trajectory's round trip, the rolled fused kernel's second read of
    the raw fields, the fused kernel's stack: a write and a read of each
    of its values, 2-3 a level rolled, 12-13 resident) give the design's
    GB/s, and the operations of the hand-transposed reverse level by its
    hand count (``AD_LEVEL_FLOPS``, not measured) are printed beside them
    as a reading."""
    from cloudsc2_tpu_torch.physics.nonlinear import trajectory_names

    out = {}
    ntraj = len(trajectory_names(c))
    evap = int(bool(c.LEVAPLS2 or c.LDRAIN1D))
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        item = 8 if dtype == torch.float64 else 4
        res = {}
        _, s, dt = ad_state(torch, BIG, dtype, c, seed=2)
        res["traj_abs"] = compare_trajectory(
            torch, nlk, plain_nl, s, dt, c, f"[nl-trajectory {tag} default {BIG}x{NLEV}]")
        # the plain AD, once for the comparison (its autograd tape's peak
        # read), then timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = flat(plain_ad(s, dt, c))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        got = flat(adk.cloudsc2_ad_cuda(s, dt, c))
        label = f"[ad-kernel-vs-plain {tag} default lregcl=1 {BIG}x{NLEV}]"
        res["err"] = compare_ad(got, want, dtype, label)
        fused_checks(torch, adk, s, dt, c, got, label)
        del got, want
        p_ms = [time_ms(torch, lambda: plain_ad(s, dt, c), 1) for _ in range(3)]
        res["plain"] = statistics.median(p_ms)
        print(f"[ad-timing {tag} plain AD {BIG}x{NLEV}] {res['plain']:.2f} ms (median of 3, CUDA events; "
              f"autograd tape peak {peak / 2**30:.2f} GiB); runs {[round(v, 1) for v in p_ms]}; {card}")

        traj = nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True)[2]
        # (label, call, values per column-level the function moves + its
        # (nlev+1)-row extras, the same for this code, flops, runs, fused form)
        cases = [
            ("forward", lambda: nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True),
             (26 + ntraj, 5), (28 + ntraj, 5), NL_FLOPS, 10, None),
            ("reverse", lambda: adk.cloudsc2_ad_reverse_cuda(s, traj, dt, c),
             (41 + evap + ntraj, 6), (43 + evap + ntraj, 6), NL_FLOPS + TL_FLOPS, 10, None),
            ("traj_only forward", lambda: nlk.cloudsc2_nl_cuda(s, dt, c, with_trajectory=True, traj_only=True),
             (16 + ntraj, 1), (18 + ntraj, 1), NL_FLOPS, 10, None),
            ("cotangent_only step", lambda: adk.cloudsc2_ad_cuda(s, dt, c, cotangent_only=True),
             (41 + evap, 6), (61 + evap + 2 * ntraj, 7), AD_FLOPS, 10, None),
            ("fused rolled", lambda: adk.cloudsc2_ad_fused_cuda(s, dt, c),
             (51 + evap, 10), (69 + evap + 2 * ntraj, 11), AD_FLOPS, 3, False),
            ("fused resident", lambda: adk.cloudsc2_ad_fused_cuda(s, dt, c, resident=True),
             (51 + evap, 10), (53 + evap + 2 * (ntraj + 10), 10), AD_FLOPS, 3, True),
        ]
        for label, fn, (fvals, frows), (dvals, drows), flops, runs, resident in cases:
            k, h, k_ms = kernel_ms(torch, fn, runs)
            nbytes = BIG * (NLEV * fvals + frows) * item
            design_bytes = BIG * (NLEV * dvals + drows) * item
            b_ms, b_by = bound(nbytes, BIG * NLEV * flops, tag)
            extra = ""
            for (lib, form), keys in AD_ENTRIES.items():
                if form == label:
                    u = kernel_usage(build, adk, c, dtype, lib, form, keys[tag == "f64"])
                    res[label + " registers"] = u
                    spills = ("ptxas's spills not in this process's build log (library built before)"
                              if u["spill_stores"] is None else
                              f"ptxas: {u['spill_stores']} B spill stores, {u['spill_loads']} B spill loads")
                    extra = (f"; operations of the hand-transposed reverse level by the hand count in ad_level.h "
                             f"({AD_LEVEL_FLOPS[evap]} flops per column-level, not measured) "
                             f"{BIG * NLEV * AD_LEVEL_FLOPS[evap] / PEAK_FLOPS[tag] * 1e3:.4f} ms at peak; "
                             f"{u['registers']} registers and {u['local_bytes']} B local memory a thread "
                             f"(cudaFuncGetAttributes), {spills}")
                    if form == "reverse":
                        extra += (f"; {u['blocks_per_sm']} blocks of 128 per SM, its ring {u['depth']} levels, "
                                  f"{u['shared_bytes']} B shared a block (reverse_occupancy)")
            if resident is not None:
                res[label + " occupancy"] = occ = fused_plan_reading(adk, dtype, c, resident, BIG)
                extra += "; " + fused_plan_text(occ)
            res[label] = (k, h, b_ms, b_by)
            print(f"[ad-timing {tag} {BIG}x{NLEV} {label}] kernel {k:.4f} ms ({BIG / k * 1e3:.4e} cols/s, "
                  f"{design_bytes / k / 1e6:.1f} GB/s of the bytes this code moves); bound {b_ms:.4f} ms by "
                  f"{b_by} (bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, operations of the function "
                  f"{BIG * NLEV * flops / PEAK_FLOPS[tag] * 1e3:.4f} ms): {b_ms / k:.3f} of it{extra}; "
                  f"wrapper host time {h:.4f} ms per call; kernel runs {[round(x, 4) for x in k_ms]}; {card}")
        # the reverse kernel with evaporation (LEVAPLS2): 45 values a
        # column-level, beside the default's 43
        cl = c.replace(LEVAPLS2=True)
        del s, traj, cases
        _, s, dt = ad_state(torch, BIG, dtype, cl, seed=2)
        traj = nlk.cloudsc2_nl_cuda(s, dt, cl, with_trajectory=True)[2]
        k, h, k_ms = kernel_ms(torch, lambda: adk.cloudsc2_ad_reverse_cuda(s, traj, dt, cl), 10)
        b_ms, b_by = bound(BIG * (NLEV * (41 + 1 + 3) + 6) * item, BIG * NLEV * (NL_FLOPS + TL_FLOPS), tag)
        u = res["reverse levapls2 registers"] = kernel_usage(build, adk, cl, dtype, "cloudsc2_ad", "reverse",
                                                              reverse_entry(tag, 0, True))
        res["reverse levapls2"] = (k, h, b_ms, b_by)
        print(f"[ad-timing {tag} {BIG}x{NLEV} reverse levapls2] kernel {k:.4f} ms, {k / res['reverse'][0]:.3f} of "
              f"the default's {res['reverse'][0]:.4f}; bound {b_ms:.4f} ms by {b_by}: {b_ms / k:.3f} of it; "
              f"{u['registers']} registers, {u['local_bytes']} B local, ptxas spills {u['spill_stores']}/"
              f"{u['spill_loads']} B, {u['blocks_per_sm']} blocks of 128 per SM, ring {u['depth']} x "
              f"{u['shared_bytes']} B shared; kernel runs {[round(x, 4) for x in k_ms]}; {card}")
        out[tag] = res
        del s, traj
        torch.cuda.empty_cache()
    return out


def kernel_stream_counts(nlk, tlk, adk, c):
    """The input fields each port kernel reads at the default switches,
    counted from its wrapper's argument list (the ``(nlev,)`` vector
    ``eta`` left out): the reader's stream count for it."""
    from cloudsc2_tpu_torch.physics.nonlinear import TRAJ_OUTPUTS, trajectory_names

    skip = {"eta"} | (set(TRAJ_OUTPUTS) - set(trajectory_names(c)))
    return {
        "cloudsc2_nl fused": len([n for n in nlk.NL_INPUTS if n not in skip | {"qsat"}]),
        "cloudsc2_tl": len([n for n in tlk.TL_INPUTS if n not in skip]),
        "cloudsc2_ad reverse": len([n for n in adk.AD_INPUTS if n not in skip]),
        "cloudsc2_ad_fused": len([n for n in adk.AD_FUSED_INPUTS if n not in skip]),
    }


def probe_checks(torch, mbk, nlk, counts, card):
    """Phase 12, the probes against their plain versions on the card (these
    launches are not the probes' paths'), every instantiation that the
    paths run and at the paths' shapes.  The reader bitwise its plain
    version: every stream count 1-32 (S is a template value) in both
    layouts at a ragged 4000 x 137; S = 3 and 10 at 4096; at 65,536 x 137,
    S = 10 in both layouts and each port kernel's input stream count
    (``counts``) in the global layout.  The chain on the wide operand range
    at 137 x 65,536: every variant bitwise its plain version given the
    card's approximate reciprocal (``rcp_cuda`` in ``approx`` mode; ``div``
    and ``rcp`` are IEEE operations under ``--fmad=false``) at 1, 5 and 16
    steps (the unrolled loop, its remainder); one step of each within
    ``STEP_ULP_BOUND`` ulps of the float64 map; ``rcpx1`` and ``rcpx2``
    apart from ``rcpx`` at some points.  Returns the largest abs
    difference of each kernel (0 where bitwise) and each variant's one-step
    error in ulps."""
    from drivers.microbench_div_torch import STEP_ULP_BOUND, step_ulps, wide_operands

    gen = torch.Generator(device="cuda:0").manual_seed(12)
    before = (mbk.reader_cuda.launches, mbk.chain_cuda.launches)
    err = {"reader": 0.0, "chain": 0.0}
    cases = ([(layout, s, RAGGED) for layout in mbk.LAYOUTS for s in range(1, mbk.MAX_STREAMS + 1)]
             + [(layout, s, SMALL) for layout in mbk.LAYOUTS for s in (3, 10)]
             + [(layout, 10, BIG) for layout in mbk.LAYOUTS]
             + [("global", s, BIG) for s in sorted(set(counts.values()))])
    for layout, streams, ncols in cases:
        big = torch.rand((streams, *mbk.reader_shape(layout, NLEV, ncols)), generator=gen, device="cuda:0")
        parts = list(big.unbind(0))
        got = mbk.reader_cuda(parts, 7.0, layout, ncols)
        want = mbk.plain_reader(parts, 7.0, layout, ncols)
        torch.cuda.synchronize()
        err["reader"] = max(err["reader"], float((got - want).abs().max()))
        assert_bitwise(torch, {"sum": got}, {"sum": want}, f"[reader {layout} S={streams} {ncols}x{NLEV}]")
        del big, parts
    print(f"  [reader] kernel bitwise its plain version in {len(cases)} cases: S = 1-{mbk.MAX_STREAMS} in both "
          f"layouts at {RAGGED} columns, S = 3 and 10 at {SMALL}, S = 10 in both layouts and S = "
          f"{sorted(set(counts.values()))} (global) at {BIG}; {NLEV} levels; {card}")
    x = torch.from_numpy(wide_operands(NLEV, BIG, seed=12)).to("cuda:0")

    def approx(b):
        return nlk.rcp_cuda(b, "approx")

    one, ulps = {}, {}
    for variant in mbk.VARIANTS:
        for n in (1, 5, 16):
            got, want = mbk.chain_cuda(x, variant, n), mbk.plain_chain(x, variant, n, approx)
            torch.cuda.synchronize()
            err["chain"] = max(err["chain"], float((got - want).abs().max()))
            assert_bitwise(torch, {"x": got}, {"x": want}, f"[chain {variant} n={n} {NLEV}x{BIG}]")
            if n == 1:
                one[variant] = got
        ulps[variant] = step_ulps(x, one[variant])
        if not ulps[variant] <= STEP_ULP_BOUND[variant]:
            raise AssertionError(f"[chain] {variant}: one step {ulps[variant]:.4f} ulps from the float64 map, "
                                 f"above its bound {STEP_ULP_BOUND[variant]}")
    apart = {v: float((one[v] != one["rcpx"]).double().mean()) for v in ("rcpx1", "rcpx2")}
    if not all(apart.values()):
        raise AssertionError(f"[chain] a Newton variant is rcpx at every point: share apart {apart}")
    print(f"  [chain] every variant bitwise its plain version (the card's rcp.approx given) at {NLEV}x{BIG}, "
          f"1, 5 and 16 steps; one step in ulps of the float64 map {{{', '.join(f'{v}: {u:.4f}' for v, u in ulps.items())}}} "
          f"(bounds {STEP_ULP_BOUND}); share of points apart from rcpx {apart}; {card}")
    del x, one
    grown = (mbk.reader_cuda.launches - before[0], mbk.chain_cuda.launches - before[1])
    if not all(grown):
        raise AssertionError(f"[probes] the kernels' launch counts did not grow: {grown}")
    return err, ulps


def probe_paths(torch, mbk, counts, card):
    """Phase 12, the probes through their drivers, each with its kernel's
    count at 0 just before and read just after: ``microbench_hbm_torch`` at
    the JAX script's defaults (4096 and 65,536 columns, 10 streams, both
    layouts), then at 65,536 x 137 in the global layout at each port
    kernel's input stream count; ``microbench_div_torch`` at the JAX
    script's shape, every variant's ``chain_rel_err`` within 1e-6 of the
    float64 chain (a few float32 ulps: the hardware reciprocal is within an
    ulp and the map contracts errors by 0.445 a step).  Returns the lines
    and the launches of each path."""
    from drivers import microbench_div_torch, microbench_hbm_torch

    mbk.reader_cuda.launches = 0
    hbm = microbench_hbm_torch.main([])
    by_kernel = {name: microbench_hbm_torch.main(["16", "--streams", str(s), "--layout", "global"])[0]
                 for name, s in counts.items()}
    reader_launches = mbk.reader_cuda.launches
    mbk.chain_cuda.launches = 0
    div = microbench_div_torch.main([])
    chain_launches = mbk.chain_cuda.launches
    print(f"[probes] launches on the probes' paths: reader {reader_launches}, chain {chain_launches}")
    if reader_launches == 0 or chain_launches == 0:
        raise AssertionError("a probe's driver never launched its kernel")
    for name, line in by_kernel.items():
        print(f"  [reader at {name}'s {line['streams']} streams, {BIG}x{NLEV} global] "
              f"{line['read_gb_per_s']:.1f} GB/s, {line['peak_share']:.4f} of 3.35 TB/s, kernel "
              f"{line['per_step_ms']:.4f} ms, bound {line['bound_ms']:.4f} ms, torch.sum {line['library_ms']:.4f} ms "
              f"({line['library_gb_per_s']:.1f} GB/s); {card}")
    errs = {line["variant"]: line["chain_rel_err"] for line in div if "chain_rel_err" in line}
    over = {v: e for v, e in errs.items() if not e <= 1e-6}
    if over or len(errs) != len(mbk.VARIANTS):
        raise AssertionError(f"[chain] variants beyond 1e-6 of the float64 chain: {over} (read {errs})")
    print(f"  [chain] every variant within 1e-6 of the float64 chain: {errs}; {card}")
    placed = {line["variant"]: (line["fewest_sms"], line["most_blocks_per_sm"]) for line in div if "ns_per_step" in line}
    print(f"  [chain latency] (fewest SMs a launch ran on, most blocks on one SM) by variant: {placed}; one warp "
          f"per SM in every launch: {all(line['one_warp_per_sm'] for line in div if 'ns_per_step' in line)}")
    return hbm, by_kernel, div, reader_launches, chain_launches


def probe_phase(torch, mbk, nlk, tlk, adk, c, card):
    """Phase 12: :func:`probe_checks`, then :func:`probe_paths` at each port
    kernel's input stream count, then the plain versions timed once each at
    the paths' main shapes (65,536 x 137, 10 streams; 137 x 65,536, the
    chain's LONG steps).  Returns the kernels line's rows of the two probes."""
    from cloudsc2_tpu_torch.utils.card import run_ms

    counts = kernel_stream_counts(nlk, tlk, adk, c)
    probe_err, step_ulp = probe_checks(torch, mbk, nlk, counts, card)
    hbm_lines, by_kernel, div_lines, reader_launches, chain_launches = probe_paths(torch, mbk, counts, card)
    hbm_big = next(line for line in hbm_lines if line["ncols"] == BIG and not line["tile"])
    div_timed = {line["variant"]: line for line in div_lines if "ns_per_elem" in line}
    gen = torch.Generator(device="cuda:0").manual_seed(12)
    big = torch.rand((hbm_big["streams"], NLEV, BIG), generator=gen, device="cuda:0")
    reader_plain_ms = run_ms(lambda: mbk.plain_reader(list(big.unbind(0)), 1.0), 1, big.device)
    del big
    x = torch.full((NLEV, BIG), 1.2345, device="cuda:0")
    chain_plain_ms = run_ms(lambda: mbk.plain_chain(x, "div", div_timed["div"]["steps"]), 1, x.device)
    del x
    print(f"[probes] plain versions: reader {reader_plain_ms:.4f} ms ({hbm_big['streams']} streams, {BIG}x{NLEV}), "
          f"chain div {chain_plain_ms:.4f} ms ({div_timed['div']['steps']} steps, {NLEV}x{BIG}), one call each "
          f"(CUDA events behind a sleep, as the drivers time the kernels); {card}")
    return [{
        "name": "make_reader",
        "route": "cuda",
        "source": "cloudsc2_tpu_torch/kernels/csrc/microbench.cu",
        "replaces": "benchmarks/microbench_hbm.py:45",
        "launches": reader_launches,
        "max_abs_err": probe_err["reader"],
        "ms": hbm_big["per_step_ms"],
        "plain_ms": reader_plain_ms,
        "bound_ms": hbm_big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": hbm_big["library_ms"],
        "streams": hbm_big["streams"],
        "read_gb_per_s": hbm_big["read_gb_per_s"],
        "by_kernel": {name: {k: line[k] for k in ("streams", "per_step_ms", "read_gb_per_s", "peak_share",
                                                  "bound_ms", "library_ms", "library_gb_per_s")}
                      for name, line in by_kernel.items()},
        "shape": [NLEV, BIG],
    }, {
        "name": "make_chain",
        "route": "cuda",
        "source": "cloudsc2_tpu_torch/kernels/csrc/microbench.cu",
        "replaces": "benchmarks/microbench_div.py:56",
        "launches": chain_launches,
        "max_abs_err": probe_err["chain"],
        "ms": div_timed["div"]["launch_ms"],
        "plain_ms": chain_plain_ms,
        "bound_ms": div_timed["div"]["bound_ms"],
        "bound_by": div_timed["div"]["bound_by"],
        "library_ms": None,
        "steps": div_timed["div"]["steps"],
        "variants": {v: {k: line[k] for k in ("ns_per_elem", "vs_div", "launch_ms", "bound_ms", "bound_by")}
                     for v, line in div_timed.items()},
        "chain_rel_err": {line["variant"]: line["chain_rel_err"] for line in div_lines if "chain_rel_err" in line},
        "step_ulp_err": step_ulp,
        "latency_ns_per_step": {line["variant"]: line["ns_per_step"] for line in div_lines if "ns_per_step" in line},
        "latency_one_warp_per_sm": all(line["one_warp_per_sm"] for line in div_lines if "ns_per_step" in line),
        "shape": [NLEV, BIG],
    }]


#: phase 13: the stream's chunk, ring and total columns by type (the f32
#: sweep is the 10M-column workload of BASELINE.json; f64 a fifth of it)
STREAM_RING = 4
STREAM_TOTAL = {"f32": 10_485_760, "f64": 2_097_152}
#: chunks in the profiled window of phase 13, and in the driver's run
STREAM_WINDOW = 8
STREAM_DRIVER_CHUNKS = {"f32": 16, "f64": 8}


def event_ms(torch, fn, runs=10, calls=1):
    """``runs`` readings of CUDA-event milliseconds per call of ``calls``
    back-to-back calls of ``fn``."""
    fn()
    torch.cuda.synchronize()
    return [time_ms(torch, fn, calls) / calls for _ in range(runs)]


def stream_one_shot(torch, ring, dt, c):
    """Each ring slot's one-shot ``forward_step`` on a device-resident copy
    of the slot, eta from slot 0: the stream's reference."""
    from cloudsc2_tpu_torch.parallel.step import forward_step
    from cloudsc2_tpu_torch.physics.diagnostics import eta_levels

    slots = [{k: v.to("cuda:0") for k, v in slot.fields.items()} for slot in ring]
    eta = eta_levels(slots[0]["ap"], slots[0]["aph"])
    outs = [forward_step(dict(s, eta=eta), dt, c) for s in slots]
    torch.cuda.synchronize()
    return outs


def trace_overlap(path):
    """From a ``torch.profiler`` chrome trace: the host-to-device and
    device-to-host copies (name, stream, start, end in us) and the NL
    kernels (stream, start, end)."""
    trace = json.loads(Path(path).read_text())
    copies, kernels = [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name, args = e.get("name", ""), e.get("args", {})
        span = (args.get("stream", e.get("tid")), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name):
            copies.append((name, *span))
        elif e.get("cat") == "kernel" and is_nl_kernel(name):
            kernels.append(span)
    return copies, kernels


def stream_profile(torch, stream, ring, dt, c, card, tag):
    """Phase 13's overlap check: ``torch.profiler`` over a full-duplex sweep
    of STREAM_WINDOW chunks.  Every host-to-device copy must be from pinned
    memory, on a stream other than the NL kernel's, and one at least must
    overlap an NL kernel in time.  Returns the counts read."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stream.sweep_ring(ring, dt, c, nchunks=STREAM_WINDOW, device="cuda:0", stream_outputs=True)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        copies, kernels = trace_overlap(f"{tmp}/trace.json")
    h2d = [x for x in copies if "HtoD" in x[0]]
    d2h = [x for x in copies if "DtoH" in x[0]]
    kernel_streams = {k[0] for k in kernels}
    overlapping = sum(any(a < ke and ks < b for _, ks, ke in kernels) for _, _, a, b in h2d)
    d2h_overlapping = sum(any(a < ke and ks < b for _, ks, ke in kernels) for _, _, a, b in d2h)
    spans = [(a, b) for _, _, a, b in copies] + [(a, b) for _, a, b in kernels]
    window = max(b for _, b in spans) - min(a for a, _ in spans) if spans else float("nan")

    def busy(items):
        return sum(b - a for *_, a, b in items) / window

    reading = {"window_ms": window / 1e3, "nl_busy_share": busy(kernels), "h2d_busy_share": busy(h2d),
               "d2h_busy_share": busy(d2h),
               "h2d_copies": len(h2d), "h2d_pinned": sum("Pinned" in x[0] for x in h2d),
               "h2d_streams": sorted({x[1] for x in h2d}), "nl_kernels": len(kernels),
               "nl_kernel_streams": sorted(kernel_streams), "h2d_overlapping_nl": overlapping,
               "d2h_copies": len(d2h), "d2h_pinned": sum("Pinned" in x[0] for x in d2h),
               "d2h_streams": sorted({x[1] for x in d2h}), "d2h_overlapping_nl": d2h_overlapping}
    print(f"[stream {tag} profile] {STREAM_WINDOW} chunks, full duplex: {reading}; {card}")
    if not h2d or not kernels:
        raise AssertionError(f"[stream {tag} profile] the trace shows no host-to-device copy or no NL kernel")
    if reading["h2d_pinned"] != len(h2d):
        raise AssertionError(f"[stream {tag} profile] a host-to-device copy is not from pinned memory: {h2d}")
    if kernel_streams & {x[1] for x in h2d}:
        raise AssertionError(f"[stream {tag} profile] a host-to-device copy runs on the NL kernel's stream")
    if overlapping == 0:
        raise AssertionError(f"[stream {tag} profile] no host-to-device copy overlaps an NL kernel")
    return reading


def stream_yardsticks(torch, stream, ring, dt, c, card, tag):
    """The card's rates alone (CUDA events, medians of 10): each ring slot's
    pinned copy to the device, a chunk's outputs copied back to pinned
    memory, each slot's copy to the device and those outputs back at once
    (on two streams, as full duplex runs them), and the NL step on a
    resident chunk."""
    from cloudsc2_tpu_torch.parallel.step import forward_step
    from cloudsc2_tpu_torch.physics.diagnostics import eta_levels

    dev = stream.flat_slot({k: tuple(v.shape) for k, v in ring[0].fields.items()}, ring[0].flat.dtype,
                           torch.device("cuda:0"))
    h2d_runs = [event_ms(torch, lambda src=src: dev.flat.copy_(src.flat, non_blocking=True)) for src in ring]
    s = dict(dev.fields, eta=eta_levels(dev.fields["ap"], dev.fields["aph"]))
    kernel_runs = event_ms(torch, lambda: forward_step(s, dt, c), calls=KERNEL_BATCH)
    tends, diags = forward_step(s, dt, c)
    outs = {**tends, **{n: diags[n] for n in stream.OUT_DIAGS}}
    shapes = {k: tuple(v.shape) for k, v in outs.items()}
    dev_out = stream.flat_slot(shapes, ring[0].flat.dtype, torch.device("cuda:0"))
    host_out = stream.flat_slot(shapes, ring[0].flat.dtype, torch.device("cpu"), pin=True)
    d2h_ms = statistics.median(event_ms(torch, lambda: host_out.flat.copy_(dev_out.flat, non_blocking=True)))
    up, down = torch.cuda.Stream(), torch.cuda.Stream()

    def both(src):
        cur = torch.cuda.current_stream()
        up.wait_stream(cur)
        down.wait_stream(cur)
        with torch.cuda.stream(up):
            dev.flat.copy_(src.flat, non_blocking=True)
        with torch.cuda.stream(down):
            host_out.flat.copy_(dev_out.flat, non_blocking=True)
        cur.wait_stream(up)
        cur.wait_stream(down)

    duplex_runs = [event_ms(torch, lambda src=src: both(src)) for src in ring]
    sums = []
    for _ in range(10):
        t0 = time.perf_counter()
        float(host_out.fields["t"].numpy().sum())
        sums.append((time.perf_counter() - t0) * 1e3)
    slot_bytes = ring[0].flat.numel() * ring[0].flat.element_size()
    out_bytes = dev_out.flat.numel() * dev_out.flat.element_size()
    h2d_ms = [statistics.median(r) for r in h2d_runs]
    duplex_ms = [statistics.median(r) for r in duplex_runs]
    kernel_ms = statistics.median(kernel_runs)
    # the least time of each (the fastest of its 10 runs): what the sweep's bound is made of
    out = {"h2d_ms": h2d_ms, "h2d_gbps": [slot_bytes / t / 1e6 for t in h2d_ms], "d2h_ms": d2h_ms,
           "d2h_gbps": out_bytes / d2h_ms / 1e6, "duplex_ms": duplex_ms,
           "duplex_gbps": [(slot_bytes + out_bytes) / t / 1e6 for t in duplex_ms], "kernel_ms": kernel_ms,
           "host_sum_ms": statistics.median(sums), "h2d_best_ms": [min(r) for r in h2d_runs],
           "duplex_best_ms": [min(r) for r in duplex_runs], "kernel_best_ms": min(kernel_runs)}
    best_h2d = [round(slot_bytes / t / 1e6, 2) for t in out["h2d_best_ms"]]
    best_duplex = [round((slot_bytes + out_bytes) / t / 1e6, 2) for t in out["duplex_best_ms"]]
    print(f"[stream {tag} yardsticks] pinned H2D of each ring slot {[round(t, 4) for t in h2d_ms]} ms "
          f"({[round(g, 2) for g in out['h2d_gbps']]} GB/s; fastest {best_h2d}); "
          f"D2H of a chunk's outputs to pinned memory {d2h_ms:.4f} ms ({out['d2h_gbps']:.2f} GB/s); both at once, "
          f"on two streams {[round(t, 4) for t in duplex_ms]} ms ({[round(g, 2) for g in out['duplex_gbps']]} GB/s "
          f"both ways; fastest {best_duplex}); "
          f"the NL step (fused) on a resident chunk {kernel_ms:.4f} ms (CUDA events, medians of 10); the host's "
          f"sum of a chunk's t in full duplex {out['host_sum_ms']:.4f} ms (host clock, median of 10); {card}")
    return out


def stream_phase(torch, nlk, tlk, adk, c0, card):
    """Phase 13: the column-chunked stream
    (``cloudsc2_tpu_torch.parallel.stream``) and ``full_step`` on the card.
    Returns the readings for the kernels line."""
    import gc

    import numpy as np

    from cloudsc2_tpu_torch.parallel import stream
    from cloudsc2_tpu_torch.parallel.step import full_step
    from cloudsc2_tpu_torch.physics.saturation import saturation
    from cloudsc2_tpu_torch.physics.increment import state_increment
    from cloudsc2_tpu_torch.utils.validation import validate
    from cloudsc2_tpu_torch.validation.symmetry import TEND_NAMES, SymmetryTest
    from drivers.run_nonlinear_torch import config_tolerances, core, synthetic_golden, synthetic_input
    from cloudsc2_tpu_torch.config import Config, TorchConfig

    out = {"launches": {}, "sweeps": {}, "yardsticks": {}, "profile": {}, "full_step": {}}
    nl_launches = 0
    for precision, dtype, tag in (("single", torch.float32, "f32"), ("double", torch.float64, "f64")):
        _, base, dt, c = synthetic_input(100, precision)
        t0 = time.perf_counter()
        ring = stream.host_ring(stream.build_ring(base, BIG, STREAM_RING), pin=True)
        print(f"[stream {tag}] pinned ring of {STREAM_RING} x {BIG} columns built in "
              f"{time.perf_counter() - t0:.2f} s ({ring[0].flat.numel() * ring[0].flat.element_size() / 1e6:.1f} "
              f"MB a slot); {card}")
        one = stream_one_shot(torch, ring, dt, c)
        golden = synthetic_golden(BIG, precision)
        nchunks = STREAM_TOTAL[tag] // BIG
        want_half = float(torch.sum(torch.stack([torch.sum(one[i % STREAM_RING][0]["t"]) for i in range(nchunks)])))
        slot_sums = [float(o[0]["t"].cpu().numpy().sum()) for o in one]
        want_full = 0.0
        for i in range(nchunks):
            want_full += slot_sums[i % STREAM_RING]
        one0 = {k: v.cpu() for k, v in {**one[0][0], **one[0][1]}.items()}
        del one
        torch.cuda.empty_cache()

        # the sweeps, with the launch count from 0: the warm-up and one a chunk
        nlk.cloudsc2_nl_cuda.launches = 0
        for outputs in (False, True):
            mode = "full duplex" if outputs else "half duplex"
            stats, (tends, diags) = stream.sweep_ring(ring, dt, c, nchunks=nchunks, device="cuda:0",
                                                      stream_outputs=outputs)
            want = want_full if outputs else want_half
            if stats["checksum"] != want:
                raise AssertionError(f"[stream {tag} {mode}] checksum {stats['checksum']!r} is not the one-shot "
                                     f"outputs' {want!r}")
            sample = {k: v.cpu() for k, v in {**tends, **diags}.items()}
            differ = [k for k, v in sample.items() if not torch.equal(v, one0[k])]
            if differ:
                raise AssertionError(f"[stream {tag} {mode}] chunk 0's sample differs from slot 0's one-shot "
                                     f"output in {differ}")
            atol, rtol = config_tolerances(precision, "cuda")
            failing = validate({k: sample[k].numpy() for k in TEND_NAMES}, golden[0], atol=atol, rtol=rtol)
            failing += validate({k: v.numpy() for k, v in sample.items() if k not in TEND_NAMES and k != "qsat"},
                                golden[1], atol=atol, rtol=rtol)
            if failing:
                raise AssertionError(f"[stream {tag} {mode}] chunk 0 fails the golden gate in {failing}")
            print(f"[stream {tag} {mode}] {stats['total_cols']} columns in {stats['nchunks']} chunks of "
                  f"{stats['chunk_cols']}: {stats['wall_s']:.4f} s, {stats['cols_per_sec']:.6e} cols/s, "
                  f"effective H2D {stats['effective_h2d_gbps']:.3f} GB/s"
                  + (f", D2H {stats['effective_d2h_gbps']:.3f} GB/s" if outputs else "")
                  + f"; checksum {stats['checksum']!r} bitwise the one-shot outputs'; chunk 0 bitwise slot 0's "
                  f"one-shot output, HOORAY at rtol {rtol:g}, atol {atol:g}; {card}")
            out["sweeps"][f"{tag} {mode}"] = {k: v for k, v in stats.items() if k != "checksum"}
            del tends, diags, sample
        launches = nlk.cloudsc2_nl_cuda.launches
        print(f"[stream {tag}] cloudsc2_nl_cuda launches in the two sweeps: {launches} "
              f"(2 x ({nchunks} chunks + 1 warm-up))")
        if launches != 2 * (nchunks + 1):
            raise AssertionError(f"[stream {tag}] the sweeps launched the NL kernel {launches} times")
        nl_launches += launches

        out["profile"][tag] = stream_profile(torch, stream, ring, dt, c, card, tag)
        yard = stream_yardsticks(torch, stream, ring, dt, c, card, tag)
        out["yardsticks"][tag] = yard
        for mode, copy_ms in (("half duplex", yard["h2d_best_ms"]), ("full duplex", yard["duplex_best_ms"])):
            # the sweep cycles the slots evenly: a chunk takes, at best, the
            # longer of its slot's fastest copy and the fastest kernel
            per_chunk = statistics.fmean(max(t, yard["kernel_best_ms"]) for t in copy_ms)
            sweep = out["sweeps"][f"{tag} {mode}"]
            bound = BIG / per_chunk * 1e3
            sweep.update(bound_cols_per_sec=bound, share_of_bound=sweep["cols_per_sec"] / bound)
            what = "H2D" if mode == "half duplex" else "H2D and D2H at once"
            print(f"[stream {tag} {mode}] bound {bound:.6e} cols/s (a chunk of {BIG} per {per_chunk:.4f} ms, the "
                  f"mean over the slots of max(fastest {what}, fastest kernel {yard['kernel_best_ms']:.4f} ms)); "
                  f"the stream reaches "
                  f"{sweep['share_of_bound']:.4f} of it; {card}")
        del ring
        gc.collect()

        # the driver's stream path (--stream-chunk), counts from 0
        nlk.cloudsc2_nl_cuda.launches = 0
        n = STREAM_DRIVER_CHUNKS[tag]
        rc = core(Config(precision=precision, num_cols=n * BIG), TorchConfig(device="cuda:0", precision=precision),
                  inputs=synthetic_input(100, precision), reference=golden, stream_chunk=BIG,
                  stream_ring=STREAM_RING, stream_outputs=tag == "f32")
        launches = nlk.cloudsc2_nl_cuda.launches
        print(f"[stream {tag}] the driver's --stream-chunk {BIG} over {n * BIG} columns: exit {rc}, "
              f"cloudsc2_nl_cuda launches {launches}; {card}")
        if rc != 0 or launches != n + 1:
            raise AssertionError(f"[stream {tag}] the driver's stream path failed (exit {rc}, {launches} launches)")
        nl_launches += launches
        gc.collect()

        # full_step at 65,536 x 137, counts from 0; then its references
        _, s, dt2 = make_state(torch, BIG, dtype, c0, seed=2)
        for fn in (nlk.cloudsc2_nl_cuda, tlk.cloudsc2_tl_cuda, adk.cloudsc2_ad_cuda):
            fn.launches = 0
        tends, norm1, norm2 = full_step(s, dt2, c0)
        torch.cuda.synchronize()
        counts = {"cloudsc2_nl_cuda": nlk.cloudsc2_nl_cuda.launches, "cloudsc2_tl_cuda": tlk.cloudsc2_tl_cuda.launches,
                  "cloudsc2_ad_cuda": adk.cloudsc2_ad_cuda.launches}
        if min(counts.values()) == 0:
            raise AssertionError(f"[full_step {tag}] a kernel never launched: {counts}")
        ref1, ref2 = SymmetryTest(constants=c0).run(s, dt2)
        n1, n2 = norm1.cpu().numpy(), norm2.cpu().numpy()
        if not (np.array_equal(n1, ref1) and np.array_equal(n2, ref2)):
            raise AssertionError(f"[full_step {tag}] the norms differ from the symmetry protocol's")
        x = dict(s)
        x["qsat"] = saturation(x["ap"], x["t"], kflag=1, lphylin=c0.LPHYLIN, c=c0)
        x.update(state_increment(x, 0.01, ignore_supsat=True))
        tl = tlk.cloudsc2_tl_cuda(x, dt2, c0)[0]
        differ = [k for k in TEND_NAMES if not torch.equal(tends[k], tl[k])]
        if differ:
            raise AssertionError(f"[full_step {tag}] the NL tendencies differ from the TL kernel's in {differ}")
        err = SymmetryTest(constants=c0).validate(n1, n2, verbose=False)
        print(f"[full_step {tag} {BIG}x{NLEV}] launches {counts}; norm1 and norm2 bitwise the symmetry protocol's, "
              f"the NL tendencies bitwise the TL kernel's forward; symmetry error {err:.4f} eps; {card}")
        if not err < 1e4:
            raise AssertionError(f"[full_step {tag}] symmetry error {err} eps")
        out["full_step"][tag] = {"launches": counts, "symmetry_eps": err}
        del s, x, tends, tl
        torch.cuda.empty_cache()
    out["launches"] = {
        "cloudsc2_nl_cuda stream": nl_launches,
        **{f"{name} full_step": sum(out["full_step"][t]["launches"][name] for t in ("f32", "f64"))
           for name in ("cloudsc2_nl_cuda", "cloudsc2_tl_cuda", "cloudsc2_ad_cuda")},
    }
    return out


#: phase 14: the two processes' columns and time limit (seconds)
MESH_PROCESS_COLS = 4096
MESH_PROCESS_TIMEOUT = 300
#: the shards of the hand-made mesh that splits the one card's columns
MESH_SPLIT = 4


def free_port():
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_forward(torch, nlk, c0, card, out):
    """Phase 14 (a): the sharded forward step on a mesh of the one card, and
    on a hand-made mesh of MESH_SPLIT shards of its columns, against the
    unsharded fused NL step: bitwise, its launches counted from 0, both
    timed (CUDA events, medians of 10 batches).  Returns the NL launches of
    the sharded steps (the unsharded reference's not counted)."""
    from cloudsc2_tpu_torch.parallel.mesh import ColumnMesh, column_mesh, gather_columns, shard_state
    from cloudsc2_tpu_torch.parallel.step import forward_step, make_sharded_forward_step

    card_mesh = column_mesh(device="cuda")
    split = ColumnMesh((1, MESH_SPLIT), 0, 1, (torch.device("cuda:0"),) * MESH_SPLIT)
    path = 0
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        _, s, dt = make_state(torch, BIG, dtype, c0, seed=2)
        s.pop("qsat")
        want = flat(forward_step(s, dt, c0))
        unsharded = statistics.median(event_ms(torch, lambda: forward_step(s, dt, c0), calls=KERNEL_BATCH))
        for name, mesh in (("card", card_mesh), (f"split {MESH_SPLIT}", split)):
            sharded = shard_state(s, mesh)
            step = make_sharded_forward_step(mesh, dt=dt, c=c0)
            nlk.cloudsc2_nl_cuda.launches = 0
            got = flat(step(sharded))
            torch.cuda.synchronize()
            launches = nlk.cloudsc2_nl_cuda.launches
            differ = [k for k, v in want.items() if not torch.equal(gather_columns(got[k]), v)]
            if differ or sorted(got) != sorted(want):
                raise AssertionError(f"[mesh {tag} {name}] the sharded step differs from the unsharded in {differ}")
            if launches != len(mesh.devices):
                raise AssertionError(f"[mesh {tag} {name}] {launches} NL launches, want one a shard")
            ms = statistics.median(event_ms(torch, lambda: step(sharded), calls=KERNEL_BATCH))
            path += nlk.cloudsc2_nl_cuda.launches
            print(f"[mesh {tag} {name}] the sharded forward step on the mesh {mesh.shape} of "
                  f"{[str(d) for d in mesh.devices]} at {BIG}x{NLEV}: bitwise the unsharded fused NL step, "
                  f"cloudsc2_nl_cuda launches {launches}; {ms:.4f} ms a step beside the unsharded {unsharded:.4f} ms "
                  f"(CUDA events, median of 10 x {KERNEL_BATCH} steps); {card}")
            out["forward"][f"{tag} {name}"] = {"launches": launches, "ms": ms, "unsharded_ms": unsharded,
                                                "mesh": list(mesh.shape)}
            del sharded, got
        del s, want
        torch.cuda.empty_cache()
    return {"cloudsc2_nl_cuda": path, "cloudsc2_tl_cuda": 0, "cloudsc2_ad_cuda": 0}


def mesh_drivers(torch, card, out):
    """Phase 14 (c): the three drivers with ``--sharded`` on the card."""
    from cloudsc2_tpu_torch.config import Config, TorchConfig
    from drivers import run_nonlinear_torch, run_symmetry_test_torch, run_taylor_test_torch
    from cloudsc2_tpu_torch.iox import synthetic_input
    from cloudsc2_tpu_torch.oracle import synthetic_golden

    for precision in ("single", "double"):
        config = Config(precision=precision, num_cols=BIG, num_runs=5, sharded=True)
        rc = run_nonlinear_torch.core(config, TorchConfig(device="cuda", precision=precision),
                                      inputs=synthetic_input(BIG, precision), reference=synthetic_golden(BIG, precision))
        print(f"[mesh driver nl {precision} {BIG}] --sharded: exit {rc}; {card}")
        if rc != 0:
            raise AssertionError(f"[mesh driver nl {precision}] the sharded NL driver failed validation")
        out["drivers"][f"nl {precision}"] = rc
    config = Config(precision="double", num_cols=SMALL, num_runs=1, sharded=True)
    rc, tt = run_taylor_test_torch.core(config, TorchConfig(device="cuda", precision="double"),
                                        inputs=synthetic_input(SMALL, "double"), per_column=True)
    print(f"[mesh driver taylor double {SMALL} per_column] --sharded: exit {rc}; {card}")
    if rc != 0:
        raise AssertionError("[mesh driver taylor] the sharded Taylor verdict is not HOORAY")
    out["drivers"]["taylor double per_column"] = rc
    for precision in ("double", "single"):
        config = Config(precision=precision, num_cols=BIG, num_runs=1, sharded=True)
        rc, err = run_symmetry_test_torch.core(config, TorchConfig(device="cuda", precision=precision),
                                               inputs=synthetic_input(BIG, precision))
        print(f"[mesh driver symmetry {precision} {BIG}] --sharded: exit {rc}, error {err:.6e} machine epsilons; {card}")
        if rc != 0:
            raise AssertionError(f"[mesh driver symmetry {precision}] the sharded symmetry verdict is not HOORAY")
        out["drivers"][f"symmetry {precision} eps"] = err


def mesh_processes(card, out):
    """Phase 14 (d): two processes of the NL driver sharing the one card over
    a gloo group: each must exit 0 with HOORAY, report its column block and
    launch the NL kernel.  If one fails, the other is stopped."""
    import re
    import subprocess

    repo = Path(__file__).resolve().parent
    port = free_port()
    cmd = [sys.executable, str(repo / "drivers" / "run_nonlinear_torch.py"), "--device", "cuda", "--precision",
           "single", "--num-cols", str(MESH_PROCESS_COLS), "--num-runs", "3", "--distributed",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    t0 = time.perf_counter()
    try:
        outs = []
        for i, proc in enumerate(procs):
            text, _ = proc.communicate(timeout=max(1.0, MESH_PROCESS_TIMEOUT - (time.perf_counter() - t0)))
            outs.append(text)
            if proc.returncode != 0:
                raise AssertionError(f"[mesh process {i}] exit {proc.returncode}:\n{text}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for i, text in enumerate(outs):
        block = re.search(r"holds columns \[(\d+), (\d+)\)", text)
        launches = re.search(r"cloudsc2_nl_cuda (\d+)", text)
        if "HOORAY" not in text or not block or not launches or int(launches.group(1)) == 0:
            raise AssertionError(f"[mesh process {i}] no HOORAY, column block or NL launch:\n{text}")
        cols = [int(block.group(1)), int(block.group(2))]
        print(f"[mesh process {i} of 2] {MESH_PROCESS_COLS} columns f32 on the one card over gloo: HOORAY on "
              f"columns {cols}, cloudsc2_nl_cuda launches {launches.group(1)}; {card}")
        out["processes"].append({"columns": cols, "launches": int(launches.group(1))})
    print(f"[mesh processes] both done in {time.perf_counter() - t0:.1f} s (host clock, start-up included)")


def mesh_phase(torch, nlk, tlk, adk, c0, card):
    """Phase 14: the column mesh on the one card, each kernel's launches
    counted from 0 over the phase.  Returns the readings."""
    from cloudsc2_tpu_torch.parallel.dryrun import dryrun_multichip

    out = {"forward": {}, "drivers": {}, "processes": []}
    counters = (nlk.cloudsc2_nl_cuda, tlk.cloudsc2_tl_cuda, adk.cloudsc2_ad_cuda)
    launches = dict.fromkeys((fn.__name__ for fn in counters), 0)

    def add(part, got):
        print(f"[mesh {part}] launches {got}")
        for k, n in got.items():
            launches[k] += n

    def count(part, fn):
        for k in counters:
            k.launches = 0
        result = fn()
        torch.cuda.synchronize()
        add(part, {k.__name__: k.launches for k in counters})
        return result

    add("forward (the sharded steps)", mesh_forward(torch, nlk, c0, card, out))
    t0 = time.perf_counter()
    dryrun = count("dryrun", lambda: dryrun_multichip(1, device="cuda"))
    print(f"[mesh dryrun] dryrun_multichip(1, device='cuda') passed in {time.perf_counter() - t0:.1f} s; {card}")
    out["dryrun"] = {str(k): v for k, v in dryrun.items()}
    count("drivers", lambda: mesh_drivers(torch, card, out))
    mesh_processes(card, out)
    print(f"[mesh] launches in this phase (this process): {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"[mesh] a kernel of the path never launched: {launches}")
    out["launches"] = launches
    return out


def main() -> int:
    import torch

    import argparse

    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch port on one NVIDIA GPU.")
    parser.add_argument("--only-stream", action="store_true",
                        help="build the NL, TL and AD libraries and run phase 13 alone (no final result line)")
    parser.add_argument("--only-mesh", action="store_true",
                        help="build the NL, TL and AD libraries and run phase 14 alone (no final result line)")
    args = parser.parse_args()
    only_stream, only_mesh = args.only_stream, args.only_mesh
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cloudsc2_tpu_torch.config import Config, TorchConfig
    from cloudsc2_tpu_torch.kernels import adjoint as adk
    from cloudsc2_tpu_torch.kernels import build
    from cloudsc2_tpu_torch.kernels import microbench as mbk
    from cloudsc2_tpu_torch.kernels import nonlinear as nlk
    from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
    from cloudsc2_tpu_torch.params import make_constants
    from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad as plain_ad
    from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl as plain_nl
    from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl as plain_tl
    from cloudsc2_tpu_torch.utils.card import card_label
    from cloudsc2_tpu_torch.utils.timing import Timer
    from drivers.run_nonlinear_torch import core, synthetic_golden, synthetic_input

    t_start = time.perf_counter()
    # ---- 1. card
    card = card_label(torch.device("cuda:0"))
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{kind}, {torch.cuda.device_count()} visible")
    torch.cuda.set_device(0)

    # ---- 2. build: every library of every form at once
    loaders = {}
    for compact, fast in build.NL_FORMS:
        loaders["cloudsc2_nl" + build.form(compact, fast, nl=True)[0]] = (
            lambda compact=compact: nlk.load_cuda(compact))
    for name, load in (("cloudsc2_tl", tlk.load_cuda), ("cloudsc2_ad", adk.load_cuda),
                       ("cloudsc2_ad_fused", adk.load_fused_cuda)):
        for compact, fast in build.FORMS:
            loaders[name + build.form(compact, fast)[0]] = (
                lambda load=load, compact=compact, fast=fast: load(compact, fast))
    loaders["cloudsc2_microbench"] = mbk.load_cuda
    loaders["cloudsc2_launcher"] = build.launcher
    if only_stream or only_mesh:
        loaders = {name: loaders[name] for name in ("cloudsc2_nl", "cloudsc2_tl", "cloudsc2_ad", "cloudsc2_launcher")}
    build_kernels(build, loaders, card)
    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        now = time.perf_counter()
        print(f"[phase] {name}: {now - phase_t:.1f} s")
        phase_t = now

    c0 = make_constants(lphylin=True, ldrain1d=False)
    if only_stream:
        readings = stream_phase(torch, nlk, tlk, adk, c0, card)
        phase_done("13 stream")
        print(json.dumps({"stream": readings}))
        return 0
    if only_mesh:
        readings = mesh_phase(torch, nlk, tlk, adk, c0, card)
        phase_done("14 mesh")
        print(json.dumps({"mesh": readings}))
        return 0

    # ---- 3. NL kernel vs plain on the same CUDA tensors
    configs = {
        "default": c0,
        "levapls2": c0.replace(LEVAPLS2=True),
        "ldrain1d": make_constants(lphylin=True, ldrain1d=True),
    }
    max_abs = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        cases = [(name, c, SMALL) for name, c in configs.items()] + [("default", c0, BIG)]
        for name, c, ncols in cases:
            _, s, dt = make_state(torch, ncols, dtype, c, seed=1)
            got = flat(nlk.cloudsc2_nl_cuda(s, dt, c))
            want = flat(plain_nl(s, dt, c))
            torch.cuda.synchronize()
            label = f"[kernel-vs-plain {tag} {name} {ncols}x{NLEV}]"
            max_abs[(tag, name, ncols)] = compare(got, want, tolerances(torch, dtype, c), label)
            del s, got, want
    fused_abs = nl_fused_checks(torch, nlk, configs, card)
    div_err = nl_divide_checks(torch, nlk, plain_nl, configs, card)
    rcp_err = rcp_checks(torch, nlk, card)
    nl_forms = nl_compact_checks(torch, nlk, plain_nl, configs, card)

    phase_done("3 NL kernel vs plain")

    # ---- 4. TL kernel vs plain, and tangent_only vs the full launch
    t0 = time.perf_counter()
    tl_abs = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        cases = [(f"{name} lregcl={int(lreg)}", c.replace(LREGCL=lreg), SMALL)
                 for name, c in configs.items() for lreg in (True, False)]
        cases.append(("default", c0, BIG))
        for name, c, ncols in cases:
            _, s, dt = make_state(torch, ncols, dtype, c, seed=1, increment=True)
            got = flat(tlk.cloudsc2_tl_cuda(s, dt, c))
            only = flat(tlk.cloudsc2_tl_cuda(s, dt, c, tangent_only=True))
            want = flat(plain_tl(s, dt, c))
            torch.cuda.synchronize()
            label = f"[tl-kernel-vs-plain {tag} {name} {ncols}x{NLEV}]"
            tl_abs[(tag, name, ncols)] = compare(got, want, tl_tolerances(torch, dtype, c), label)
            if sorted(only) != sorted(k for k in got if k.endswith("_i")):
                raise AssertionError(f"{label} tangent_only returned {sorted(only)}")
            differ = [k for k in only if not torch.equal(only[k], got[k])]
            if differ:
                raise AssertionError(f"{label} tangent_only differs from the full launch in {differ}")
            print(f"  {label} tangent_only: all {len(only)} *_i outputs bitwise equal to the full launch")
            del s, got, only, want
    print(f"[tl-kernel-vs-plain] {time.perf_counter() - t0:.1f} s; {card}")
    tl_forms = tl_form_checks(torch, tlk, plain_tl, configs, card)
    phase_done("4 TL kernel vs plain")

    # ---- 5, 6. the NL kernel's trajectory and the AD kernels vs plain
    ad_err = ad_checks(torch, adk, nlk, plain_ad, plain_nl, configs, card)
    ad_forms = ad_form_checks(torch, adk, nlk, plain_ad, configs, card)
    phase_done("5-6 NL trajectory and AD kernel vs plain")

    # ---- 7. the NL main path through the driver, on the card
    for fn in (nlk.cloudsc2_nl_cuda, tlk.cloudsc2_tl_cuda, adk.cloudsc2_ad_cuda, adk.cloudsc2_ad_fused_cuda):
        fn.launches = 0
    nlk.cloudsc2_nl_cuda.fast_div_launches = 0
    runs = [(p, n, {}) for p in ("double", "single") for n in (100, BIG)]
    runs += [("single", BIG, {"fuse_saturation": False})]
    runs += [("single", n, {"fast_div": m}) for m in ("faithful", "approx") for n in (100, BIG)]
    for precision, ncols, opts in runs:
        config = Config(precision=precision, num_cols=ncols, num_runs=5 if not opts else 2)
        rc = core(
            config, TorchConfig(device="cuda:0", precision=precision),
            inputs=synthetic_input(ncols, precision),
            reference=synthetic_golden(ncols, precision), **opts,
        )
        per_call = {label: round(Timer.get_time(label, "ms") / max(Timer.get_count(label), 1), 4)
                    for label in Timer.labels()}
        path = "two-stage" if opts.get("fuse_saturation") is False else "fused"
        print(f"[main-path] {precision} {ncols} columns, {path}, divide {opts.get('fast_div', 'exact')}: "
              f"exit {rc}; ms per call by component (host clock, synchronized): {per_call}; {card}")
        if rc != 0:
            raise AssertionError(f"main path {precision} x {ncols} {opts} failed validation")
    launches = nlk.cloudsc2_nl_cuda.launches
    fast_launches = nlk.cloudsc2_nl_cuda.fast_div_launches
    print(f"[main-path] cloudsc2_nl_cuda launches: {launches}, of them under a non-exact divide {fast_launches}")
    if launches == 0 or fast_launches == 0:
        raise AssertionError("the main path never launched the CUDA kernel (or never under a non-exact divide)")
    nl_wide_checks(torch, nlk, plain_nl, c0, card)

    phase_done("7 NL main path")

    # ---- 8. the TL path: the Taylor protocol through both kernels
    adk.cloudsc2_ad_cuda.launches = 0
    t0 = time.perf_counter()
    _, tl_launches = taylor_gates(torch, nlk, tlk, card)
    print(f"[taylor] {time.perf_counter() - t0:.1f} s; {card}")
    phase_done("8 TL path")

    # ---- 9. the AD path: the symmetry protocol through the TL, NL and AD kernels, then
    # through the fused AD kernel and the cotangent_only AD
    ad_launches = symmetry_gates(torch, nlk, tlk, adk, card)["cloudsc2_ad_cuda"]
    fused_launches = fused_symmetry_gates(torch, adk, card)[0]
    phase_done("9 AD path")
    form_launches = form_protocol_gates(torch, nlk, tlk, adk, card)
    fused_form_launches = {
        form: fused_symmetry_gates(torch, adk, card, ((precision, SMALL, form, change),))
        for form, precision, change in (("LPHYLIN=False", "single", {"LPHYLIN": False}),
                                        ("faithful", "single", {"FAST_DIV": "faithful"}),
                                        ("approx", "single", {"FAST_DIV": "approx"}),
                                        ("CUADJ_COMPACT=False", "double", {"CUADJ_COMPACT": False}))
    }
    for form, counts in fused_form_launches.items():
        if counts[1 if form in ("faithful", "approx") else 2 if form == REF_FORM[0] else 0] == 0:
            raise AssertionError(f"[symmetry fused {form}] the fused kernel never launched in the form")
    phase_done("8-9 this slice's forms: the Taylor and symmetry paths")

    # ---- 10. timing at 65,536 x 137
    from cloudsc2_tpu_torch.physics.saturation import saturation

    timing, tl_timing, fused_timing, div_timing = {}, {}, {}, {}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        item = 8 if dtype == torch.float64 else 4
        _, s, dt = make_state(torch, BIG, dtype, c0, seed=2, increment=True)
        k, p, h, k_ms, p_ms = time_kernel(
            torch, lambda: nlk.cloudsc2_nl_cuda(s, dt, c0), lambda: plain_nl(s, dt, c0), 10)
        # the function's bytes: 16 inputs read once, 10 outputs written, aph
        # and the 4 fluxes a row more (the kernel reads t and tnd_cml_t twice)
        nbytes = BIG * (NLEV * 26 + 5) * item
        timing[tag] = (k, p, h, *bound(nbytes, BIG * NLEV * NL_FLOPS, tag))
        print(f"[timing {tag} {BIG}x{NLEV}] kernel {k:.4f} ms ({BIG / k * 1e3:.4e} cols/s, "
              f"{nbytes / k / 1e6:.1f} GB/s), plain {p:.2f} ms ({BIG / p * 1e3:.4e} cols/s), "
              f"wrapper host time {h:.4f} ms per call (host clock, median of 10 x {KERNEL_BATCH} calls); "
              f"kernel runs {[round(x, 4) for x in k_ms]}; plain runs {[round(x, 1) for x in p_ms]}; {card}")
        # the fused kernel: the same 26 values (qsat written, not read), and
        # the two-stage path it replaces (Saturation's passes + the kernel)
        bare = {k: v for k, v in s.items() if k != "qsat"}
        k, p, h, k_ms, p_ms = time_kernel(
            torch, lambda: nlk.cloudsc2_nl_cuda(bare, dt, c0, fuse_saturation=True),
            lambda: plain_nl(bare, dt, c0, fuse_saturation=True), 3)
        two, _, two_ms = kernel_ms(
            torch, lambda: nlk.cloudsc2_nl_cuda(dict(bare, qsat=saturation(s["ap"], s["t"], c=c0)), dt, c0), 10)
        fused_timing[tag] = (k, p, h, *bound(nbytes, BIG * NLEV * NL_FLOPS, tag), two)
        print(f"[timing {tag} {BIG}x{NLEV} fused] kernel {k:.4f} ms ({BIG / k * 1e3:.4e} cols/s, "
              f"{nbytes / k / 1e6:.1f} GB/s; bound {fused_timing[tag][3]:.4f} ms by {fused_timing[tag][4]}: "
              f"{fused_timing[tag][3] / k:.3f} of it), plain fused {p:.2f} ms, wrapper host time {h:.4f} ms per "
              f"call; the two-stage Saturation + unfused kernel {two:.4f} ms (CUDA events, median of 10 x "
              f"{KERNEL_BATCH} calls); kernel runs {[round(x, 4) for x in k_ms]}; two-stage runs "
              f"{[round(x, 4) for x in two_ms]}; {card}")
        if dtype == torch.float32:
            for mode in ("faithful", "approx"):
                cm = c0.replace(FAST_DIV=mode)
                k, p, h, k_ms, p_ms = time_kernel(
                    torch, lambda cm=cm: nlk.cloudsc2_nl_cuda(bare, dt, cm, fuse_saturation=True),
                    lambda cm=cm: plain_nl(bare, dt, cm, fuse_saturation=True), 3)
                div_timing[mode] = (k, p, h)
                print(f"[timing f32 {BIG}x{NLEV} fused, divide {mode}] kernel {k:.4f} ms beside the exact "
                      f"divide's {fused_timing[tag][0]:.4f} ms ({k / fused_timing[tag][0]:.3f} of it), plain "
                      f"{p:.2f} ms, wrapper host time {h:.4f} ms per call; kernel runs "
                      f"{[round(x, 4) for x in k_ms]}; {card}")
        del bare
        # TL: 32 inputs read once and 20 outputs written per level (+2 aph
        # rows, +8 flux rows); tangent_only writes 10 (+4 flux rows)
        for only, nvals in ((False, (NLEV * 52 + 10)), (True, (NLEV * 42 + 6))):
            k, p, h, k_ms, p_ms = time_kernel(
                torch, lambda: tlk.cloudsc2_tl_cuda(s, dt, c0, tangent_only=only),
                lambda: plain_tl(s, dt, c0, tangent_only=only), 3)
            tl_timing[(tag, only)] = (k, p, h, *bound(BIG * nvals * item, BIG * NLEV * TL_FLOPS, tag))
            print(f"[tl-timing {tag} {BIG}x{NLEV}{' tangent_only' if only else ''}] kernel {k:.4f} ms "
                  f"({BIG / k * 1e3:.4e} cols/s, {BIG * nvals * item / k / 1e6:.1f} GB/s), "
                  f"plain {p:.2f} ms ({BIG / p * 1e3:.4e} cols/s), wrapper host time {h:.4f} ms per call "
                  f"(host clock, median of 10 x {KERNEL_BATCH} calls); kernel runs "
                  f"{[round(x, 4) for x in k_ms]}; plain runs {[round(x, 1) for x in p_ms]}; {card}")
        del s
    ad_time = ad_timing(torch, nlk, adk, build, plain_ad, plain_nl, c0, card)
    form_time = form_timing(torch, nlk, tlk, adk, build, c0, card)
    nl_occ = nl_occupancy(torch, nlk, c0, card)
    print(f"[timing] {time.perf_counter() - t0:.1f} s; {card}")
    phase_done("10 timing")

    # ---- 11. where the NL main paths' time goes (torch.profiler, f32, 65,536 columns)
    profiles = {fused: profile_main_path(torch, c0, card, fused) for fused in (True, False)}
    launch, launch_counts = launch_phase(torch, nlk, adk, card)
    phase_done("11 profile and launch path")

    # ---- 12. the probes: each kernel against its plain version, then through its driver
    probe_rows = probe_phase(torch, mbk, nlk, tlk, adk, c0, card)
    phase_done("12 probes")

    # ---- 13. the column-chunked stream and full_step, each path's counts from 0
    stream_readings = stream_phase(torch, nlk, tlk, adk, c0, card)
    phase_done("13 stream")

    # ---- 14. the column mesh on the one card, the counts from 0 over the phase
    mesh_readings = mesh_phase(torch, nlk, tlk, adk, c0, card)
    phase_done("14 mesh")

    print(f"[done] {time.perf_counter() - t_start:.1f} s; {card}")
    print(card)
    fwd32, rev32 = ad_time["f32"]["forward"], ad_time["f32"]["reverse"]
    fwd64, rev64 = ad_time["f64"]["forward"], ad_time["f64"]["reverse"]
    fused32, fused64 = ad_time["f32"]["fused rolled"], ad_time["f64"]["fused rolled"]
    res32, res64 = ad_time["f32"]["fused resident"], ad_time["f64"]["fused resident"]
    occ = {(tag, form): ad_time[tag][f"fused {form} occupancy"] for tag in ("f32", "f64")
           for form in ("rolled", "resident")}
    ref = REF_FORM[0]
    modes = [m for m, _ in DIV_FORMS]

    def path_launches(form, name):
        """Launches of the wrapper ``name`` in ``form`` on this slice's
        Taylor and symmetry paths (phases 8-9, counts from 0 in each)."""
        slot = 1 if form in modes else 2 if form == ref else 0
        return sum(counts[name][slot] for (_, _, f), counts in form_launches.items() if f == form)

    def ref_row(kernel, bound_f32, bound_f64, err):
        return {"ms": form_time[("f32", ref)][kernel], "ms_f64": form_time[("f64", ref)][kernel],
                "ms_compact": form_time[("f32", "default")][kernel],
                "ms_compact_f64": form_time[("f64", "default")][kernel], "bound_ms": bound_f32,
                "bound_ms_f64": bound_f64, "bound_by": "bytes", **err}

    def mode_row(mode, kernel, bound_f32, err):
        return {"ms": form_time[("f32", mode)][kernel], "ms_exact": form_time[("f32", "default")][kernel],
                "bound_ms": bound_f32, "bound_by": "bytes", **err}

    def launch_row(path):
        """The launch path's unprofiled readings of one path, by type and
        column count (phase 11)."""
        return {f"{tag} {ncols}": {k: launch[f"{tag} {ncols} {path}"][k]
                                   for k in ("host_ms", "device_ms", "step_ms", "step_mean_ms", "busy_share")}
                for tag in ("float32", "float64") for ncols in (BIG, 100)}

    nl_forms_json = {
        ref: ref_row("nl", timing["f32"][3], timing["f64"][3],
                     {"launches": path_launches(ref, "cloudsc2_nl_cuda"),
                      "max_abs_err": nl_forms[("ref", "f32", "default", BIG)],
                      "max_abs_err_f64": nl_forms[("ref", "f64", "default", BIG)]}),
        **{f"{m} unfused": mode_row(m, "nl", timing["f32"][3], {}) for m in modes},
    }
    tl_forms_json = {
        ref: ref_row("tl", tl_timing[("f32", False)][3], tl_timing[("f64", False)][3],
                     {"launches": path_launches(ref, "cloudsc2_tl_cuda"),
                      "max_abs_err": tl_forms[("ref", "f32", "default", BIG)],
                      "max_abs_err_f64": tl_forms[("ref", "f64", "default", BIG)]}),
        **{m: mode_row(m, "tl", tl_timing[("f32", False)][3],
                       {"launches": path_launches(m, "cloudsc2_tl_cuda"),
                        "max_scaled_err": tl_forms[(m, "f32", "default", BIG)][0],
                        "max_abs_err": tl_forms[(m, "f32", "default", BIG)][1],
                        "err_against": "the plain exact TL"}) for m in modes},
    }
    ad_forms_json = {
        ref: ref_row("ad", fused32[2], fused64[2],
                     {"rev_ms": form_time[("f32", ref)]["reverse"], "rev_ms_f64": form_time[("f64", ref)]["reverse"],
                      "launches": path_launches(ref, "cloudsc2_ad_cuda"),
                      "max_scaled_err": ad_forms[("ref", "f32", "default", BIG)][0],
                      "max_scaled_err_f64": ad_forms[("ref", "f64", "default", BIG)][0],
                      "max_abs_err": ad_forms[("ref", "f32", "default", BIG)][1],
                      "max_abs_err_f64": ad_forms[("ref", "f64", "default", BIG)][1],
                      "rev_registers": {t: form_time[(t, ref)]["reverse registers"] for t in ("f32", "f64")}}),
        **{m: mode_row(m, "ad", fused32[2],
                       {"rev_ms": form_time[("f32", m)]["reverse"],
                        "rev_ms_exact": form_time[("f32", "default")]["reverse"],
                        "rev_bound_ms": rev32[2], "launches": path_launches(m, "cloudsc2_ad_cuda"),
                        "max_scaled_err": ad_forms[(m, "f32", "default", BIG)][0],
                        "max_abs_err": ad_forms[(m, "f32", "default", BIG)][1],
                        "err_against": "the plain exact AD",
                        "rev_registers": form_time[("f32", m)]["reverse registers"]}) for m in modes},
        "LPHYLIN=False": {"launches": path_launches("LPHYLIN=False", "cloudsc2_ad_cuda"),
                          "bitwise_vs_lphylin_true": True,
                          "max_scaled_err": max(v[0] for k, v in ad_forms.items() if k[:2] == ("lphylin=False", "f32")),
                          "max_scaled_err_f64": max(v[0] for k, v in ad_forms.items()
                                                    if k[:2] == ("lphylin=False", "f64"))},
    }
    fused_forms_json = {
        ref: ref_row("fused rolled", fused32[2], fused64[2],
                     {"launches": fused_form_launches[ref][2], "bitwise_vs_two_kernel_ad": True,
                      "registers": {t: form_time[(t, ref)]["fused registers"] for t in ("f32", "f64")}}),
        **{m: mode_row(m, "fused rolled", fused32[2],
                       {"launches": fused_form_launches[m][1], "bitwise_vs_two_kernel_ad": True,
                        "registers": form_time[("f32", m)]["fused registers"]}) for m in modes},
        "LPHYLIN=False": {"launches": fused_form_launches["LPHYLIN=False"][0], "bitwise_vs_lphylin_true": True},
    }
    print(json.dumps({"kernels": [{
        "name": "cloudsc2_nl",
        "route": "cuda",
        "source": "cloudsc2_tpu_torch/kernels/csrc/nonlinear.cu",
        "replaces": "cloudsc2_tpu/pallas/nonlinear.py:76",
        "harness": "cloudsc2_tpu_torch/kernels/csrc/levelscan.cuh replaces cloudsc2_tpu/pallas/levelscan.py:402",
        "launches": launches,
        "max_abs_err": max_abs[("f32", "default", BIG)],
        "max_abs_err_f64": max_abs[("f64", "default", BIG)],
        "ms": timing["f32"][0],
        "plain_ms": timing["f32"][1],
        "ms_f64": timing["f64"][0],
        "plain_ms_f64": timing["f64"][1],
        "bound_ms": timing["f32"][3],
        "bound_by": timing["f32"][4],
        "bound_ms_f64": timing["f64"][3],
        "library_ms": None,
        "host_ms": timing["f32"][2],
        "host_ms_f64": timing["f64"][2],
        "ms_traj_only": ad_time["f32"]["traj_only forward"][0],
        "ms_traj_only_f64": ad_time["f64"]["traj_only forward"][0],
        "ms_fused": fused_timing["f32"][0],
        "plain_ms_fused": fused_timing["f32"][1],
        "ms_fused_f64": fused_timing["f64"][0],
        "plain_ms_fused_f64": fused_timing["f64"][1],
        "bound_ms_fused": fused_timing["f32"][3],
        "bound_ms_fused_f64": fused_timing["f64"][3],
        "ms_two_stage": fused_timing["f32"][5],
        "ms_two_stage_f64": fused_timing["f64"][5],
        "max_abs_err_fused_vs_two_stage": fused_abs[("f32", "default", BIG)],
        "max_abs_err_fused_vs_two_stage_f64": fused_abs[("f64", "default", BIG)],
        "ms_faithful": div_timing["faithful"][0],
        "plain_ms_faithful": div_timing["faithful"][1],
        "host_ms_faithful": div_timing["faithful"][2],
        "ms_approx": div_timing["approx"][0],
        "plain_ms_approx": div_timing["approx"][1],
        "launches_fast_div": fast_launches,
        "max_scaled_err_faithful": div_err[("faithful", "default", BIG, "fused")][0],
        "max_abs_err_faithful": div_err[("faithful", "default", BIG, "fused")][1],
        "max_scaled_err_approx": div_err[("approx", "default", BIG, "fused")][0],
        "max_abs_err_approx": div_err[("approx", "default", BIG, "fused")][1],
        "fast_div_err_against": "the plain exact version (fused form, f32)",
        "rcp_ulps": {m: v[0] for m, v in rcp_err.items()},
        "registers": nl_occ["f32 fused"]["registers"],
        "registers_f64": nl_occ["f64 fused"]["registers"],
        "blocks_per_sm": nl_occ["f32 fused"]["blocks_per_sm"],
        "blocks_per_sm_f64": nl_occ["f64 fused"]["blocks_per_sm"],
        "ring_depth": nl_occ["f32 fused"]["depth"],
        "ring_depth_f64": nl_occ["f64 fused"]["depth"],
        "occupancy": nl_occ,
        "card": card,
        "profile_fused": dict(zip(("wall_ms", "device_ms", "nl_kernel_ms", "other_ms"), profiles[True])),
        "profile_two_stage": dict(zip(("wall_ms", "device_ms", "nl_kernel_ms", "other_ms"), profiles[False])),
        "launch_path": launch_row("nl fused"),
        "launches_launch_path": launch_counts["cloudsc2_nl_cuda"],
        "forms": nl_forms_json,
        "launches_stream": stream_readings["launches"]["cloudsc2_nl_cuda stream"],
        "launches_full_step": stream_readings["launches"]["cloudsc2_nl_cuda full_step"],
        "launches_mesh": mesh_readings["launches"]["cloudsc2_nl_cuda"],
        "launches_mesh_processes": [p["launches"] for p in mesh_readings["processes"]],
        "mesh": {"forward": mesh_readings["forward"], "dryrun": mesh_readings["dryrun"],
                 "drivers": mesh_readings["drivers"]},
        "stream": {"sweeps": stream_readings["sweeps"], "yardsticks": stream_readings["yardsticks"],
                   "profile": stream_readings["profile"]},
        "shape": [NLEV, BIG],
    }, {
        "name": "cloudsc2_tl",
        "route": "cuda",
        "source": "cloudsc2_tpu_torch/kernels/csrc/tangent_linear.cu",
        "replaces": "cloudsc2_tpu/pallas/tangent_linear.py:69",
        "launches": tl_launches,
        "max_abs_err": tl_abs[("f32", "default", BIG)],
        "max_abs_err_f64": tl_abs[("f64", "default", BIG)],
        "ms": tl_timing[("f32", False)][0],
        "plain_ms": tl_timing[("f32", False)][1],
        "ms_f64": tl_timing[("f64", False)][0],
        "plain_ms_f64": tl_timing[("f64", False)][1],
        "ms_tangent_only": tl_timing[("f32", True)][0],
        "ms_tangent_only_f64": tl_timing[("f64", True)][0],
        "bound_ms": tl_timing[("f32", False)][3],
        "bound_by": tl_timing[("f32", False)][4],
        "bound_ms_f64": tl_timing[("f64", False)][3],
        "library_ms": None,
        "host_ms": tl_timing[("f32", False)][2],
        "host_ms_f64": tl_timing[("f64", False)][2],
        "forms": tl_forms_json,
        "launches_full_step": stream_readings["launches"]["cloudsc2_tl_cuda full_step"],
        "launches_mesh": mesh_readings["launches"]["cloudsc2_tl_cuda"],
        "shape": [NLEV, BIG],
    }, {
        "name": "cloudsc2_ad",
        "route": "cuda",
        "source": "cloudsc2_tpu_torch/kernels/csrc/adjoint.cu",
        "replaces": "cloudsc2_tpu/pallas/adjoint.py:125",
        "harness": "the reverse form of levelscan.cuh replaces cloudsc2_tpu/pallas/levelscan.py:402 (reverse=True)",
        "forward": "the NL kernel with_trajectory (cloudsc2_tpu/pallas/nonlinear.py:214-226)",
        "launches": ad_launches,
        "max_abs_err": ad_time["f32"]["err"][1],
        "max_abs_err_f64": ad_time["f64"]["err"][1],
        "max_scaled_err": ad_time["f32"]["err"][0],
        "max_scaled_err_f64": ad_time["f64"]["err"][0],
        "max_scaled_err_small": max(v[0] for k, v in ad_err.items() if k[0] == "f32"),
        "max_scaled_err_small_f64": max(v[0] for k, v in ad_err.items() if k[0] == "f64"),
        "scaled_err_ragged_f32": ad_err[("f32", "default", True, RAGGED)][0],
        "traj_max_abs_err": ad_time["f32"]["traj_abs"],
        "traj_max_abs_err_f64": ad_time["f64"]["traj_abs"],
        "ms": fwd32[0] + rev32[0],
        "fwd_ms": fwd32[0],
        "rev_ms": rev32[0],
        "plain_ms": ad_time["f32"]["plain"],
        "ms_f64": fwd64[0] + rev64[0],
        "fwd_ms_f64": fwd64[0],
        "rev_ms_f64": rev64[0],
        "plain_ms_f64": ad_time["f64"]["plain"],
        "bound_ms": fused32[2],
        "bound_by": fused32[3],
        "fwd_bound_ms": fwd32[2],
        "rev_bound_ms": rev32[2],
        "bound_ms_f64": fused64[2],
        "rev_registers": {"f32": ad_time["f32"]["reverse registers"], "f64": ad_time["f64"]["reverse registers"]},
        "rev_design": "the pipelined reverse scan: each level's 27 values (29 with evaporation) copied by "
                      "cp.async into a ring in shared memory while the levels below run",
        "rev_ring_depth": ad_time["f32"]["reverse registers"]["depth"],
        "rev_ring_depth_f64": ad_time["f64"]["reverse registers"]["depth"],
        "rev_shared_bytes": ad_time["f32"]["reverse registers"]["shared_bytes"],
        "rev_shared_bytes_f64": ad_time["f64"]["reverse registers"]["shared_bytes"],
        "rev_blocks_per_sm": ad_time["f32"]["reverse registers"]["blocks_per_sm"],
        "rev_blocks_per_sm_f64": ad_time["f64"]["reverse registers"]["blocks_per_sm"],
        "rev_ms_levapls2": ad_time["f32"]["reverse levapls2"][0],
        "rev_ms_levapls2_f64": ad_time["f64"]["reverse levapls2"][0],
        "rev_bound_ms_levapls2": ad_time["f32"]["reverse levapls2"][2],
        "rev_bound_ms_levapls2_f64": ad_time["f64"]["reverse levapls2"][2],
        "rev_registers_levapls2": {"f32": ad_time["f32"]["reverse levapls2 registers"],
                                   "f64": ad_time["f64"]["reverse levapls2 registers"]},
        "library_ms": None,
        "host_ms": fwd32[1] + rev32[1],
        "host_ms_f64": fwd64[1] + rev64[1],
        "ms_cotangent_only": ad_time["f32"]["cotangent_only step"][0],
        "launch_path_cotangent_only": launch_row("ad cotangent_only"),
        "launches_launch_path": launch_counts["cloudsc2_ad_cuda"],
        "ms_cotangent_only_f64": ad_time["f64"]["cotangent_only step"][0],
        "fwd_ms_traj_only": ad_time["f32"]["traj_only forward"][0],
        "fwd_ms_traj_only_f64": ad_time["f64"]["traj_only forward"][0],
        "bound_ms_cotangent_only": ad_time["f32"]["cotangent_only step"][2],
        "bound_ms_cotangent_only_f64": ad_time["f64"]["cotangent_only step"][2],
        "forms": ad_forms_json,
        "launches_full_step": stream_readings["launches"]["cloudsc2_ad_cuda full_step"],
        "launches_mesh": mesh_readings["launches"]["cloudsc2_ad_cuda"],
        "shape": [NLEV, BIG],
    }, {
        "name": "cloudsc2_ad_fused",
        "route": "cuda",
        "source": "cloudsc2_tpu_torch/kernels/csrc/ad_fused.cu",
        "replaces": "cloudsc2_tpu/pallas/adjoint.py:432",
        "harness": "level_scan_fwdrev_kernel of levelscan.cuh replaces cloudsc2_tpu/pallas/levelscan.py:87",
        "design": "the stack in a scratch of device memory ([slot][level][column], a write and a read a value), "
                  "blocks of 128, registers set the blocks per SM (fused_plan)",
        "threads_per_sm": {f"{form}_{tag}": occ[tag, form]["threads_per_sm"] for tag, form in occ},
        "launches": fused_launches,
        "max_abs_err": ad_time["f32"]["err"][1],
        "max_abs_err_f64": ad_time["f64"]["err"][1],
        "max_scaled_err": ad_time["f32"]["err"][0],
        "max_scaled_err_f64": ad_time["f64"]["err"][0],
        "bitwise_vs_two_kernel_ad": True,
        "ms": fused32[0],
        "plain_ms": ad_time["f32"]["plain"],
        "ms_f64": fused64[0],
        "plain_ms_f64": ad_time["f64"]["plain"],
        "ms_resident": res32[0],
        "ms_resident_f64": res64[0],
        "bound_ms": fused32[2],
        "bound_by": fused32[3],
        "bound_ms_f64": fused64[2],
        "library_ms": None,
        "host_ms": fused32[1],
        "host_ms_f64": fused64[1],
        "occupancy": {f"{form}_{tag}": occ[tag, form] for tag, form in occ},
        "registers": {f"{form}_{tag}": ad_time[tag][f"fused {form} registers"] for tag, form in occ},
        "forms": fused_forms_json,
        "shape": [NLEV, BIG],
    }, *probe_rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
