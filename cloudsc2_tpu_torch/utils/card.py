# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The card a measurement ran on, its published rates, and the time of a
run of calls on it, for ``chip_smoke.py`` and the drivers that time the
card (``drivers/microbench_*_torch.py``, ``drivers/kernel_ab_torch.py``).

A time taken on the CPU is host-clock time of the plain versions and says
nothing of a device: :func:`card_label` names it so.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

#: the H100's published rates (data sheet, SXM part, at 700 W): HBM bytes
#: per second and float32 operations per second outside the tensor cores;
#: and its L2 cache
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50e6

#: cycles of the sleep kernel that holds the device while the host enqueues
#: a timed run (about 10 ms at 2 GHz)
SLEEP_CYCLES = 20_000_000


def card_label(device: torch.device) -> str:
    """``nvidia-smi``'s ``name, power.limit`` of the card for a CUDA device;
    for the CPU a label that says its times are the plain versions' host
    times."""
    if device.type != "cuda":
        return "cpu (plain versions, host clock: no device timing)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[device.index or 0].strip()


def run_ms(fn: Callable[[], object], calls: int, device: torch.device, hold: bool = True) -> float:
    """Milliseconds of ``calls`` back-to-back calls of ``fn``.  On a CUDA
    device: CUDA events around the calls; with ``hold``, enqueued behind a
    sleep kernel (``torch.cuda._sleep``) so that the device runs them back
    to back whatever the host's time per call, and the events time the
    device; without it, a call's host time shows wherever the device
    drains the queue.  On the CPU: the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    if hold:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)
