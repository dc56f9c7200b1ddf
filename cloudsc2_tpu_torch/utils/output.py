# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Performance reporting of the drivers: stdout summary and CSV writers; the
port's own copy of :mod:`cloudsc2_tpu.utils.output` (reference
``drivers/run_nonlinear.py:121-137, 221-232``).

Runtime mean ± stddev and MFLOPS mean ± stddev from the per-run runtimes.
The flop count per grid point is the JAX package's census of one NL level
plus one saturation level at the default switches (``FLOPS_PER_POINT`` of
:mod:`cloudsc2_tpu.utils.output`, which its tests pin to the census); the
port's tests hold the two equal.  Columns per second is the primary metric.

The CSV writers append one row keyed by host, precision, variant
(``{nl,tl,ad}-torch:{cuda,cpu}``), grid size, threads and runs; the
per-kernel variant writes one column per :class:`~cloudsc2_tpu_torch.utils.
timing.Timer` label, filtered by name patterns.  The port's tests hold the
files they write byte for byte equal to the JAX writers'.  The runtimes come
from the component layer, whose every call ends in a device sync, so a row
measures per-call latency, not pipelined throughput.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Sequence, Tuple

import numpy as np

#: flops per grid point of the NL step (the JAX package's census value)
FLOPS_PER_POINT = 360


def performance_stats(
    nx: int, runtimes_ms: Sequence[float], nlev: int = 137
) -> Tuple[float, float, float, float]:
    """Return ``(runtime_mean_ms, runtime_stddev_ms, mflops_mean, mflops_stddev)``."""
    rt = np.asarray(runtimes_ms, dtype=np.float64)
    mean = float(rt.mean())
    std = float(rt.std(ddof=1)) if rt.size > 1 else 0.0
    flops = FLOPS_PER_POINT * nlev * nx
    mflops = flops / (rt * 1e-3) / 1e6
    return mean, std, float(mflops.mean()), float(mflops.std(ddof=1)) if rt.size > 1 else 0.0


def print_performance(
    nx: int, runtimes_ms: Sequence[float], nlev: int = 137
) -> Tuple[float, float, float, float]:
    """Print and return runtime / MFLOPS statistics
    (reference ``run_nonlinear.py:121``)."""
    mean, std, mf_mean, mf_std = performance_stats(nx, runtimes_ms, nlev)
    n = len(runtimes_ms)
    print(
        f"Performance over {n} runs: {mean:.3f} ± {std:.3f} ms "
        f"({mf_mean:.2f} ± {mf_std:.2f} MFLOPS)"
    )
    return mean, std, mf_mean, mf_std


def _append_row(path: str, header: Sequence[str], row: Sequence) -> None:
    """Append a row, writing the header on first use.

    If the file already exists with a *different* header (e.g. a per-kernel
    CSV shared between protocols with different kernel label sets), the row
    is realigned to the existing header — missing columns become empty —
    and labels absent from the existing header raise rather than silently
    landing under wrongly-named columns.
    """
    exists = os.path.exists(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if exists:
        with open(path, newline="") as f:
            existing = next(csv.reader(f), None)
        if existing and list(existing) != list(header):
            by_name = dict(zip(header, row))
            extra = sorted(set(header) - set(existing))
            if extra:
                raise ValueError(
                    f"{path}: columns {extra} are not in the existing CSV "
                    f"header {existing}; write to a fresh file"
                )
            header, row = existing, [by_name.get(k, "") for k in existing]
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(header)
        w.writerow(row)


def write_performance_to_csv(
    path: str,
    *,
    host_name: str,
    precision: str,
    variant: str,
    num_cols: int,
    num_threads: int,
    num_runs: int,
    runtime_mean: float,
    runtime_stddev: float,
    mflops_mean: float,
    mflops_stddev: float,
) -> None:
    """Append one aggregate-performance row (reference CSV schema,
    ``run_nonlinear.py:123-137``)."""
    _append_row(
        path,
        [
            "date", "host", "precision", "variant", "num_cols", "num_threads",
            "num_runs", "runtime_mean", "runtime_stddev", "mflops_mean",
            "mflops_stddev",
        ],
        [
            _today(), host_name, precision, variant, num_cols, num_threads,
            num_runs, runtime_mean, runtime_stddev, mflops_mean, mflops_stddev,
        ],
    )


def write_stencils_performance_to_csv(
    path: str,
    *,
    host_name: str,
    precision: str,
    backend: str,
    num_cols: int,
    num_threads: int,
    num_runs: int,
    exec_info: Dict[str, float],
    key_patterns: Sequence[str],
) -> None:
    """Append one per-kernel-timings row, filtered by ``key_patterns``
    (reference ``run_nonlinear.py:221-232``; timings in ms)."""
    selected = {
        k: v for k, v in exec_info.items() if any(p in k for p in key_patterns)
    }
    header = ["date", "host", "precision", "backend", "num_cols", "num_threads", "num_runs"]
    row: list = [_today(), host_name, precision, backend, num_cols, num_threads, num_runs]
    for k in sorted(selected):
        header.append(k)
        row.append(selected[k])
    _append_row(path, header, row)


def _today() -> str:
    import datetime

    return datetime.date.today().isoformat()
