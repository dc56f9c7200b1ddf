# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Performance summary of the drivers; the port's own copy of
``performance_stats`` and ``print_performance`` of
:mod:`cloudsc2_tpu.utils.output` (reference ``drivers/run_nonlinear.py:121``).

Runtime mean ± stddev and MFLOPS mean ± stddev from the per-run runtimes.
The flop count per grid point is the JAX package's census of one NL level
plus one saturation level at the default switches (``FLOPS_PER_POINT`` of
:mod:`cloudsc2_tpu.utils.output`, which its tests pin to the census); the
port's tests hold the two equal.  Columns per second is the primary metric.
"""
from __future__ import annotations

from typing import Sequence, Tuple

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
