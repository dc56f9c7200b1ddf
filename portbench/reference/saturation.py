# Frozen copy of cloudsc2_tpu_torch/physics/saturation.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Saturation specific humidity; the port of
:func:`cloudsc2_tpu.physics.saturation.saturation` (both ``lphylin``
branches, ``kflag`` 1 and 2; its divides under ``c.FAST_DIV``).  It runs
before the NL kernel as plain tensor code, as the JAX package runs it in
XLA, or inside the kernel (``kernels/csrc/nl_level.h``, ``saturation``)
with ``fuse_saturation``."""
from __future__ import annotations

import torch

from .params import Constants
from . import fcttre
from .fastmath import div


def saturation(
    ap: torch.Tensor,
    t: torch.Tensor,
    *,
    kflag: int = 1,
    lphylin: bool = True,
    c: Constants,
) -> torch.Tensor:
    """Diagnose ``qsat`` from pressure ``ap`` and temperature ``t``."""
    if lphylin:
        alfa = fcttre.foealfa(t, c)
        ew = alfa * fcttre.foeew_liquid(t, c) + (1.0 - alfa) * fcttre.foeew_ice(t, c)
    else:
        ew = fcttre.foeewmcu(t, c) if kflag == 1 else fcttre.foeewm(t, c)
    qs = torch.clamp(div(ew, ap, c.FAST_DIV), max=c.ZQMAX)
    return div(qs, 1.0 - c.RETV * qs, c.FAST_DIV)
