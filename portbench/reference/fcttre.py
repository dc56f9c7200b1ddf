# Frozen copy of cloudsc2_tpu_torch/physics/fcttre.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Thermodynamic helper functions (IFS ``fcttre`` library); the port of
:mod:`cloudsc2_tpu.physics.fcttre`.  Pointwise over tensors of any shape;
the saturation pressures divide under ``c.FAST_DIV`` (``fcttre.py:33,38``)."""
from __future__ import annotations

import torch

from .params import Constants
from .fastmath import div


def foealfa(t: torch.Tensor, c: Constants) -> torch.Tensor:
    """Liquid fraction of mixed-phase condensate."""
    x = (torch.clamp(t, c.RTICE, c.RTWAT) - c.RTICE) * c.RTWAT_RTICE_R
    return torch.clamp(x * x, max=1.0)


def foealfcu(t: torch.Tensor, c: Constants) -> torch.Tensor:
    """Convective-scheme liquid fraction."""
    x = (torch.clamp(t, c.RTICECU, c.RTWAT) - c.RTICECU) * c.RTWAT_RTICECU_R
    return torch.clamp(x * x, max=1.0)


def foeew_liquid(t: torch.Tensor, c: Constants) -> torch.Tensor:
    """Saturation vapour pressure over liquid water."""
    return c.R2ES * torch.exp(div(c.R3LES * (t - c.RTT), t - c.R4LES, c.FAST_DIV))


def foeew_ice(t: torch.Tensor, c: Constants) -> torch.Tensor:
    """Saturation vapour pressure over ice."""
    return c.R2ES * torch.exp(div(c.R3IES * (t - c.RTT), t - c.R4IES, c.FAST_DIV))


def foeewm(t: torch.Tensor, c: Constants) -> torch.Tensor:
    """Mixed-phase saturation vapour pressure."""
    alfa = foealfa(t, c)
    return alfa * foeew_liquid(t, c) + (1.0 - alfa) * foeew_ice(t, c)


def foeewmcu(t: torch.Tensor, c: Constants) -> torch.Tensor:
    """Convective mixed-phase saturation vapour pressure."""
    alfa = foealfcu(t, c)
    return alfa * foeew_liquid(t, c) + (1.0 - alfa) * foeew_ice(t, c)
