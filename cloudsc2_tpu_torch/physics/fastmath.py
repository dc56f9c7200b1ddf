# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Divide and select helpers: the ``exact`` divide mode of
:mod:`cloudsc2_tpu.physics.fastmath` (``rcp:51``, ``div:72``, ``sel0:94``).

JAX rounds a Python number to the array's dtype once (weak typing) and
then divides.  PyTorch computes ``number / tensor`` as
``reciprocal(tensor) * number``, and on CUDA ``tensor / number`` as
``tensor * (1 / number)``: both round twice.  :func:`div` therefore turns
a Python number into a 0-d tensor of the other operand's dtype and device
first, so every quotient is one IEEE division, as in JAX and in the CUDA
kernel.  The ``approx``/``faithful`` modes (a hardware reciprocal inside
the TPU kernels) are not ported.
"""
from __future__ import annotations

from typing import Union

import torch

Number = Union[float, int]


def scalar(x: Number, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``ref``'s dtype and device (rounded once)."""
    return torch.full((), x, dtype=ref.dtype, device=ref.device)


def rcp(x: torch.Tensor) -> torch.Tensor:
    """1/x, one IEEE division."""
    return torch.reciprocal(x)


def div(a: Union[torch.Tensor, Number], b: Union[torch.Tensor, Number]) -> torch.Tensor:
    """a/b, one IEEE division; either operand may be a Python number."""
    if not isinstance(a, torch.Tensor):
        a = scalar(a, b)
    elif not isinstance(b, torch.Tensor):
        b = scalar(b, a)
    return torch.div(a, b)


def sel0(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``where(p, x, 0)``."""
    return torch.where(p, x, torch.zeros_like(x))


def select(p: torch.Tensor, a: Number, b: Number, ref: torch.Tensor) -> torch.Tensor:
    """``where(p, a, b)`` for two Python numbers, in ``ref``'s dtype
    (``torch.where`` of two numbers would give the default dtype)."""
    return torch.where(p, scalar(a, ref), scalar(b, ref))
