# Frozen copy of cloudsc2_tpu_torch/physics/fastmath.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Divide and select helpers; the port of :mod:`cloudsc2_tpu.physics.fastmath`
(``DIV_MODES``, ``rcp:51``, ``div:72``, ``sel0:94``).

JAX rounds a Python number to the array's dtype once (weak typing) and
then divides.  PyTorch computes ``number / tensor`` as
``reciprocal(tensor) * number``, and on CUDA ``tensor / number`` as
``tensor * (1 / number)``: both round twice.  :func:`div` therefore turns
a Python number into a 0-d tensor of the other operand's dtype and device
first, so every exact quotient is one IEEE division, as in JAX and in the
CUDA kernel.

The divide modes (``Constants.FAST_DIV``):

* ``"exact"``: one IEEE division (the default).
* ``"approx"``: an approximate reciprocal.  Inside the kernels it is the
  hardware's (``kernels/csrc/scalar_math.h``).  Here it is what Pallas
  interpret mode computes for ``pl.reciprocal(approx=True)``: its lowering
  (``_reciprocal_lowering_rule`` in ``jax/_src/pallas/primitives.py``)
  rounds ``x`` to bfloat16 and takes the reciprocal there, and XLA on the
  CPU computes that reciprocal in float32 and drops the round trip of its
  result through bfloat16 (the kernel's outputs are float32).  So: ``x``
  rounded to bfloat16, its float32 reciprocal, about 3.9e-3 relative
  error.
* ``"faithful"``: the approximate reciprocal and one Newton step,
  ``r * (2 - x * r)``.

Under a non-exact mode ``div(a, b)`` of a float32 ``b`` is ``a * rcp(b)``,
which rounds twice.  Any other dtype divides exactly, so float64 is bitwise
the exact path.  ``rcp`` of a 0-d operand is ``1/x``: JAX keeps ``1/x`` for
operands of fewer than two dimensions, which inside its kernels are the
per-level scalars, and in this port's level scan those are the 0-d rows of
``eta`` and ``scalm``.
"""
from __future__ import annotations

from typing import Union

import torch

Number = Union[float, int]

#: the divide modes of ``Constants.FAST_DIV``
DIV_MODES = ("exact", "faithful", "approx")


def scalar(x: Number, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``ref``'s dtype and device (rounded once)."""
    return torch.full((), x, dtype=ref.dtype, device=ref.device)


def is_fast(x: torch.Tensor, mode: str) -> bool:
    """Whether ``mode`` replaces the division by ``x`` (a float32 tensor)."""
    if mode not in DIV_MODES:
        raise ValueError(f"unknown divide mode {mode!r}; one of {DIV_MODES}")
    return mode != "exact" and x.dtype == torch.float32


def rcp(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """1/x under the divide mode (see the module docstring)."""
    if not is_fast(x, mode) or x.dim() == 0:
        return torch.reciprocal(x)
    r = torch.reciprocal(x.to(torch.bfloat16).to(torch.float32))
    if mode == "faithful":
        r = r * (2.0 - x * r)
    return r


def div(
    a: Union[torch.Tensor, Number], b: Union[torch.Tensor, Number], mode: str = "exact"
) -> torch.Tensor:
    """a/b under the divide mode; either operand may be a Python number."""
    if not isinstance(a, torch.Tensor):
        a = scalar(a, b)
    elif not isinstance(b, torch.Tensor):
        b = scalar(b, a)
    if is_fast(b, mode):
        return a * rcp(b, mode)
    return torch.div(a, b)


def sel0(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``where(p, x, 0)``."""
    return torch.where(p, x, torch.zeros_like(x))


def select(p: torch.Tensor, a: Number, b: Number, ref: torch.Tensor) -> torch.Tensor:
    """``where(p, a, b)`` for two Python numbers, in ``ref``'s dtype
    (``torch.where`` of two numbers would give the default dtype)."""
    return torch.where(p, scalar(a, ref), scalar(b, ref))
