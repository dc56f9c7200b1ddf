# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Implementation dispatch by device; the port of
:mod:`cloudsc2_tpu.dispatch`.

The JAX package picks an implementation by an ``impl`` string.  Here the
tensors' device decides: CUDA tensors go to the hand-written kernel, CPU
tensors to the plain version.  There is no option that sends CUDA tensors
to the plain path, and no fall back from the kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.kernels.adjoint import cloudsc2_ad_cuda, cloudsc2_ad_fused_cuda
from cloudsc2_tpu_torch.kernels.nonlinear import cloudsc2_nl_cuda
from cloudsc2_tpu_torch.kernels.tangent_linear import cloudsc2_tl_cuda
from cloudsc2_tpu_torch.physics import adjoint as _plain_ad
from cloudsc2_tpu_torch.physics import nonlinear as _plain
from cloudsc2_tpu_torch.physics import tangent_linear as _plain_tl

Tensor = torch.Tensor


def cloudsc2_nl(
    state: Dict[str, Tensor], dt: float, c: Constants, fuse_saturation: bool = False, kflag: int = 1
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One NL step: the CUDA kernel for CUDA tensors, the plain level scan
    for CPU tensors.  With ``fuse_saturation`` the step diagnoses ``qsat``
    itself (``kflag`` and ``c.LPHYLIN`` pick the branch) and returns it
    among the diagnostics: the fused kernel, or the plain fused form."""
    device = state["ap"].device
    if device.type == "cuda":
        return cloudsc2_nl_cuda(state, dt, c, fuse_saturation=fuse_saturation, kflag=kflag)
    if device.type == "cpu":
        return _plain.cloudsc2_nl(state, dt, c, fuse_saturation=fuse_saturation, kflag=kflag)
    raise ValueError(f"no NL implementation for device {device}")


def cloudsc2_tl(
    state: Dict[str, Tensor], dt: float, c: Constants, tangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One TL step (the counterpart of ``nl_tl_fns(impl)[1]``): the CUDA
    kernel for CUDA tensors, the plain level scan for CPU tensors.  With
    ``tangent_only`` only the ``*_i`` outputs are returned."""
    device = state["ap"].device
    if device.type == "cuda":
        return cloudsc2_tl_cuda(state, dt, c, tangent_only)
    if device.type == "cpu":
        return _plain_tl.cloudsc2_tl(state, dt, c, tangent_only)
    raise ValueError(f"no TL implementation for device {device}")


def cloudsc2_ad(
    state: Dict[str, Tensor], dt: float, c: Constants, cotangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One AD step (the counterpart of ``tl_ad_fns(impl)[1]``): the CUDA
    kernels for CUDA tensors, the plain vjp of the TL for CPU tensors,
    under any ``LPHYLIN`` (the AD does not read it).  With
    ``cotangent_only`` only the cotangents are returned."""
    device = state["ap"].device
    if device.type == "cuda":
        return cloudsc2_ad_cuda(state, dt, c, cotangent_only)
    if device.type == "cpu":
        return _plain_ad.cloudsc2_ad(state, dt, c, cotangent_only)
    raise ValueError(f"no AD implementation for device {device}")


def cloudsc2_ad_fused(
    state: Dict[str, Tensor], dt: float, c: Constants, resident: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One AD step in one kernel (the counterpart of
    ``cloudsc2_ad_pallas_fused``): the fused CUDA kernel for CUDA tensors
    (``resident`` keeps the level inputs on its stack), for CPU tensors the
    plain AD, which computes the same function (``resident`` changes
    nothing there).  Unlike the Pallas kernel, which refuses
    ``LPHYLIN=False``, both take it: the AD does not read it."""
    device = state["ap"].device
    if device.type == "cuda":
        return cloudsc2_ad_fused_cuda(state, dt, c, resident)
    if device.type == "cpu":
        return _plain_ad.cloudsc2_ad(state, dt, c)
    raise ValueError(f"no AD implementation for device {device}")
