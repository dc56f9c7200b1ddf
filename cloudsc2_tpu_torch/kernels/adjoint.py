# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The CLOUDSC2 adjoint kernels for Hopper and their wrapper.

Replaces the Pallas kernel :func:`cloudsc2_tpu.pallas.adjoint.
cloudsc2_ad_pallas` (``pallas/adjoint.py:125``) with its two kernels:

1. the forward sweep, the NL kernel with its trajectory
   (:func:`cloudsc2_tpu_torch.kernels.nonlinear.cloudsc2_nl_cuda` with
   ``with_trajectory``): the forward outputs and the carry entering each
   level;
2. the reverse sweep (``csrc/adjoint.cu`` over ``csrc/ad_level.h`` and the
   reverse form of ``csrc/levelscan.cuh``): one thread per column runs the
   levels bottom-up and applies the transpose of the TL level, built from
   its Jacobian columns, around the stored carry; it folds the raw fields
   and seeds and writes the 16 assembled input cotangents itself.

Its bound is set by bytes; this design's own operations (12-14 TL levels
per level) set its time, as the note at the top of ``adjoint.cu`` counts.
As the Pallas kernel, it
requires ``LPHYLIN=True``; unlike it, it takes f32 and f64 and any column
count.

:func:`cloudsc2_ad_cuda` launches both on CUDA tensors and raises for
anything else; its plain version is
:func:`cloudsc2_tpu_torch.physics.adjoint.cloudsc2_ad`.
:func:`cloudsc2_ad_host` runs the same bodies compiled for the CPU, for the
tests only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from cloudsc2_tpu_torch.kernels import build
from cloudsc2_tpu_torch.kernels.nonlinear import (
    NL_INPUTS,
    check_inputs,
    cloudsc2_nl_cuda,
    cloudsc2_nl_host,
    ptrs,
)
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.physics.adjoint import AD_COTANGENT_FIELDS, AD_TENDENCIES
from cloudsc2_tpu_torch.physics.nonlinear import TRAJ_OUTPUTS
from cloudsc2_tpu_torch.state import TL_CONST_NAMES, tl_kernel_constants

Tensor = torch.Tensor

#: the output cotangent seeds the reverse kernel reads
AD_SEEDS = (
    "tnd_t_i", "tnd_q_i", "tnd_ql_i", "tnd_qi_i", "clc_i", "covptot_i",
    "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i",
)
#: argument orders of ``CLOUDSC2_AD_INPUTS`` / ``_OUTPUTS`` in ``ad_level.h``
AD_INPUTS = NL_INPUTS[:-2] + AD_SEEDS + TRAJ_OUTPUTS + NL_INPUTS[-2:]
AD_OUTPUTS = tuple("cml_" + n + "_i" for n in AD_TENDENCIES) + (
    "ap_i", "aph_i", "t_i", "q_i", "qsat_i", "ql_i", "qi_i", "lu_i", "lude_i",
    "mfd_i", "mfu_i", "supsat_i",
)
_IFACE = ("aph", "aph_i", "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i")
#: read only with the evaporation branch (may be absent otherwise)
_EVAP_ONLY = ("c_cov", "covptot_i")

_P = ctypes.c_void_p
_ARGS = [ctypes.c_int] * 3 + [_P, _P, _P, ctypes.c_int, ctypes.c_int]


def signature() -> str:
    """The argument lists the Python side passes, in the form the kernel
    library reports them (``ad_signature`` in ``ad_level.h``)."""
    return "".join((
        "consts:", *(n + "," for n in TL_CONST_NAMES),
        ";inputs:", *(n + "," for n in AD_INPUTS),
        ";outputs:", *(n + "," for n in AD_OUTPUTS),
    ))


@functools.lru_cache(maxsize=None)
def _load(kind: str) -> ctypes.CDLL:
    if kind == "cuda":
        lib = build.load("cuda", "cloudsc2_ad", ["adjoint.cu"])
        fn = lib.cloudsc2_ad_launch
        fn.argtypes = _ARGS + [_P]
    else:
        lib = build.load("host", "cloudsc2_ad_host", ["adjoint_host.cpp"])
        fn = lib.cloudsc2_ad_host
        fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    lib.cloudsc2_ad_signature.restype = ctypes.c_char_p
    got = lib.cloudsc2_ad_signature().decode()
    if got != signature():
        raise RuntimeError(f"kernel argument lists differ from the wrapper's:\n{got}\n{signature()}")
    return lib


def load_cuda() -> ctypes.CDLL:
    """Build (first use) and load the CUDA library."""
    return _load("cuda")


def check_lphylin(c: Constants) -> None:
    """The kernel's forward sweep is the NL kernel, whose trajectory is the
    TL's forward only under linearized physics."""
    if not c.LPHYLIN:
        raise ValueError(
            "the AD kernel requires LPHYLIN=True (its forward sweep is the NL "
            "kernel, whose trajectory is the TL forward only under linearized physics)"
        )


def _reverse(state: Dict[str, Tensor], traj: Dict[str, Tensor], dt: float, c: Constants,
             device_type: str) -> Tuple[list, list, Tensor, Tuple[int, int, int]]:
    """Check the state, the seeds and the trajectory, and return the reverse
    kernel's inputs in order (``None`` for one it does not read), fresh
    outputs, the constant struct and the switches."""
    evap = bool(c.LEVAPLS2 or c.LDRAIN1D)
    names = [n for n in AD_INPUTS if evap or n not in _EVAP_ONLY]
    ins, dtype = check_inputs({**state, **traj}, c, device_type, names, _IFACE)
    by_name = dict(zip(names, ins))
    nlev, ncols = state["ap"].shape
    outs = [
        torch.empty((nlev + 1, ncols) if n in _IFACE else (nlev, ncols), dtype=dtype,
                    device=state["ap"].device)
        for n in AD_OUTPUTS
    ]
    consts = torch.from_numpy(tl_kernel_constants(c, dt, dtype))
    switches = (int(dtype == torch.float64), int(evap), int(bool(c.LREGCL)))
    return [by_name.get(n) for n in AD_INPUTS], outs, consts, switches


def _assemble(
    tends: Dict[str, Tensor], diags: Dict[str, Tensor], cot: Dict[str, Tensor]
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """``(tendencies, diagnostics)`` as :func:`cloudsc2_tpu_torch.physics.
    adjoint.cloudsc2_ad` returns them, from the forward outputs and the
    reverse kernel's cotangents."""
    tends = {**tends, **{n: cot[n] for n in AD_OUTPUTS[:4]}}
    diags = {**diags, **{n + "_i": cot[n + "_i"] for n in AD_COTANGENT_FIELDS}}
    return tends, diags


def cloudsc2_ad_reverse_cuda(
    state: Dict[str, Tensor], traj: Dict[str, Tensor], dt: float, c: Constants
) -> Dict[str, Tensor]:
    """The reverse kernel alone, on PyTorch's current stream: the 16 input
    cotangents (named as in ``AD_OUTPUTS``) from the state, its seeds and
    the forward trajectory ``traj``.  Each launch adds one to
    ``cloudsc2_ad_cuda.launches``."""
    check_lphylin(c)
    ins, outs, consts, switches = _reverse(state, traj, dt, c, "cuda")
    lib = load_cuda()
    nlev, ncols = state["ap"].shape
    with torch.cuda.device(state["ap"].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cloudsc2_ad_launch(*switches, ptrs(ins), ptrs(outs), consts.data_ptr(), nlev, ncols, stream)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad kernel launch failed: cudaError_t {err}")
    cloudsc2_ad_cuda.launches += 1
    return dict(zip(AD_OUTPUTS, outs))


def cloudsc2_ad_cuda(
    state: Dict[str, Tensor], dt: float, c: Constants
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One AD step through the CUDA kernels, on PyTorch's current stream:
    the NL kernel with its trajectory (counted in
    ``cloudsc2_nl_cuda.launches``), then the reverse kernel (counted in
    ``cloudsc2_ad_cuda.launches``).

    Same contract as :func:`cloudsc2_tpu_torch.physics.adjoint.
    cloudsc2_ad`: contiguous CUDA tensors of one float dtype, any
    ``ncols``.  Raises ``ValueError`` with ``LPHYLIN=False``, and raises on
    anything else the kernels do not take, on a failed build and on a
    refused launch; never falls back to the plain version.
    """
    check_lphylin(c)
    tends, diags, traj = cloudsc2_nl_cuda(state, dt, c, with_trajectory=True)
    return _assemble(tends, diags, cloudsc2_ad_reverse_cuda(state, traj, dt, c))


cloudsc2_ad_cuda.launches = 0  # type: ignore[attr-defined]


def cloudsc2_ad_host(
    state: Dict[str, Tensor], dt: float, c: Constants
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The kernels' bodies compiled for the host, on CPU tensors (tests
    only): the host NL body with its trajectory, then the reverse body."""
    check_lphylin(c)
    tends, diags, traj = cloudsc2_nl_host(state, dt, c, with_trajectory=True)
    ins, outs, consts, switches = _reverse(state, traj, dt, c, "cpu")
    lib = _load("host")
    nlev, ncols = state["ap"].shape
    err = lib.cloudsc2_ad_host(*switches, ptrs(ins), ptrs(outs), consts.data_ptr(), nlev, ncols)
    if err != 0:
        raise RuntimeError(f"cloudsc2_ad host body failed: {err}")
    return _assemble(tends, diags, dict(zip(AD_OUTPUTS, outs)))
