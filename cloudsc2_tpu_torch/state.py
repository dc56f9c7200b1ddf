# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""How the model's parameters reach the port.

CLOUDSC2 has no weights: its parameters are the
:class:`~cloudsc2_tpu_torch.params.Constants` and the input state.  The
state comes from the numpy I/O (:func:`cloudsc2_tpu_torch.iox.load_input`
or :func:`~cloudsc2_tpu_torch.iox.synthesize_input`) and becomes tensors
here; the constants become the kernels' argument structs.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.grid import Grid
from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.physics.nonlinear import lcrit_icrit

__all__ = ["NL_CONST_NAMES", "TL_CONST_NAMES", "kernel_constants", "state_from_numpy",
           "synthesize_state", "tl_kernel_constants"]

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}

#: field order of ``struct NLConst`` in ``kernels/csrc/nl_level.h``
#: (``CLOUDSC2_NL_CONSTS``); the kernel library reports its own order and
#: the wrapper checks the two agree
NL_CONST_NAMES = (
    "dt", "rdt", "ckcodtl", "ckcodti", "cons2", "cons3", "cons2_rlmlt", "meltp2",
    "rcpd", "rcpd_rvtmp2", "rcpd_inv", "rlmlt", "rlstt", "rlvtt",
    "rtt", "rtice", "rtwat", "rtwat_rtice_r", "rlptrc",
    "r2es", "r3les", "r3ies", "r4les", "r4ies", "r5les", "r5ies",
    "r5alvcp", "r5alscp", "ralvdcp", "ralsdcp",
    "retv", "zqmax", "cor_clip", "rg", "rd", "rlmin", "zeps2",
    "lcrit_k", "icrit_k", "dt_rg", "rg_rpecons", "sat_tice", "sat_twat_r", "zscal", "zeps1",
)

#: field order of ``struct TLConst`` in ``kernels/csrc/tl_level.h``
#: (``CLOUDSC2_TL_CONSTS``), checked against the library as the NL list is
TL_CONST_NAMES = (
    "dt", "rdt", "cons2", "cons3", "cons2_rlmlt", "meltp2",
    "rcpd", "rcpd_rvtmp2", "rcpd_inv", "rlmlt", "rlstt", "rlvtt",
    "rtt", "rtice", "rlptrc",
    "r2es", "r3les", "r3ies", "r4les", "r4ies", "r5les", "r5ies", "m2_r5les", "m2_r5ies",
    "r5alvcp", "r5alscp", "ralvdcp", "ralsdcp",
    "retv", "zqmax", "rg", "rd", "rlmin", "zeps2",
    "ckcodtl", "ckcodti", "lcrit_k", "icrit_k", "icrit_k2", "dl_k", "di_k",
    "dt_rg", "mdt_rg", "rg_rpecons", "beta_i_k", "zscal", "zeps1",
)


def state_from_numpy(
    state_np: Mapping[str, np.ndarray], device: torch.device, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """A numpy state as contiguous tensors of ``dtype`` on ``device``."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dtype)
        for k, v in state_np.items()
    }


def synthesize_state(
    ncols: int, nlev: int, seed: int, device: torch.device, dtype: torch.dtype
) -> Tuple[Grid, Dict[str, torch.Tensor], float]:
    """``(grid, state, dt)``: the seeded synthetic state
    (:func:`cloudsc2_tpu_torch.iox.synthesize_input`) as tensors on ``device``."""
    grid, state_np, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=seed)
    return grid, state_from_numpy(state_np, device, dtype), dt


def kernel_constants(c: Constants, dt: float, dtype: torch.dtype, kflag: int = 1) -> np.ndarray:
    """``Constants`` and ``dt`` folded into the NL kernel's constant struct.

    Compound constants are folded in double, as JAX folds them at trace
    time (``physics/nonlinear.py:189-191, 349, 371, 421``), and each is
    then rounded once to ``dtype``.  ``sat_tice``/``sat_twat_r`` are the
    liquid-fraction ramp of the fused saturation, picked as
    :func:`cloudsc2_tpu_torch.physics.saturation.saturation` picks its
    branch: ``foeewmcu``'s (RTICECU) for ``kflag`` 1 without ``LPHYLIN``,
    else ``foealfa``'s (RTICE).  ``zscal``/``zeps1`` are ``scalm``'s, which
    the kernels derive from ``eta`` (the TL's struct holds them too).
    Returns a contiguous array in the order of :data:`NL_CONST_NAMES`.
    """
    lcrit, icrit = lcrit_icrit(c)
    cons2 = 1.0 / (c.RG * dt)
    convective = not c.LPHYLIN and kflag == 1
    vals = {
        "dt": dt,
        "rdt": 1.0 / dt,
        "ckcodtl": 2.0 * c.RKCONV * dt,
        "ckcodti": 5.0 * c.RKCONV * dt,
        "cons2": cons2,
        "cons3": c.RLVTT / c.RCPD,
        "cons2_rlmlt": cons2 / c.RLMLT,
        "meltp2": c.RTT + 2.0,
        "rcpd": c.RCPD,
        "rcpd_rvtmp2": c.RCPD * c.RVTMP2,
        "rcpd_inv": 1.0 / c.RCPD,
        "rlmlt": c.RLMLT,
        "rlstt": c.RLSTT,
        "rlvtt": c.RLVTT,
        "rtt": c.RTT,
        "rtice": c.RTICE,
        "rtwat": c.RTWAT,
        "rtwat_rtice_r": c.RTWAT_RTICE_R,
        "rlptrc": c.RLPTRC,
        "r2es": c.R2ES,
        "r3les": c.R3LES,
        "r3ies": c.R3IES,
        "r4les": c.R4LES,
        "r4ies": c.R4IES,
        "r5les": c.R5LES,
        "r5ies": c.R5IES,
        "r5alvcp": c.R5ALVCP,
        "r5alscp": c.R5ALSCP,
        "ralvdcp": c.RALVDCP,
        "ralsdcp": c.RALSDCP,
        "retv": c.RETV,
        "zqmax": c.ZQMAX,
        "cor_clip": 1.0 / (1.0 - c.RETV * c.ZQMAX),
        "rg": c.RG,
        "rd": c.RD,
        "rlmin": c.RLMIN,
        "zeps2": c.ZEPS2,
        "lcrit_k": 1.0 / (lcrit * lcrit),
        "icrit_k": 1.0 / (icrit * icrit),
        "dt_rg": dt * c.RG,
        "rg_rpecons": c.RG * c.RPECONS,
        "sat_tice": c.RTICECU if convective else c.RTICE,
        "sat_twat_r": c.RTWAT_RTICECU_R if convective else c.RTWAT_RTICE_R,
        "zscal": c.ZSCAL,
        "zeps1": c.ZEPS1,
    }
    return np.array([float(vals[n]) for n in NL_CONST_NAMES], dtype=_NUMPY[dtype])


def tl_kernel_constants(c: Constants, dt: float, dtype: torch.dtype) -> np.ndarray:
    """``Constants`` and ``dt`` folded into the TL kernel's constant struct.

    As :func:`kernel_constants`: each compound constant is folded in double
    as JAX folds it at trace time, with the same operand order as the JAX
    expression, then rounded once to ``dtype``.  That covers
    ``ckcodtla``/``ckcodtia`` (``physics/tangent_linear.py:98-101``, inside
    ``dl_k``/``di_k`` with LREGCL on), the ``-2*R5*`` factors (``:156``),
    ``-dt*RG`` (``:399``) and the coefficients of ``beta`` and its
    derivative (``:535-541``).  Returns a contiguous array in the order of
    :data:`TL_CONST_NAMES`.
    """
    lcrit, icrit = lcrit_icrit(c)
    cons2 = 1.0 / (c.RG * dt)
    ckcodtl = 2.0 * c.RKCONV * dt
    ckcodti = 5.0 * c.RKCONV * dt
    lfactor = ckcodtl / 100.0 if c.LREGCL else ckcodtl
    ifactor = ckcodti / 100.0 if c.LREGCL else ckcodti
    vals = {
        "dt": dt,
        "rdt": 1.0 / dt,
        "cons2": cons2,
        "cons3": c.RLVTT / c.RCPD,
        "cons2_rlmlt": cons2 / c.RLMLT,
        "meltp2": c.RTT + 2.0,
        "rcpd": c.RCPD,
        "rcpd_rvtmp2": c.RCPD * c.RVTMP2,
        "rcpd_inv": 1.0 / c.RCPD,
        "rlmlt": c.RLMLT,
        "rlstt": c.RLSTT,
        "rlvtt": c.RLVTT,
        "rtt": c.RTT,
        "rtice": c.RTICE,
        "rlptrc": c.RLPTRC,
        "r2es": c.R2ES,
        "r3les": c.R3LES,
        "r3ies": c.R3IES,
        "r4les": c.R4LES,
        "r4ies": c.R4IES,
        "r5les": c.R5LES,
        "r5ies": c.R5IES,
        "m2_r5les": -2.0 * c.R5LES,
        "m2_r5ies": -2.0 * c.R5IES,
        "r5alvcp": c.R5ALVCP,
        "r5alscp": c.R5ALSCP,
        "ralvdcp": c.RALVDCP,
        "ralsdcp": c.RALSDCP,
        "retv": c.RETV,
        "zqmax": c.ZQMAX,
        "rg": c.RG,
        "rd": c.RD,
        "rlmin": c.RLMIN,
        "zeps2": c.ZEPS2,
        "ckcodtl": ckcodtl,
        "ckcodti": ckcodti,
        "lcrit_k": 1.0 / (lcrit * lcrit),
        "icrit_k": 1.0 / (icrit * icrit),
        "icrit_k2": 1.0 / icrit**2.0,
        "dl_k": 2.0 * lfactor / lcrit**2.0,
        "di_k": ifactor,
        "dt_rg": dt * c.RG,
        "mdt_rg": -dt * c.RG,
        "rg_rpecons": c.RG * c.RPECONS,
        "beta_i_k": 0.5777 * c.RG * c.RPECONS / 0.00509,
        "zscal": c.ZSCAL,
        "zeps1": c.ZEPS1,
    }
    return np.array([float(vals[n]) for n in TL_CONST_NAMES], dtype=_NUMPY[dtype])
