# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Saturation-adjustment clipping, nonlinear, tangent-linear and adjoint
parts; the port of :mod:`cloudsc2_tpu.physics.cuadjtqs` (``_select_phase:34``,
``_nl_iter:45``, ``cuadjtqs_nl:85``, ``_tl_iter:93``, ``cuadjtqs_tl:147``,
``_fwd_iter_traj:155``, ``cuadjtqs_ad:183``) in its default
``CUADJ_COMPACT`` form:

    cond = (q*u - s) * u / (u*u + s*z2s),   s = min(foeew/ap, ZQMAX),
    u = 1 - RETV*s

Two fixed iterations; the phase constants are chosen once from the input
temperature.  Pointwise over tensors of any shape.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cloudsc2_tpu_torch.params import Constants
from cloudsc2_tpu_torch.physics.fastmath import div, rcp, scalar, sel0, select


class _Phase(NamedTuple):
    z3es: torch.Tensor
    z4es: torch.Tensor
    z5alcp: torch.Tensor
    zaldcp: torch.Tensor


def _select_phase(t: torch.Tensor, c: Constants) -> _Phase:
    """Liquid constants for ``t > RTT``, ice otherwise."""
    warm = t > c.RTT
    return _Phase(
        z3es=select(warm, c.R3LES, c.R3IES, t),
        z4es=select(warm, c.R4LES, c.R4IES, t),
        z5alcp=select(warm, c.R5ALVCP, c.R5ALSCP, t),
        zaldcp=select(warm, c.RALVDCP, c.RALSDCP, t),
    )


def _nl_iter(ap, t, q, p: _Phase, c: Constants, rap: Optional[torch.Tensor] = None):
    """One adjustment iteration (compact form); its divides under
    ``c.FAST_DIV`` (``cuadjtqs.py:67-74``)."""
    fd = c.FAST_DIV
    rt4 = rcp(t - p.z4es, fd)
    foeew = c.R2ES * torch.exp(p.z3es * (t - c.RTT) * rt4)
    s = torch.clamp(foeew * (rap if rap is not None else rcp(ap, fd)), max=c.ZQMAX)
    u = 1.0 - c.RETV * s
    z2s = p.z5alcp * rt4 * rt4
    cond = div((q * u - s) * u, u * u + s * z2s, fd)
    return t + p.zaldcp * cond, q - cond


def cuadjtqs_nl(
    ap: torch.Tensor, t: torch.Tensor, q: torch.Tensor, c: Constants,
    rap: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonlinear two-iteration saturation adjustment."""
    p = _select_phase(t, c)
    t, q = _nl_iter(ap, t, q, p, c, rap)
    t, q = _nl_iter(ap, t, q, p, c, rap)
    return t, q


def _tl_iter(ap_i, t, t_i, q, q_i, p: _Phase, c: Constants, qp: torch.Tensor):
    """One TL iteration (compact form); ``qp`` is ``1/ap``, shared by both
    iterations.  One reciprocal of the condensation denominator serves
    value and perturbation."""
    qp_i = -ap_i * qp * qp
    rt4 = rcp(t - p.z4es)
    foeew = c.R2ES * torch.exp(p.z3es * (t - c.RTT) * rt4)
    foeew_i = foeew * p.z3es * t_i * (c.RTT - p.z4es) * rt4 * rt4
    qsat = qp * foeew
    qsat_i = qp_i * foeew + qp * foeew_i
    # the perturbation vanishes on the clipped branch
    noclip = qsat <= c.ZQMAX
    s = torch.clamp(qsat, max=c.ZQMAX)
    s_i = sel0(noclip, qsat_i)
    z2s = p.z5alcp * rt4 * rt4
    z2s_i = -2.0 * z2s * t_i * rt4
    u = 1.0 - c.RETV * s
    u_i = -c.RETV * s_i
    w = q * u - s
    num = w * u
    den = u * u + s * z2s
    num_i = (q_i * u + q * u_i - s_i) * u + w * u_i
    den_i = 2.0 * u * u_i + s_i * z2s + s * z2s_i
    rden = rcp(den)
    cond = num * rden
    cond_i = (num_i - cond * den_i) * rden
    return t + p.zaldcp * cond, t_i + p.zaldcp * cond_i, q - cond, q_i - cond_i


def cuadjtqs_tl(
    ap: torch.Tensor, ap_i: torch.Tensor, t: torch.Tensor, t_i: torch.Tensor,
    q: torch.Tensor, q_i: torch.Tensor, c: Constants,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tangent-linear two-iteration saturation adjustment: ``(t, t_i, q, q_i)``."""
    p = _select_phase(t, c)
    qp = rcp(ap)
    t, t_i, q, q_i = _tl_iter(ap_i, t, t_i, q, q_i, p, c, qp)
    return _tl_iter(ap_i, t, t_i, q, q_i, p, c, qp)


def _fwd_iter_traj(ap, t, q, p: _Phase, c: Constants, rap: torch.Tensor):
    """One forward iteration (compact form) and the trajectory its reverse
    sweep reads."""
    rt4 = rcp(t - p.z4es)
    foeew = c.R2ES * torch.exp(p.z3es * (t - c.RTT) * rt4)
    s0 = foeew * rap
    clip = s0 > c.ZQMAX
    s = torch.where(clip, scalar(c.ZQMAX, s0), s0)
    u = 1.0 - c.RETV * s
    z2s = p.z5alcp * rt4 * rt4
    w = q * u - s
    rden = rcp(u * u + s * z2s)
    cond = w * u * rden
    traj = (t, q, foeew, s, u, z2s, w, rden, rt4, clip)
    return t + p.zaldcp * cond, q - cond, traj


def cuadjtqs_ad(
    ap: torch.Tensor, ap_i: torch.Tensor, t: torch.Tensor, t_i: torch.Tensor,
    q: torch.Tensor, q_i: torch.Tensor, c: Constants,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adjoint of the two-iteration saturation adjustment (compact form):
    recompute both iterations storing their trajectory, then sweep back
    through iteration 2 and iteration 1.  ``t_i``/``q_i`` are the output
    cotangents and ``ap_i`` the cotangent accumulated so far.  Returns
    ``(ap_i, t, t_i, q, q_i)`` with ``t, q`` the adjusted (forward) values
    and ``ap_i, t_i, q_i`` the input cotangents."""
    p = _select_phase(t, c)
    rap = rcp(ap)
    t1, q1, traj1 = _fwd_iter_traj(ap, t, q, p, c, rap)
    t2, q2, traj2 = _fwd_iter_traj(ap, t1, q1, p, c, rap)
    qp_i = torch.zeros_like(ap)
    for traj in (traj2, traj1):
        targ, q_in, foeew, s, u, z2s, w, rden, rt4, clip = traj
        cond_b = p.zaldcp * t_i - q_i
        w_b = u * rden * cond_b
        u_b = w * rden * cond_b
        den_b = -(w * u) * rden * rden * cond_b
        u_b = u_b + 2.0 * u * den_b
        s_b = z2s * den_b
        z2s_b = s * den_b
        q_i = q_i + u * w_b
        u_b = u_b + q_in * w_b
        s_b = s_b - w_b
        s_b = s_b - c.RETV * u_b
        s_b = torch.where(clip, torch.zeros_like(s_b), s_b)
        foeew_b = rap * s_b
        qp_i = qp_i + foeew * s_b
        rt4_b = 2.0 * p.z5alcp * rt4 * z2s_b
        e_b = foeew * foeew_b
        t_i = t_i + p.z3es * rt4 * e_b
        rt4_b = rt4_b + p.z3es * (targ - c.RTT) * e_b
        t_i = t_i - rt4 * rt4 * rt4_b
    ap_i = ap_i - qp_i * rap * rap
    return ap_i, t2, t_i, q2, q_i
