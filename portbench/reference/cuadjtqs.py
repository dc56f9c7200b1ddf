# Frozen copy of cloudsc2_tpu_torch/physics/cuadjtqs.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Saturation-adjustment clipping, nonlinear, tangent-linear and adjoint
parts; the port of :mod:`cloudsc2_tpu.physics.cuadjtqs` (``_select_phase:34``,
``_nl_iter:45``, ``cuadjtqs_nl:85``, ``_tl_iter:93``, ``cuadjtqs_tl:147``,
``_fwd_iter_traj:156``, ``cuadjtqs_ad:183``) in both of its forms:

* ``CUADJ_COMPACT=True`` (the default), the cor-free quotient

      cond = (q*u - s) * u / (u*u + s*z2s),   s = min(foeew/ap, ZQMAX),
      u = 1 - RETV*s

* ``CUADJ_COMPACT=False``, the reference-shaped form: ``qsat = s * cor``
  with ``cor = 1/(1 - RETV*s)``, ``cond = (q - qsat) / (1 + qsat*cor*z2s)``.

Two fixed iterations; the phase constants are chosen once from the input
temperature.  Every divide of the JAX functions divides under
``c.FAST_DIV`` (:mod:`cloudsc2_tpu_torch.physics.fastmath`).  The
reference-shaped form divides ``foeew`` (and, in the adjoint, ``qsat_i``)
by ``ap`` with :func:`div`: where the JAX form multiplies by ``1/ap``
under a non-exact mode, that is the same float32 arithmetic, and float64
divides exactly, as every other non-float32 divide.  Pointwise over
tensors of any shape.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .params import Constants
from .fastmath import div, is_fast, rcp, scalar, sel0, select


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
    """One adjustment iteration; its divides under ``c.FAST_DIV``
    (``cuadjtqs.py:67-82``)."""
    fd = c.FAST_DIV
    rt4 = rcp(t - p.z4es, fd)
    foeew = c.R2ES * torch.exp(p.z3es * (t - c.RTT) * rt4)
    z2s = p.z5alcp * rt4 * rt4
    if c.CUADJ_COMPACT:
        s = torch.clamp(foeew * (rap if rap is not None else rcp(ap, fd)), max=c.ZQMAX)
        u = 1.0 - c.RETV * s
        cond = div((q * u - s) * u, u * u + s * z2s, fd)
    else:
        qsat = torch.clamp(div(foeew, ap, fd), max=c.ZQMAX)
        cor = rcp(1.0 - c.RETV * qsat, fd)
        qsat = qsat * cor
        cond = div(q - qsat, 1.0 + qsat * cor * z2s, fd)
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
    """One TL iteration; ``qp`` is ``1/ap``, shared by both iterations.  In
    the compact form one reciprocal of the condensation denominator serves
    value and perturbation."""
    fd = c.FAST_DIV
    qp_i = -ap_i * qp * qp
    rt4 = rcp(t - p.z4es, fd)
    foeew = c.R2ES * torch.exp(p.z3es * (t - c.RTT) * rt4)
    foeew_i = foeew * p.z3es * t_i * (c.RTT - p.z4es) * rt4 * rt4
    qsat = qp * foeew
    qsat_i = qp_i * foeew + qp * foeew_i
    # the perturbation vanishes on the clipped branch
    noclip = qsat <= c.ZQMAX
    qsat = torch.clamp(qsat, max=c.ZQMAX)
    qsat_i = sel0(noclip, qsat_i)
    z2s = p.z5alcp * rt4 * rt4
    z2s_i = -2.0 * z2s * t_i * rt4
    if c.CUADJ_COMPACT:
        s, s_i = qsat, qsat_i
        u = 1.0 - c.RETV * s
        u_i = -c.RETV * s_i
        w = q * u - s
        num = w * u
        den = u * u + s * z2s
        num_i = (q_i * u + q * u_i - s_i) * u + w * u_i
        den_i = 2.0 * u * u_i + s_i * z2s + s * z2s_i
        rden = rcp(den, fd)
        cond = num * rden
        cond_i = (num_i - cond * den_i) * rden
    else:
        cor = rcp(1.0 - c.RETV * qsat, fd)
        cor_i = c.RETV * qsat_i * cor * cor
        qsat_i = qsat_i * cor + qsat * cor_i
        qsat = qsat * cor
        rdenom = rcp(1.0 + qsat * cor * z2s, fd)
        cond = (q - qsat) * rdenom
        cond_i = (q_i - qsat_i) * rdenom - (q - qsat) * (
            qsat_i * cor * z2s + qsat * cor_i * z2s + qsat * cor * z2s_i
        ) * rdenom * rdenom
    return t + p.zaldcp * cond, t_i + p.zaldcp * cond_i, q - cond, q_i - cond_i


def cuadjtqs_tl(
    ap: torch.Tensor, ap_i: torch.Tensor, t: torch.Tensor, t_i: torch.Tensor,
    q: torch.Tensor, q_i: torch.Tensor, c: Constants,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tangent-linear two-iteration saturation adjustment: ``(t, t_i, q, q_i)``."""
    p = _select_phase(t, c)
    qp = rcp(ap, c.FAST_DIV)
    t, t_i, q, q_i = _tl_iter(ap_i, t, t_i, q, q_i, p, c, qp)
    return _tl_iter(ap_i, t, t_i, q, q_i, p, c, qp)


def _fwd_iter_traj(ap, t, q, p: _Phase, c: Constants, rap: torch.Tensor):
    """One forward iteration and the trajectory its reverse sweep reads."""
    fd = c.FAST_DIV
    rt4 = rcp(t - p.z4es, fd)
    foeew = c.R2ES * torch.exp(p.z3es * (t - c.RTT) * rt4)
    z2s = p.z5alcp * rt4 * rt4
    if c.CUADJ_COMPACT:
        s0 = foeew * rap
        clip = s0 > c.ZQMAX
        s = torch.where(clip, scalar(c.ZQMAX, s0), s0)
        u = 1.0 - c.RETV * s
        w = q * u - s
        rden = rcp(u * u + s * z2s, fd)
        cond = w * u * rden
        traj = (t, q, foeew, s, u, z2s, w, rden, rt4, clip)
        return t + p.zaldcp * cond, q - cond, traj
    qsat0 = div(foeew, ap, fd)
    clip = qsat0 > c.ZQMAX
    qsat_unc = torch.where(clip, scalar(c.ZQMAX, qsat0), qsat0)
    cor = rcp(1.0 - c.RETV * qsat_unc, fd)
    qsat = qsat_unc * cor
    cond = div(q - qsat, 1.0 + qsat * cor * z2s, fd)
    traj = (t, q, foeew, qsat_unc, qsat, cor, z2s, clip)
    return t + p.zaldcp * cond, q - cond, traj


def cuadjtqs_ad(
    ap: torch.Tensor, ap_i: torch.Tensor, t: torch.Tensor, t_i: torch.Tensor,
    q: torch.Tensor, q_i: torch.Tensor, c: Constants,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adjoint of the two-iteration saturation adjustment: recompute both
    iterations storing their trajectory, then sweep back through iteration
    2 and iteration 1.  ``t_i``/``q_i`` are the output cotangents and
    ``ap_i`` the cotangent accumulated so far.  Returns ``(ap_i, t, t_i, q,
    q_i)`` with ``t, q`` the adjusted (forward) values and ``ap_i, t_i,
    q_i`` the input cotangents.  The compact branch is the exact transpose
    of the compact TL; the reference-shaped one follows the reference's
    hand-written adjoint (``cuadjtqs.py:226-256``)."""
    fd = c.FAST_DIV
    p = _select_phase(t, c)
    rap = rcp(ap, fd)
    t1, q1, traj1 = _fwd_iter_traj(ap, t, q, p, c, rap)
    t2, q2, traj2 = _fwd_iter_traj(ap, t1, q1, p, c, rap)
    qp_i = torch.zeros_like(ap)
    for traj in (traj2, traj1):
        if c.CUADJ_COMPACT:
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
            continue
        targ, q_in, foeew, qsat_unc, qsat, cor, z2s, clip = traj
        cond1_i = -q_i + p.zaldcp * t_i
        rdenom = rcp(1.0 + qsat * cor * z2s, fd)
        rt4 = rcp(targ - p.z4es, fd)
        q_i = q_i + cond1_i * rdenom
        wgt = cond1_i * (q_in - qsat) * rdenom * rdenom
        qsat_i = -cond1_i * rdenom - wgt * cor * z2s
        cor_i = -wgt * qsat * z2s
        z2s_i = -wgt * qsat * cor
        targ_i = -2.0 * z2s_i * p.z5alcp * rt4 * rt4 * rt4
        cor_i = cor_i + qsat_i * qsat_unc
        qsat_i = qsat_i * cor
        qsat_i = qsat_i + cor_i * c.RETV * cor * cor
        qsat_i = torch.where(clip, torch.zeros_like(qsat_i), qsat_i)
        foeew_i = div(qsat_i, ap, fd)
        qp_i = qp_i + qsat_i * foeew
        targ_i = targ_i + foeew_i * p.z3es * (c.RTT - p.z4es) * foeew * rt4 * rt4
        t_i = t_i + targ_i
    if c.CUADJ_COMPACT or is_fast(ap, fd):
        ap_i = ap_i - qp_i * rap * rap
    else:
        ap_i = ap_i - div(qp_i, ap * ap)
    return ap_i, t2, t_i, q2, q_i
