# Frozen copy of cloudsc2_tpu_torch/physics/tangent_linear.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLOUDSC2 tangent-linear scheme, plain PyTorch; the port of
:mod:`cloudsc2_tpu.physics.tangent_linear`.

Each forward intermediate ``x`` carries its perturbation ``x_i`` (dual-number
style).  With ``LREGCL`` on, four damping switches make this deliberately
not the exact Jacobian-vector product of the NL scheme (cloud-fraction
factor ``yyy``, subsidence ``0.1``, autoconversion ``/100``, clipping
``0.7``); with it off, the operator equals ``torch.func.jvp`` of
:func:`cloudsc2_tpu_torch.physics.nonlinear.cloudsc2_nl` up to rounding.
The TL always uses the linearized-physics ``tanh`` water fraction and
always clips ``esdp``.

This is the plain version of the TL kernel
(:mod:`cloudsc2_tpu_torch.kernels.tangent_linear`): ``kernels/csrc/
tl_level.h`` is the same sequence of roundings, and :func:`cloudsc2_tl`
runs the level body through the plain level scan.  Each expression mirrors
its JAX counterpart operand for operand (``x**2.0``/``x**3.0`` written as
products, ``lax.rsqrt`` as ``1/sqrt``); every ``where`` keeps the guarded
operands of the JAX body.  Nothing is written in place, so that
``torch.func`` transforms apply.  Every divide that the JAX body routes
through ``fastmath`` divides under ``c.FAST_DIV`` here too (the per-level
scalar ``1 - scalm`` is a 0-d operand, which divides exactly, as in the
Pallas kernel); both ``CUADJ_COMPACT`` forms of the saturation adjustment
are ported.  ``MASK_SELECT`` is bit-identical to the select form and is
ignored.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .params import Constants
from .levelscan import level_scan
from .cuadjtqs import cuadjtqs_tl
from .fastmath import div, rcp, sel0, select
from .nonlinear import (
    Coeffs,
    check_constants,
    critical_rh,
    critical_rh_coeffs,
    lcrit_icrit,
    prepare_level_inputs,
    tropopause_eta,
)

Tensor = torch.Tensor

#: the scheme's outputs, in the order of the JAX component contract
TEND_NAMES = ("t", "q", "ql", "qi")
FLUX_NAMES = ("fplsl", "fplsn")


class TLCarry(NamedTuple):
    """State carried down the levels, with its perturbation."""

    rfl: Tensor
    sfl: Tensor
    covptot: Tensor
    rfl_i: Tensor
    sfl_i: Tensor
    covptot_i: Tensor


def tl_level_pre(
    x: Dict[str, Tensor], aph_s: Tensor, trpaus: Tensor, dt: float, c: Constants,
    coeffs: Optional[Coeffs] = None,
) -> Dict[str, Tensor]:
    """Carry-independent part of one TL level (phase A): first guess,
    thermodynamic coefficients, dqs/dT, critical humidity, cloud cover,
    detrainment, subsidence, condensation rates, melt constants, the liquid
    autoconversion and the melt-free half of the ice autoconversion, each
    with its perturbation.  The three in-loop LREGCL switches live here."""
    fd = c.FAST_DIV
    ap, ap_i = x["ap"], x["ap_i"]
    qsat_in, qsat_in_i = x["qsat"], x["qsat_i"]

    # first-guess state and perturbations
    t = x["t_fg"]
    t_i = x["t_i"] + dt * x["tnd_cml_t_i"]
    q = x["q"] + dt * x["tnd_cml_q"] + x["supsat"]
    q_i = x["q_i"] + dt * x["tnd_cml_q_i"] + x["supsat_i"]
    ql = x["ql"] + dt * x["tnd_cml_ql"]
    ql_i = x["ql_i"] + dt * x["tnd_cml_ql_i"]
    qi = x["qi"] + dt * x["tnd_cml_qi"]
    qi_i = x["qi_i"] + dt * x["tnd_cml_qi_i"]

    cons2 = 1.0 / (c.RG * dt)
    cons3 = c.RLVTT / c.RCPD
    meltp2 = c.RTT + 2.0
    scalm = x["scalm"]

    # thermodynamic coefficients, one shared reciprocal of D
    dp = x["aph1"] - x["aph0"]
    dp_i = x["aph1_i"] - x["aph0_i"]
    zd = c.RCPD + c.RCPD * c.RVTMP2 * q
    zd_i = c.RCPD * c.RVTMP2 * q_i
    zz = rcp(zd, fd)
    zz_i = -zd_i * (zz * zz)
    lfdcp = c.RLMLT * zz
    lfdcp_i = c.RLMLT * zz_i
    lsdcp = c.RLSTT * zz
    lsdcp_i = c.RLSTT * zz_i
    lvdcp = c.RLVTT * zz
    lvdcp_i = c.RLVTT * zz_i

    # dqs/dT correction factor; always the tanh branch
    cold = t < c.RTT
    th = torch.tanh(0.17 * (t - c.RLPTRC))
    fwat = torch.where(cold, 0.545 * (th + 1.0), 1.0)
    fwat_i = sel0(cold, 0.545 * 0.17 * t_i * (1.0 - th * th))
    z3es = select(cold, c.R3IES, c.R3LES, t)
    z4es = select(cold, c.R4IES, c.R4LES, t)
    rl = rcp(t - c.R4LES, fd)
    ri = rcp(t - c.R4IES, fd)
    rz4es = torch.where(cold, ri, rl)
    rap = rcp(ap, fd)
    foeew = c.R2ES * torch.exp(z3es * (t - c.RTT) * rz4es)
    foeew_i = z3es * (c.RTT - z4es) * t_i * foeew * (rz4es * rz4es)
    esdp = foeew * rap
    esdp_i = (foeew_i - esdp * ap_i) * rap
    noclip = esdp <= c.ZQMAX
    esdp = torch.clamp(esdp, max=c.ZQMAX)
    esdp_i = sel0(noclip, esdp_i)

    facw = c.R5LES * (rl * rl)
    facw_i = -2.0 * c.R5LES * t_i * (rl * rl * rl)
    faci = c.R5IES * (ri * ri)
    faci_i = -2.0 * c.R5IES * t_i * (ri * ri * ri)
    fac = fwat * facw + (1.0 - fwat) * faci
    fac_i = fwat_i * (facw - faci) + fwat * facw_i + (1.0 - fwat) * faci_i
    cor = rcp(1.0 - c.RETV * esdp, fd)
    cor_i = c.RETV * esdp_i * (cor * cor)
    dqsdtemp = fac * cor * qsat_in
    dqsdtemp_i = fac_i * cor * qsat_in + fac * cor_i * qsat_in + fac * cor * qsat_in_i
    corqs = 1.0 + cons3 * dqsdtemp
    corqs_i = cons3 * dqsdtemp_i

    # clipped state
    overs = q > qsat_in
    qlim = torch.minimum(q, qsat_in)
    qlim_i = torch.where(overs, qsat_in_i, q_i)

    # critical humidity and ice supersaturation
    crh2 = critical_rh(x["eta"], trpaus, coeffs)
    cold_ice = t < c.RTICE
    supsat_fac = torch.where(cold_ice, 1.8 - 0.003 * t, 1.0)
    supsat_fac_i = sel0(cold_ice, -0.003 * t_i)
    qsat = qsat_in * supsat_fac
    qsat_i = qsat_in_i * supsat_fac + qsat_in * supsat_fac_i
    qcrit = crh2 * qsat
    qcrit_i = crh2 * qsat_i

    # cloud cover and its perturbation
    qt = q + ql + qi
    qt_i = q_i + ql_i + qi_i
    low = qt < qcrit
    high = qt >= qsat
    mid = torch.logical_not(low | high)
    qpd = qsat - qt
    qpd_i = qsat_i - qt_i
    qcd = qsat - qcrit
    qcd_i = qsat_i - qcrit_i
    denom = qcd - scalm * (qt - qcrit)
    denom_safe = torch.where(mid, denom, 1.0)
    rdenom = rcp(denom_safe, fd)
    ratio = sel0(mid, qpd * rdenom)
    tmp1 = torch.sqrt(ratio)
    clc_mid = 1.0 - tmp1
    rtmp1 = rcp(torch.sqrt(torch.where(mid, ratio, 1.0)))  # lax.rsqrt: exact
    clc_mid_i = (
        -0.5
        * rtmp1
        * (qpd_i * denom - qpd * (qcd_i - scalm * (qt_i - qcrit_i)))
        * (rdenom * rdenom)
    )
    if c.LREGCL:
        # regularization of the cloud-fraction perturbation
        qcd_safe = torch.where(mid, qcd, 1.0)
        rat = div(qpd, qcd_safe, fd)
        u = 1.0 - scalm * (1.0 - rat)
        yyy = torch.clamp(
            div(3.5 * torch.sqrt(torch.clamp(rat * (u * u * u), min=0.0)), 1.0 - scalm, fd),
            max=0.3,
        )
        clc_mid_i = clc_mid_i * yyy
    qc_mid = (scalm * qpd + (1.0 - scalm) * qcd) * (clc_mid * clc_mid)
    qc_mid_i = (scalm * qpd_i + (1.0 - scalm) * qcd_i) * (clc_mid * clc_mid) + 2.0 * (
        scalm * qpd + (1.0 - scalm) * qcd
    ) * clc_mid * clc_mid_i
    qc_high = (1.0 - scalm) * (qsat - qcrit)
    qc_high_i = (1.0 - scalm) * (qsat_i - qcrit_i)
    clc = torch.where(low, 0.0, torch.where(high, 1.0, clc_mid))
    clc_i = torch.where(low, 0.0, torch.where(high, 0.0, clc_mid_i))
    qc = torch.where(low, 0.0, torch.where(high, qc_high, qc_mid))
    qc_i = torch.where(low, 0.0, torch.where(high, qc_high_i, qc_mid_i))

    # convective detrainment; one reciprocal each of dp and lu1_safe
    rdp = rcp(dp, fd)
    gdp = c.RG * rdp
    gdp_i = -c.RG * dp_i * (rdp * rdp)
    lude = dt * x["lude"] * gdp
    lude_i = dt * (x["lude_i"] * gdp + x["lude"] * gdp_i)
    lu1 = x["lu_next"]
    lu1_i = x["lu_next_i"]
    lo1 = (lude >= c.RLMIN) & (lu1 >= c.ZEPS2)
    lu1_safe = torch.where(lo1, lu1, 1.0)
    rlu1 = rcp(lu1_safe, fd)
    tmp2 = torch.exp(-lude * rlu1)
    clc_i_conv = -clc_i * (1.0 - tmp2) + (1.0 - clc) * tmp2 * (
        (lude_i - lude * lu1_i * rlu1) * rlu1
    )
    clc_i = clc_i + sel0(lo1, clc_i_conv)
    clc = clc + sel0(lo1, (1.0 - clc) * (1.0 - tmp2))
    qc = qc + sel0(lo1, lude)
    qc_i = qc_i + sel0(lo1, lude_i)

    # compensating subsidence
    fac1 = rcp(c.RD * t, fd)
    rho = ap * fac1
    rho_i = (ap_i - ap * t_i * (c.RD * fac1)) * fac1
    fac2 = rcp(ap - c.RETV * foeew, fd)
    rodqsdp = -rho * qsat_in * fac2
    rodqsdp_i = (
        -rho_i * qsat_in
        - rho * qsat_in_i
        + rho * qsat_in * (ap_i - c.RETV * foeew_i) * fac2
    ) * fac2
    ldcp = fwat * lvdcp + (1.0 - fwat) * lsdcp
    ldcp_i = fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (1.0 - fwat) * lsdcp_i
    fac3 = rcp(1.0 + ldcp * dqsdtemp, fd)
    dtdzmo = c.RG * (1.0 / c.RCPD - ldcp * rodqsdp) * fac3
    dtdzmo_i = (
        -(
            c.RG * (ldcp_i * rodqsdp + ldcp * rodqsdp_i)
            + dtdzmo * (ldcp_i * dqsdtemp + ldcp * dqsdtemp_i)
        )
        * fac3
    )
    dqsdz = dqsdtemp * dtdzmo - c.RG * rodqsdp
    dqsdz_i = dqsdtemp_i * dtdzmo + dqsdtemp * dtdzmo_i - c.RG * rodqsdp_i
    fac4 = c.RD * t * rap
    mf = x["mfu"] + x["mfd"]
    mf_i = x["mfu_i"] + x["mfd_i"]
    sub = dt * dqsdz * mf * fac4
    lo3 = sub < qc
    dqc = torch.where(lo3, sub, qc)
    dqc_i_sub = (dt * (dqsdz_i * mf + dqsdz * mf_i) - dqc * rho_i) * fac4
    if c.LREGCL:
        dqc_i_sub = dqc_i_sub * 0.1
    qc = sel0(lo3, qc - sub)
    qc_i = sel0(lo3, qc_i - dqc_i_sub)

    # new condensate and condensation rates
    qlwc = qc * fwat
    qlwc_i = qc_i * fwat + qc * fwat_i
    qiwc = qc * (1.0 - fwat)
    qiwc_i = qc_i * (1.0 - fwat) - qc * fwat_i
    rdt = 1.0 / dt
    condl = (qlwc - ql) * rdt
    condl_i = (qlwc_i - ql_i) * rdt
    condi = (qiwc - qi) * rdt
    condi_i = (qiwc_i - qi_i) * rdt

    # melt constants, division-free (rcons = 1/cons exactly); the min()
    # against the snow-flux carry is phase B
    cons = (cons2 / c.RLMLT) * dp * zd
    cons_i = (cons2 / c.RLMLT) * (dp_i * zd + dp * zd_i)
    rcons = dt * gdp * lfdcp
    rcons_i = dt * (gdp_i * lfdcp + gdp * lfdcp_i)
    warm = t > meltp2
    z2s = cons * torch.clamp(t - meltp2, min=0.0)
    z2s_i = sel0(warm, cons_i * (t - meltp2) + cons * t_i)

    # autoconversion of cloud water, and the carry-free half for ice; one
    # reciprocal of the cloud fraction serves both species
    act = clc > c.ZEPS2
    lcrit, icrit = lcrit_icrit(c)
    ckcodtl = 2.0 * c.RKCONV * dt
    clc_safe = torch.where(act, clc, 1.0)
    rclc = rcp(clc_safe, fd)
    cldl = qlwc * rclc
    cldl_i = (qlwc_i - cldl * clc_i) * rclc
    ltmp4 = torch.exp(-(cldl * cldl * (1.0 / (lcrit * lcrit))))
    dl = ckcodtl * (1.0 - ltmp4)
    ltmp5 = torch.exp(-dl)
    lfactor = ckcodtl / 100.0 if c.LREGCL else ckcodtl
    dl_i = (2.0 * lfactor / lcrit**2.0) * ltmp4 * cldl * cldl_i
    qlnew = clc * cldl * ltmp5
    qlnew_i = clc_i * cldl * ltmp5 + clc * cldl_i * ltmp5 - clc * cldl * ltmp5 * dl_i
    prr = sel0(act, qlwc - qlnew)
    prr_i = sel0(act, qlwc_i - qlnew_i)
    qlwc = qlwc - prr
    qlwc_i = qlwc_i - prr_i
    cldi = qiwc * rclc
    cldi_i = (qiwc_i - cldi * clc_i) * rclc
    itmp41 = torch.exp(-(cldi * cldi * (1.0 / (icrit * icrit))))

    pre = dict(
        t2=t, t2_i=t_i, q2=q, q2_i=q_i, qi_fg=qi, qi_fg_i=qi_i, dp=dp, dp_i=dp_i,
        gdp=gdp, gdp_i=gdp_i, lvdcp=lvdcp, lvdcp_i=lvdcp_i, lsdcp=lsdcp, lsdcp_i=lsdcp_i,
        fwat=fwat, fwat_i=fwat_i, clc=clc, clc_i=clc_i,
        condl1=condl, condl1_i=condl_i, condi1=condi, condi1_i=condi_i,
        qiwc1=qiwc, qiwc1_i=qiwc_i, prr=prr, prr_i=prr_i,
        cldi=cldi, cldi_i=cldi_i, itmp41=itmp41, act=act,
        rcons=rcons, rcons_i=rcons_i, z2s=z2s, z2s_i=z2s_i,
        tnd_ql=(qlwc - ql) * rdt, tnd_ql_i=(qlwc_i - ql_i) * rdt,
    )
    if c.LEVAPLS2 or c.LDRAIN1D:
        # carry-free factors of the precipitation evaporation
        pre.update(
            qlim=qlim, qlim_i=qlim_i, corqs=corqs, corqs_i=corqs_i,
            tmp6=torch.sqrt(div(ap, aph_s, fd)),
            dtgdp=div(dt * c.RG, dp, fd),
            dtgdp_i=div(-dt * c.RG * dp_i, dp * dp, fd),
        )
    return pre


def tl_level_post(
    carry: TLCarry, xp: Dict[str, Tensor], aph_s: Tensor, aph_s_i: Tensor, dt: float,
    c: Constants,
) -> Tuple[TLCarry, Dict[str, Tensor]]:
    """Carry-dependent tail of one TL level (phase B): precipitation
    overlap, snow melt, the melt-temperature half of the ice
    autoconversion, rain fraction, precipitation evaporation, tendencies and
    the final clipping.  ``xp`` is the level's raw inputs merged with
    :func:`tl_level_pre`."""
    rfl, sfl, covptot, rfl_i, sfl_i, covptot_i = carry
    fd = c.FAST_DIV
    ckcodti = 5.0 * c.RKCONV * dt
    cons2 = 1.0 / (c.RG * dt)
    rdt = 1.0 / dt
    _, icrit = lcrit_icrit(c)
    ap, ap_i = xp["ap"], xp["ap_i"]
    qsat_in, qsat_in_i = xp["qsat"], xp["qsat_i"]
    t, t_i = xp["t2"], xp["t2_i"]
    q, q_i = xp["q2"], xp["q2_i"]
    qi, qi_i = xp["qi_fg"], xp["qi_fg_i"]
    dp, dp_i = xp["dp"], xp["dp_i"]
    gdp, gdp_i = xp["gdp"], xp["gdp_i"]
    lvdcp, lvdcp_i = xp["lvdcp"], xp["lvdcp_i"]
    lsdcp, lsdcp_i = xp["lsdcp"], xp["lsdcp_i"]
    fwat, fwat_i = xp["fwat"], xp["fwat_i"]
    clc, clc_i = xp["clc"], xp["clc_i"]
    condl, condl_i = xp["condl1"], xp["condl1_i"]
    condi, condi_i = xp["condi1"], xp["condi1_i"]
    qiwc, qiwc_i = xp["qiwc1"], xp["qiwc1_i"]
    prr, prr_i = xp["prr"], xp["prr_i"]
    cldi, cldi_i = xp["cldi"], xp["cldi_i"]
    itmp41, act = xp["itmp41"], xp["act"]
    rcons, rcons_i = xp["rcons"], xp["rcons_i"]
    z2s, z2s_i = xp["z2s"], xp["z2s_i"]
    lude, lude_i = xp["lude"], xp["lude_i"]

    # maximum precipitation overlap
    grow = clc > covptot
    covptot = torch.maximum(covptot, clc)
    covptot_i = torch.where(grow, clc_i, covptot_i)
    covpclr1 = covptot - clc
    pos = covpclr1 >= 0.0
    covpclr = torch.clamp(covpclr1, min=0.0)
    covpclr_i = sel0(pos, covptot_i - clc_i)

    # melting of incoming snow
    melt = sfl != 0.0
    take_sfl = sfl <= z2s
    snmlt = torch.minimum(sfl, z2s)
    snmlt_i = torch.where(take_sfl, sfl_i, z2s_i)
    sm = sel0(melt, snmlt)
    smi = sel0(melt, snmlt_i)
    rfln = rfl + sm
    rfln_i = rfl_i + smi
    sfln = sfl - sm
    sfln_i = sfl_i - smi
    t_i = t_i - (smi * rcons + sm * rcons_i)
    t = t - sm * rcons

    # melt-temperature half of the ice autoconversion
    itmp42 = torch.exp(0.025 * (t - c.RTT))
    di = ckcodti * itmp42 * (1.0 - itmp41)
    itmp5 = torch.exp(-di)
    ifactor = ckcodti / 100.0 if c.LREGCL else ckcodti
    di_i = ifactor * itmp42 * (
        itmp41 * (2.0 * cldi * cldi_i * (1.0 / icrit**2.0) - 0.025 * t_i) + 0.025 * t_i
    )
    qinew = clc * cldi * itmp5
    qinew_i = clc_i * cldi * itmp5 + clc * cldi_i * itmp5 - clc * cldi * itmp5 * di_i
    prs = sel0(act, qiwc - qinew)
    prs_i = sel0(act, qiwc_i - qinew_i)
    qiwc = qiwc - prs
    qiwc_i = qiwc_i - prs_i

    # new precipitation and rain fraction
    dr = cons2 * dp * (prr + prs)
    dr_i = cons2 * (dp_i * (prr + prs) + dp * (prr_i + prs_i))
    coldt = t < c.RTT
    rfreeze = sel0(coldt, cons2 * dp * prr)
    rfreeze_i = sel0(coldt, cons2 * (dp_i * prr + dp * prr_i))
    fwatr = select(coldt, 0.0, 1.0, t)
    rfln = rfln + fwatr * dr
    rfln_i = rfln_i + fwatr * dr_i
    sfln = sfln + (1.0 - fwatr) * dr
    sfln_i = sfln_i + (1.0 - fwatr) * dr_i

    # precipitation evaporation (compiled out unless LEVAPLS2/LDRAIN1D)
    prtot = rfln + sfln
    prtot_i = rfln_i + sfln_i
    if c.LEVAPLS2 or c.LDRAIN1D:
        eact = (prtot > c.ZEPS2) & (covpclr > c.ZEPS2)
        covptot_safe = torch.where(eact, covptot, 1.0)
        covpclr_safe = torch.where(eact, covpclr, 1.0)
        prtot_safe = torch.where(eact, prtot, 1.0)
        preclr = div(prtot * covpclr, covptot_safe, fd)
        preclr_i = div(prtot_i * covpclr + prtot * covpclr_i, covptot_safe, fd) - div(
            prtot * covpclr * covptot_i, covptot_safe * covptot_safe, fd
        )
        clcc = torch.where(eact, 1.0 - clc, 1.0)
        qlim, qlim_i = xp["qlim"], xp["qlim_i"]
        corqs, corqs_i = xp["corqs"], xp["corqs_i"]
        qe = qsat_in - div((qsat_in - qlim) * covpclr, clcc * clcc, fd)
        qe_i = (
            qsat_in_i
            - div(
                qsat_in_i * covpclr - qlim_i * covpclr + (qsat_in - qlim) * covpclr_i,
                clcc * clcc,
                fd,
            )
            - div(2.0 * (qsat_in - qlim) * covpclr * clc_i, clcc * clcc * clcc, fd)
        )
        tmp6 = xp["tmp6"]
        preclr_safe = torch.where(eact & (preclr > 0.0), preclr, 1.0)
        beta = c.RG * c.RPECONS * div(tmp6 * preclr_safe, 0.00509 * covpclr_safe, fd) ** 0.5777
        # the exact derivatives of tmp6 = sqrt(ap/aph_s) and of the b
        # quotient, where the JAX package departs from GT4Py
        beta_i = (
            0.5777 * c.RG * c.RPECONS / 0.00509
            * div(0.00509 * covpclr_safe, tmp6 * preclr_safe, fd) ** 0.4223
            * (
                (
                    tmp6 * preclr_i
                    + div(0.5 * preclr_safe * ap_i, tmp6 * aph_s, fd)
                    - div(0.5 * preclr_safe * tmp6 * aph_s_i, aph_s, fd)
                )
                * rcp(covpclr_safe, fd)
                - div(tmp6 * preclr_safe * covpclr_i, covpclr_safe * covpclr_safe, fd)
            )
        )
        vb = 1.0 + dt * beta * corqs
        b = div(dt * beta * (qsat_in - qe), vb, fd)
        b_i = div(dt * (beta_i * (qsat_in - qe) + beta * (qsat_in_i - qe_i)), vb, fd) - div(
            dt * b * (beta_i * corqs + beta * corqs_i), vb, fd
        )
        dtgdp, dtgdp_i = xp["dtgdp"], xp["dtgdp_i"]
        dpr = div(covpclr * b, dtgdp, fd)
        dpr_i = div(covpclr_i * b + covpclr * b_i, dtgdp, fd) - div(covpclr * b * dtgdp_i, dtgdp * dtgdp, fd)
        big = dpr > preclr
        dpr = sel0(eact, torch.where(big, preclr, dpr))
        dpr_i = sel0(eact, torch.where(big, preclr_i, dpr_i))
        preclr = preclr - dpr
        preclr_i = preclr_i - dpr_i
        drained = eact & (preclr <= 0.0)
        covptot = torch.where(drained, clc, covptot)
        covptot_i = torch.where(drained, clc_i, covptot_i)
        covptot_out = sel0(eact, covptot)
        covptot_out_i = sel0(eact, covptot_i)
        evapr = sel0(eact, div(dpr * rfln, prtot_safe, fd))
        evapr_i = sel0(
            eact,
            div(dpr_i * rfln + dpr * rfln_i, prtot_safe, fd)
            - div(dpr * rfln * prtot_i, prtot_safe * prtot_safe, fd),
        )
        rfln = rfln - evapr
        rfln_i = rfln_i - evapr_i
        evaps = sel0(eact, div(dpr * sfln, prtot_safe, fd))
        evaps_i = sel0(
            eact,
            div(dpr_i * sfln + dpr * sfln_i, prtot_safe, fd)
            - div(dpr * sfln * prtot_i, prtot_safe * prtot_safe, fd),
        )
        sfln = sfln - evaps
        sfln_i = sfln_i - evaps_i
    else:
        zero = torch.zeros_like(prtot)
        evapr = evapr_i = evaps = evaps_i = covptot_out = covptot_out_i = zero

    def tendencies(condl, condl_i, condi, condi_i, rfreeze, rfreeze_i):
        """(dq/dt, its perturbation, dT/dt, its perturbation)"""
        mix = fwat * lvdcp + (1.0 - fwat) * lsdcp
        dqdt = -(condl + condi) + (lude + evapr + evaps) * gdp
        dqdt_i = (
            -(condl_i + condi_i)
            + (lude_i + evapr_i + evaps_i) * gdp
            + (lude + evapr + evaps) * gdp_i
        )
        tmp = lvdcp * evapr + lsdcp * evaps + lude * mix - (lsdcp - lvdcp) * rfreeze
        dtdt = lvdcp * condl + lsdcp * condi - tmp * gdp
        dtdt_i = (
            lvdcp_i * condl
            + lvdcp * condl_i
            + lsdcp_i * condi
            + lsdcp * condi_i
            - (
                lvdcp_i * evapr
                + lvdcp * evapr_i
                + lsdcp_i * evaps
                + lsdcp * evaps_i
                + lude_i * mix
                + lude * (fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (1.0 - fwat) * lsdcp_i)
                - (lsdcp_i - lvdcp_i) * rfreeze
                - (lsdcp - lvdcp) * rfreeze_i
            )
            * gdp
            - tmp * gdp_i
        )
        return dqdt, dqdt_i, dtdt, dtdt_i

    # T and q increments, then the final clipping
    dqdt, dqdt_i, dtdt, dtdt_i = tendencies(condl, condl_i, condi, condi_i, rfreeze, rfreeze_i)
    t = t + dt * dtdt
    t_i = t_i + dt * dtdt_i
    qold = q + dt * dqdt
    qold_i = q_i + dt * dqdt_i
    t, t_i, q, q_i = cuadjtqs_tl(ap, ap_i, t, t_i, qold, qold_i, c)
    clipped = qold >= q
    dq = torch.clamp(qold - q, min=0.0)
    dq_i = sel0(clipped, qold_i - q_i)
    if c.LREGCL:
        dq_i = dq_i * 0.7
    dr2 = cons2 * dp * dq
    dr2_i = cons2 * (dp_i * dq + dp * dq_i)

    # update rain fraction and freezing
    coldt2 = t < c.RTT
    rfreeze2 = sel0(coldt2, fwat * dr2)
    rfreeze2_i = sel0(coldt2, fwat_i * dr2 + fwat * dr2_i)
    fwatr2 = select(coldt2, 0.0, 1.0, t)
    condl = condl + fwatr2 * dq * rdt
    condl_i = condl_i + fwatr2 * dq_i * rdt
    condi = condi + (1.0 - fwatr2) * dq * rdt
    condi_i = condi_i + (1.0 - fwatr2) * dq_i * rdt
    rfln = rfln + fwatr2 * dr2
    rfln_i = rfln_i + fwatr2 * dr2_i
    sfln = sfln + (1.0 - fwatr2) * dr2
    sfln_i = sfln_i + (1.0 - fwatr2) * dr2_i
    rfreeze = rfreeze + rfreeze2
    rfreeze_i = rfreeze_i + rfreeze2_i

    # output tendencies
    tnd_q, tnd_q_i, tnd_t, tnd_t_i = tendencies(condl, condl_i, condi, condi_i, rfreeze, rfreeze_i)
    outs = {
        "tnd_t": tnd_t, "tnd_t_i": tnd_t_i,
        "tnd_q": tnd_q, "tnd_q_i": tnd_q_i,
        "tnd_ql": xp["tnd_ql"], "tnd_ql_i": xp["tnd_ql_i"],
        "tnd_qi": (qiwc - qi) * rdt, "tnd_qi_i": (qiwc_i - qi_i) * rdt,
        "clc": clc, "clc_i": clc_i,
        "covptot": covptot_out, "covptot_i": covptot_out_i,
        "fplsl": rfln, "fplsl_i": rfln_i,
        "fplsn": sfln, "fplsn_i": sfln_i,
    }
    return TLCarry(rfln, sfln, covptot, rfln_i, sfln_i, covptot_i), outs


def tl_level(
    carry: TLCarry, x: Dict[str, Tensor], aph_s: Tensor, aph_s_i: Tensor, trpaus: Tensor,
    dt: float, c: Constants, coeffs: Optional[Coeffs] = None,
) -> Tuple[TLCarry, Dict[str, Tensor]]:
    """One level of the tangent-linear scheme: :func:`tl_level_pre` then
    :func:`tl_level_post`."""
    pre = tl_level_pre(x, aph_s, trpaus, dt, c, coeffs)
    return tl_level_post(carry, {**x, **pre}, aph_s, aph_s_i, dt, c)


def prepare_tl_level_inputs(state: Dict[str, Tensor], dt: float, c: Constants) -> Dict[str, Tensor]:
    """Per-level scan inputs of :func:`prepare_level_inputs` plus the
    perturbation fields (``aph_i`` as the interfaces above and below each
    level, ``lu_i`` as the one-level lookahead, zero at the bottom)."""
    xs = prepare_level_inputs(state, dt, c)
    lu_i = state["lu_i"]
    names = (
        "ap", "lude", "mfd", "mfu", "q", "qi", "ql", "qsat", "supsat", "t",
        "tnd_cml_q", "tnd_cml_qi", "tnd_cml_ql", "tnd_cml_t",
    )
    xs.update({n + "_i": state[n + "_i"] for n in names})
    xs.update(
        aph0_i=state["aph_i"][:-1],
        aph1_i=state["aph_i"][1:],
        lu_next_i=torch.cat([lu_i[1:], torch.zeros_like(lu_i[:1])]),
    )
    return xs


def cloudsc2_tl(
    state: Dict[str, Tensor], dt: float, c: Constants, tangent_only: bool = False
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Run the tangent-linear scheme over all levels.

    ``state`` holds the 16 input fields and their 16 perturbations
    (``*_i``), ``eta`` and ``qsat``/``qsat_i``.  Returns ``(tendencies,
    diagnostics)``: each of ``t, q, ql, qi`` and ``clc, covptot, fplsl,
    fplsn, fhpsl, fhpsn`` with its ``*_i`` perturbation.  With
    ``tangent_only`` only the ``*_i`` outputs are returned (the forward
    recompute still runs: it feeds the linearization).
    """
    check_constants(c)
    xs = prepare_tl_level_inputs(state, dt, c)
    scalars = {"eta": xs.pop("eta"), "scalm": xs.pop("scalm")}
    trpaus = tropopause_eta(scalars["eta"], xs["t_fg"])
    coeffs = critical_rh_coeffs(trpaus)
    col = {"aph_s": state["aph"][-1], "aph_s_i": state["aph_i"][-1], "trpaus": trpaus}

    def body(carry, x, col):
        carry, outs = tl_level(
            TLCarry(*carry), x, col["aph_s"], col["aph_s_i"], col["trpaus"], dt, c, coeffs
        )
        return tuple(carry), outs

    ys = level_scan(body, xs, col, scalars, ncarry=6)
    tends: Dict[str, Tensor] = {}
    diags: Dict[str, Tensor] = {}
    sfx = ("_i",) if tangent_only else ("", "_i")
    for s in sfx:
        for n in TEND_NAMES:
            tends[n + s] = ys["tnd_" + n + s]
        for n in ("clc", "covptot"):
            diags[n + s] = ys[n + s]
        for n in FLUX_NAMES:
            v = ys[n + s]
            diags[n + s] = torch.cat([torch.zeros_like(v[:1]), v])
        diags["fhpsl" + s] = -diags["fplsl" + s] * c.RLVTT
        diags["fhpsn" + s] = -diags["fplsn" + s] * c.RLSTT
    return tends, diags
