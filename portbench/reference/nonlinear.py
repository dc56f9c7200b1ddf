# Frozen copy of cloudsc2_tpu_torch/physics/nonlinear.py at commit 8632ffd, part of the
# benchmark's plain reference: its imports made relative to this package,
# nothing else changed.  It imports nothing of the port or of JAX.
# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""CLOUDSC2 nonlinear scheme, plain PyTorch; the port of
:mod:`cloudsc2_tpu.physics.nonlinear`.

This is the port's f64 path and the plain version of the NL kernel
(:mod:`cloudsc2_tpu_torch.kernels.nonlinear`): the per-level body is the
same sequence of roundings as ``kernels/csrc/nl_level.h``, and
:func:`cloudsc2_nl` runs it through the plain level scan
(:func:`cloudsc2_tpu_torch.kernels.levelscan.level_scan`) where JAX runs
``lax.scan``.  Each expression mirrors its JAX counterpart operand for
operand.  Every ``where`` keeps the JAX version's guarded operands (safe
denominators), because both sides of a ``torch.where`` are evaluated.

Every divide that the JAX body routes through ``fastmath`` divides under
``c.FAST_DIV`` here too (:mod:`cloudsc2_tpu_torch.physics.fastmath`: exact,
or the approximate reciprocal as Pallas interpret mode models it, with or
without a Newton step).  Both forms of the saturation adjustment
(``CUADJ_COMPACT``) are ported.  ``MASK_SELECT`` is bit-identical to the
select form and is ignored.

With ``fuse_saturation`` :func:`cloudsc2_nl` diagnoses ``qsat`` itself
(:func:`cloudsc2_tpu_torch.physics.saturation.saturation`) and returns it
among the diagnostics: the plain version of the kernel's fused form
(``fuse_saturation`` of ``cloudsc2_tpu/pallas/nonlinear.py:105-110``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .params import Constants
from .levelscan import level_scan
from . import fcttre
from .cuadjtqs import cuadjtqs_nl
from .fastmath import DIV_MODES, div, rcp, scalar, sel0, select
from .saturation import saturation

Tensor = torch.Tensor
Coeffs = Tuple[Tensor, Tensor, Tensor]


class NLCarry(NamedTuple):
    """State carried down the levels."""

    rfl: Tensor  # rain flux entering the level from above
    sfl: Tensor  # snow flux entering the level from above
    covptot: Tensor  # running maximum-overlap precipitation cover


#: the trajectory of ``with_trajectory``: the carry entering each level
TRAJ_OUTPUTS = ("c_rfl", "c_sfl", "c_cov")


def trajectory_names(c: Constants) -> Tuple[str, ...]:
    """The trajectory streams of ``with_trajectory``: ``c_cov`` only with
    the evaporation branch, the one place the TL reads the covptot carry
    (``pallas/nonlinear.py:218-225``)."""
    return TRAJ_OUTPUTS if (c.LEVAPLS2 or c.LDRAIN1D) else TRAJ_OUTPUTS[:2]


def check_constants(c: Constants) -> None:
    """Raise ``ValueError`` for a ``FAST_DIV`` that is none of the divide
    modes; the NL, TL and AD take every mode and both ``CUADJ_COMPACT``
    forms."""
    if c.FAST_DIV not in DIV_MODES:
        raise ValueError(f"FAST_DIV={c.FAST_DIV!r} is none of {DIV_MODES}")


def tropopause_eta(eta: Tensor, t_fg: Tensor) -> Tensor:
    """Tropopause eta per column: the *last* level ``k`` with
    ``0.1 < eta[k] < 0.4`` and ``t[k] > t[k+1]`` wins; default 0.1."""
    nlev = eta.shape[0]
    window = (eta[:-1] > 0.1) & (eta[:-1] < 0.4)
    mask = window[:, None] & (t_fg[:-1] > t_fg[1:])
    ks = torch.arange(nlev - 1, device=eta.device)[:, None]
    best = torch.where(mask, ks, -1).amax(dim=0)
    return torch.where(best >= 0, eta[best.clamp(min=0)], scalar(0.1, eta))


def scalm_profile(eta: Tensor, c: Constants) -> Tensor:
    """ZSCAL * max(eta - 0.2, ZEPS1) ** 0.2."""
    return c.ZSCAL * torch.clamp(eta - 0.2, min=c.ZEPS1) ** 0.2


def critical_rh_coeffs(trpaus: Tensor) -> Coeffs:
    """Per-column coefficients of the critical-RH profile:
    ``(rh2, deta1, 1/sqrt(deta1))``."""
    d = div(trpaus - 0.25, 0.15)
    rh2 = 0.35 + 0.14 * (d * d) + div(0.04 * torch.clamp(trpaus - 0.25, max=0.0), 0.15)
    deta1 = 0.09 + div(0.16 * (0.4 - trpaus), 0.3)
    return rh2, deta1, rcp(torch.sqrt(deta1))


def critical_rh(eta_k: Tensor, trpaus: Tensor, coeffs: Optional[Coeffs] = None) -> Tensor:
    """Critical relative-humidity profile."""
    rh2, deta1, rsq_deta1 = critical_rh_coeffs(trpaus) if coeffs is None else coeffs
    rdeta2 = 1.0 / 0.3
    sq = torch.sqrt(torch.clamp(1.0 - eta_k, min=0.0)) * rsq_deta1
    return torch.where(
        eta_k < trpaus,
        1.0,
        torch.where(
            eta_k < trpaus + 0.3,
            1.0 + (rh2 - 1.0) * ((eta_k - trpaus) * rdeta2),
            torch.where(eta_k < 1.0 - deta1, rh2, 1.0 + (rh2 - 1.0) * sq),
        ),
    )


def lcrit_icrit(c: Constants) -> Tuple[float, float]:
    """Critical liquid and ice contents of the autoconversion; the NL
    kernel's constant struct folds the same pair (``state.kernel_constants``)."""
    if c.LEVAPLS2 or c.LDRAIN1D:
        return 1.9 * c.RCLCRIT, 0.0001
    return 2.0 * c.RCLCRIT, 2.0 * c.RCLCRIT


def nl_level_pre(
    x: Dict[str, Tensor], aph_s: Tensor, trpaus: Tensor, dt: float, c: Constants,
    coeffs: Optional[Coeffs] = None,
) -> Dict[str, Tensor]:
    """Carry-independent part of one level (phase A): first guess,
    thermodynamic coefficients, dqs/dT, critical humidity, cloud cover,
    detrainment, subsidence, condensation rates, melt constants and the
    carry-free half of the autoconversion.  Returns what phase B reads
    (the JAX version also returns every intermediate, for its adjoint)."""
    fd = c.FAST_DIV
    ap = x["ap"]
    rap = rcp(ap, fd)
    qsat_in = x["qsat"]
    t = x["t_fg"]
    q = x["q"] + dt * x["tnd_cml_q"] + x["supsat"]
    ql = x["ql"] + dt * x["tnd_cml_ql"]
    qi = x["qi"] + dt * x["tnd_cml_qi"]
    pre: Dict[str, Tensor] = dict(rap=rap, t2=t, q2=q, qi_fg=qi)

    cons3 = c.RLVTT / c.RCPD
    scalm = x["scalm"]

    dp = x["aph1"] - x["aph0"]
    zz = c.RCPD + c.RCPD * c.RVTMP2 * q
    rzz = rcp(zz, fd)
    lfdcp = c.RLMLT * rzz
    lsdcp = c.RLSTT * rzz
    lvdcp = c.RLVTT * rzz
    pre.update(dp=dp, lsdcp=lsdcp, lvdcp=lvdcp)

    rl = rcp(t - c.R4LES, fd)
    ri = rcp(t - c.R4IES, fd)
    thermo = c.LPHYLIN or c.LDRAIN1D
    if thermo:
        cold = t < c.RTT
        fwat = torch.where(cold, 0.545 * (torch.tanh(0.17 * (t - c.RLPTRC)) + 1.0), 1.0)
        z3es = select(cold, c.R3IES, c.R3LES, t)
        rz4es = torch.where(cold, ri, rl)
        foeew = c.R2ES * torch.exp(z3es * (t - c.RTT) * rz4es)
    else:
        fwat = fcttre.foealfa(t, c)
        foeew = fcttre.foeewm(t, c)
    esdp1 = foeew * rap
    facw = c.R5LES * rl * rl
    faci = c.R5IES * ri * ri
    fac = fwat * facw + (1.0 - fwat) * faci
    fac2 = rcp(ap - c.RETV * foeew, fd)
    cor = ap * fac2
    if thermo:
        cor = torch.where(esdp1 <= c.ZQMAX, cor, 1.0 / (1.0 - c.RETV * c.ZQMAX))
    dqsdtemp = fac * cor * qsat_in
    corqs = 1.0 + cons3 * dqsdtemp
    pre.update(fwat=fwat, corqs=corqs)
    pre["qlim"] = torch.minimum(q, qsat_in)

    # critical humidity and ice supersaturation
    crh2 = critical_rh(x["eta"], trpaus, coeffs)
    supsat_fac = torch.where(t < c.RTICE, 1.8 - 0.003 * t, 1.0)
    qsat = qsat_in * supsat_fac
    qcrit = crh2 * qsat

    # Letreut & Li (1990) uniform-distribution cloud cover; the ratio is
    # clamped to 1 so that rounding cannot drive clc below 0
    qt = q + ql + qi
    low = qt < qcrit
    high = qt >= qsat
    mid = torch.logical_not(low | high)
    qpd = qsat - qt
    qcd = qsat - qcrit
    denom_safe = torch.where(mid, qcd - scalm * (qt - qcrit), 1.0)
    ratio = torch.clamp(sel0(mid, div(qpd, denom_safe, fd)), max=1.0)
    clc_mid = 1.0 - torch.sqrt(ratio)
    qc_mid = (scalm * qpd + (1.0 - scalm) * qcd) * (clc_mid * clc_mid)
    qc_high = (1.0 - scalm) * (qsat - qcrit)
    clc = torch.where(low, 0.0, torch.where(high, 1.0, clc_mid))
    qc = torch.where(low, 0.0, torch.where(high, qc_high, qc_mid))

    # convective detrainment
    gdp = div(c.RG, dp, fd)
    lude = dt * x["lude"] * gdp
    lu1 = x["lu_next"]
    lo1 = (lude >= c.RLMIN) & (lu1 >= c.ZEPS2)
    lu1_safe = torch.where(lo1, lu1, 1.0)
    tmp2 = torch.exp(div(-lude, lu1_safe, fd))
    clc = clc + sel0(lo1, (1.0 - clc) * (1.0 - tmp2))
    qc = qc + sel0(lo1, lude)
    pre.update(gdp=gdp, clc=clc)

    # compensating subsidence
    fac1 = rcp(c.RD * t, fd)
    rho = ap * fac1
    rodqsdp = -rho * qsat_in * fac2
    ldcp = fwat * lvdcp + (1.0 - fwat) * lsdcp
    fac3 = rcp(1.0 + ldcp * dqsdtemp, fd)
    dtdzmo = c.RG * (1.0 / c.RCPD - ldcp * rodqsdp) * fac3
    dqsdz = dqsdtemp * dtdzmo - c.RG * rodqsdp
    fac4 = c.RD * t * rap
    mf = x["mfu"] + x["mfd"]
    sub = dt * dqsdz * mf * fac4
    qc = sel0(sub < qc, qc - sub)

    # new condensate and condensation rates
    rdt = 1.0 / dt
    qlwc = qc * fwat
    qiwc = qc * (1.0 - fwat)
    pre.update(condl1=(qlwc - ql) * rdt, condi1=(qiwc - qi) * rdt, qiwc1=qiwc)

    # melt constants (the min() against the snow-flux carry is phase B)
    cons2 = 1.0 / (c.RG * dt)
    meltp2 = c.RTT + 2.0
    cons = (cons2 / c.RLMLT) * dp * zz
    pre["rcons"] = dt * gdp * lfdcp
    pre["z2s"] = cons * torch.clamp(t - meltp2, min=0.0)

    # carry-free half of the rain / snow autoconversion
    lcrit, icrit = lcrit_icrit(c)
    ckcodtl = 2.0 * c.RKCONV * dt
    act = clc > c.ZEPS2
    rclc = rcp(torch.where(act, clc, 1.0), fd)
    cldl = qlwc * rclc
    ltmp1 = torch.exp(-(cldl * cldl * (1.0 / (lcrit * lcrit))))
    dl = ckcodtl * (1.0 - ltmp1)
    ltmp2 = torch.exp(-dl)
    qlnew = clc * cldl * ltmp2
    # qlnew <= qlwc in real arithmetic; the clamp keeps the rain flux >= 0
    prr = sel0(act, torch.clamp(qlwc - qlnew, min=0.0))
    qlwc = qlwc - prr
    cldi = qiwc * rclc
    itmp11 = torch.exp(-(cldi * cldi * (1.0 / (icrit * icrit))))
    pre.update(act=act, cldi=cldi, itmp11=itmp11, prr=prr)
    pre["tnd_ql"] = (qlwc - ql) * rdt

    if c.LEVAPLS2 or c.LDRAIN1D:
        pre["sqr"] = torch.sqrt(div(ap, aph_s, fd))
        pre["dtgdp"] = div(dt * c.RG, dp, fd)
    return pre


def nl_level_post(
    carry: NLCarry, xp: Dict[str, Tensor], dt: float, c: Constants
) -> Tuple[NLCarry, Dict[str, Tensor]]:
    """Carry-dependent tail of one level (phase B): precipitation overlap,
    snow melt, the melt-temperature half of the autoconversion,
    precipitation evaporation, tendencies and the saturation adjustment.
    ``xp`` is the level's raw inputs merged with :func:`nl_level_pre`."""
    rfl, sfl, covptot = carry
    fd = c.FAST_DIV
    cons2 = 1.0 / (c.RG * dt)
    ckcodti = 5.0 * c.RKCONV * dt
    rdt = 1.0 / dt

    t = xp["t2"]
    clc = xp["clc"]
    gdp = xp["gdp"]
    dp = xp["dp"]
    fwat = xp["fwat"]
    lvdcp, lsdcp = xp["lvdcp"], xp["lsdcp"]
    condl, condi = xp["condl1"], xp["condi1"]
    qiwc = xp["qiwc1"]
    prr = xp["prr"]
    act = xp["act"]

    # maximum precipitation overlap
    covptot = torch.maximum(covptot, clc)
    covpclr = torch.clamp(covptot - clc, min=0.0)

    # melting of incoming snow
    sm = sel0(sfl != 0.0, torch.minimum(sfl, xp["z2s"]))
    rfln = rfl + sm
    sfln = sfl - sm
    t = t - sm * xp["rcons"]

    # melt-temperature half of the snow autoconversion
    itmp12 = torch.exp(0.025 * (t - c.RTT))
    di = ckcodti * itmp12 * (1.0 - xp["itmp11"])
    itmp2 = torch.exp(-di)
    qinew = clc * xp["cldi"] * itmp2
    prs = sel0(act, torch.clamp(qiwc - qinew, min=0.0))
    qiwc = qiwc - prs

    # new precipitation and rain fraction
    dr1 = cons2 * dp * (prr + prs)
    coldt = t < c.RTT
    rfreeze = sel0(coldt, cons2 * dp * prr)
    fwatr1 = select(coldt, 0.0, 1.0, t)
    rfln = rfln + fwatr1 * dr1
    sfln = sfln + (1.0 - fwatr1) * dr1

    # precipitation evaporation (compiled out unless LEVAPLS2/LDRAIN1D)
    prtot = rfln + sfln
    if c.LEVAPLS2 or c.LDRAIN1D:
        qsat_in = xp["qsat"]
        eact = (prtot > c.ZEPS2) & (covpclr > c.ZEPS2)
        covptot_safe = torch.where(eact, covptot, 1.0)
        covpclr_safe = torch.where(eact, covpclr, 1.0)
        preclr1 = div(prtot * covpclr, covptot_safe, fd)
        clcc = torch.where(eact, 1.0 - clc, 1.0)
        qe = qsat_in - div((qsat_in - xp["qlim"]) * covpclr, clcc * clcc, fd)
        barg = torch.where(eact, div(div(xp["sqr"], 0.00509) * preclr1, covpclr_safe, fd), 1.0)
        beta = c.RG * c.RPECONS * barg**0.5777
        b = div(dt * beta * (qsat_in - qe), 1.0 + dt * beta * xp["corqs"], fd)
        dpr1 = div(covpclr * b, xp["dtgdp"], fd)
        dpr = sel0(eact, torch.minimum(dpr1, preclr1))
        preclr = preclr1 - dpr
        covptot = torch.where(eact & (preclr <= 0.0), clc, covptot)
        covptot_out = sel0(eact, covptot)
        prtot_safe = torch.where(eact, prtot, 1.0)
        evapr = sel0(eact, div(dpr * rfln, prtot_safe, fd))
        evaps = sel0(eact, div(dpr * sfln, prtot_safe, fd))
        rfln = rfln - evapr
        sfln = sfln - evaps
    else:
        evapr = evaps = covptot_out = torch.zeros_like(prtot)

    # T / q tendency update and first guess
    lude = xp["lude"]
    dqdt = -(condl + condi) + (lude + evapr + evaps) * gdp
    tmp7 = (
        lvdcp * evapr
        + lsdcp * evaps
        + lude * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
        - (lsdcp - lvdcp) * rfreeze
    )
    dtdt = lvdcp * condl + lsdcp * condi - tmp7 * gdp
    t3 = t + dt * dtdt
    qold1 = xp["q2"] + dt * dqdt

    # saturation-adjustment clipping
    t, q = cuadjtqs_nl(xp["ap"], t3, qold1, c, rap=xp["rap"])

    # post-clipping rain fraction and freezing, on the adjusted temperature
    dq = torch.clamp(qold1 - q, min=0.0)
    dr2 = cons2 * dp * dq
    coldt2 = t < c.RTT
    rfreeze2 = sel0(coldt2, fwat * dr2)
    fwatr2 = select(coldt2, 0.0, 1.0, t)
    condl2 = condl + fwatr2 * dq * rdt
    condi2 = condi + (1.0 - fwatr2) * dq * rdt
    rfln = rfln + fwatr2 * dr2
    sfln = sfln + (1.0 - fwatr2) * dr2
    rfreeze3 = rfreeze + rfreeze2

    # output tendencies
    tnd_q = -(condl2 + condi2) + (lude + evapr + evaps) * gdp
    tmp8 = (
        lvdcp * evapr
        + lsdcp * evaps
        + lude * (fwat * lvdcp + (1.0 - fwat) * lsdcp)
        - (lsdcp - lvdcp) * rfreeze3
    )
    tnd_t = lvdcp * condl2 + lsdcp * condi2 - tmp8 * gdp
    outs = {
        "tnd_t": tnd_t,
        "tnd_q": tnd_q,
        "tnd_ql": xp["tnd_ql"],
        "tnd_qi": (qiwc - xp["qi_fg"]) * rdt,
        "clc": clc,
        "covptot": covptot_out,
        "fplsl": rfln,
        "fplsn": sfln,
    }
    return NLCarry(rfln, sfln, covptot), outs


def nl_level(
    carry: NLCarry, x: Dict[str, Tensor], aph_s: Tensor, trpaus: Tensor, dt: float,
    c: Constants, coeffs: Optional[Coeffs] = None,
) -> Tuple[NLCarry, Dict[str, Tensor]]:
    """One level of the nonlinear scheme: :func:`nl_level_pre` then
    :func:`nl_level_post`.  ``x`` holds the level's rows of the fields of
    :func:`prepare_level_inputs` and its ``eta`` and ``scalm``."""
    pre = nl_level_pre(x, aph_s, trpaus, dt, c, coeffs)
    return nl_level_post(carry, {**x, **pre}, dt, c)


def prepare_level_inputs(state: Dict[str, Tensor], dt: float, c: Constants) -> Dict[str, Tensor]:
    """Per-level scan inputs from a state dict: the raw full-level fields,
    the interface pressures above and below each level, the one-level
    lookahead ``lu_next`` (zero at the bottom), the first-guess
    temperature, and the ``(nlev,)`` ``eta``/``scalm``."""
    lu = state["lu"]
    eta = state["eta"].to(lu.dtype)
    names = (
        "ap", "lude", "mfd", "mfu", "q", "qi", "ql", "qsat", "supsat",
        "tnd_cml_q", "tnd_cml_qi", "tnd_cml_ql",
    )
    xs = {n: state[n] for n in names}
    xs.update(
        aph0=state["aph"][:-1],
        aph1=state["aph"][1:],
        lu_next=torch.cat([lu[1:], torch.zeros_like(lu[:1])]),
        t_fg=state["t"] + dt * state["tnd_cml_t"],
        eta=eta,
        scalm=scalm_profile(eta, c),
    )
    return xs


def cloudsc2_nl(
    state: Dict[str, Tensor], dt: float, c: Constants, with_trajectory: bool = False,
    fuse_saturation: bool = False, kflag: int = 1,
):
    """Run the nonlinear scheme over all levels.

    Returns ``(tendencies, diagnostics)``: tendencies ``t, q, ql, qi``
    ``(nlev, ncols)``; diagnostics ``clc, covptot`` ``(nlev, ncols)`` and
    ``fplsl, fplsn, fhpsl, fhpsn`` ``(nlev + 1, ncols)``.  With
    ``with_trajectory`` a third element: the carry entering each level,
    ``(nlev, ncols)`` each, named by :func:`trajectory_names` (the
    trajectory the adjoint's reverse sweep re-linearizes around).  With
    ``fuse_saturation`` the state's ``qsat`` is not read: it is diagnosed
    from ``ap`` and ``t`` (the ``Saturation`` component's ``kflag``, and
    ``c.LPHYLIN``) and returned as the diagnostic ``qsat``.
    """
    check_constants(c)
    qsat = None
    if fuse_saturation:
        qsat = saturation(state["ap"], state["t"], kflag=kflag, lphylin=c.LPHYLIN, c=c)
        state = dict(state, qsat=qsat)
    xs = prepare_level_inputs(state, dt, c)
    scalars = {"eta": xs.pop("eta"), "scalm": xs.pop("scalm")}
    trpaus = tropopause_eta(scalars["eta"], xs["t_fg"])
    coeffs = critical_rh_coeffs(trpaus)
    col = {"aph_s": state["aph"][-1], "trpaus": trpaus}

    traj_names = trajectory_names(c) if with_trajectory else ()

    def body(carry, x, col):
        entering = dict(zip(TRAJ_OUTPUTS, carry))
        carry, outs = nl_level(NLCarry(*carry), x, col["aph_s"], col["trpaus"], dt, c, coeffs)
        outs.update({n: entering[n] for n in traj_names})
        return tuple(carry), outs

    ys = level_scan(body, xs, col, scalars, ncarry=3)
    zrow = torch.zeros_like(ys["fplsl"][:1])
    fplsl = torch.cat([zrow, ys["fplsl"]])
    fplsn = torch.cat([zrow, ys["fplsn"]])
    tends = {"t": ys["tnd_t"], "q": ys["tnd_q"], "ql": ys["tnd_ql"], "qi": ys["tnd_qi"]}
    diags = {
        "clc": ys["clc"],
        "covptot": ys["covptot"],
        "fplsl": fplsl,
        "fplsn": fplsn,
        "fhpsl": -fplsl * c.RLVTT,
        "fhpsn": -fplsn * c.RLSTT,
    }
    if qsat is not None:
        diags["qsat"] = qsat
    if not with_trajectory:
        return tends, diags
    return tends, diags, {n: ys[n] for n in traj_names}
