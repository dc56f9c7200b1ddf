# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Independent scalar NumPy oracle of the CLOUDSC2 nonlinear scheme; the
port's own copy of ``oracle_saturation`` and ``oracle_nonlinear`` of
:mod:`cloudsc2_tpu.oracle`.

A deliberately naive per-column, per-level transcription of the reference
stencil semantics (NL ``physics/nonlinear/_stencils/cloudsc2.py:24-399``)
using plain Python ``if``/``else`` — i.e. the same execution model as
gtscript's per-point iteration.  It shares no code with the vectorized
schemes.  :func:`golden_outputs` is what the golden files hold
(``drivers/generate_reference_torch.py`` writes them), and
:func:`synthetic_golden` gives them in process, where no HDF5 reader is
installed.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

Fields = Dict[str, np.ndarray]


def oracle_saturation(ap, t, c, kflag=1, lphylin=True):
    nlev, ncols = ap.shape
    out = np.zeros_like(ap)
    for k in range(nlev):
        for i in range(ncols):
            tt = t[k, i]
            if lphylin:
                talfa = min(c.RTWAT, max(c.RTICE, tt))
                alfa = min(1.0, ((talfa - c.RTICE) * c.RTWAT_RTICE_R) ** 2)
                foeewl = c.R2ES * math.exp(c.R3LES * (tt - c.RTT) / (tt - c.R4LES))
                foeewi = c.R2ES * math.exp(c.R3IES * (tt - c.RTT) / (tt - c.R4IES))
                foeew = alfa * foeewl + (1 - alfa) * foeewi
                qs = min(foeew / ap[k, i], c.ZQMAX)
            else:
                if kflag == 1:
                    talfa = min(c.RTWAT, max(c.RTICECU, tt))
                    alfa = min(1.0, ((talfa - c.RTICECU) * c.RTWAT_RTICECU_R) ** 2)
                else:
                    talfa = min(c.RTWAT, max(c.RTICE, tt))
                    alfa = min(1.0, ((talfa - c.RTICE) * c.RTWAT_RTICE_R) ** 2)
                ew = c.R2ES * (
                    alfa * math.exp(c.R3LES * (tt - c.RTT) / (tt - c.R4LES))
                    + (1 - alfa) * math.exp(c.R3IES * (tt - c.RTT) / (tt - c.R4IES))
                )
                qs = min(ew / ap[k, i], c.ZQMAX)
            out[k, i] = qs / (1.0 - c.RETV * qs)
    return out


def _cuadjtqs_nl(ap, t, q, c):
    if t > c.RTT:
        z3es, z4es, z5alcp, zaldcp = c.R3LES, c.R4LES, c.R5ALVCP, c.RALVDCP
    else:
        z3es, z4es, z5alcp, zaldcp = c.R3IES, c.R4IES, c.R5ALSCP, c.RALSDCP
    for _ in range(2):
        foeew = c.R2ES * math.exp(z3es * (t - c.RTT) / (t - z4es))
        qsat = min(foeew / ap, c.ZQMAX)
        cor = 1.0 / (1.0 - c.RETV * qsat)
        qsat *= cor
        z2s = z5alcp / (t - z4es) ** 2
        cond = (q - qsat) / (1.0 + qsat * cor * z2s)
        t += zaldcp * cond
        q -= cond
    return t, q


def oracle_nonlinear(state, dt, c):
    """Run the NL scheme column by column, level by level."""
    ap = np.asarray(state["ap"], np.float64)
    aph = np.asarray(state["aph"], np.float64)
    eta = np.asarray(state["eta"], np.float64)
    nlev, ncols = ap.shape
    g = lambda n: np.asarray(state[n], np.float64)
    lu, lude, mfd, mfu = g("lu"), g("lude"), g("mfd"), g("mfu")
    q_in, qi_in, ql_in = g("q"), g("qi"), g("ql")
    qsat_in, supsat, t_in = g("qsat"), g("supsat"), g("t")
    cq, cqi, cql, ct = g("tnd_cml_q"), g("tnd_cml_qi"), g("tnd_cml_ql"), g("tnd_cml_t")

    tnd = {n: np.zeros((nlev, ncols)) for n in ("t", "q", "ql", "qi")}
    diag = {n: np.zeros((nlev, ncols)) for n in ("clc", "covptot")}
    for n in ("fplsl", "fplsn", "fhpsl", "fhpsn"):
        diag[n] = np.zeros((nlev + 1, ncols))

    for i in range(ncols):
        # first-guess temperature and tropopause (cloudsc2.py:102-111)
        t_fg = t_in[:, i] + dt * ct[:, i]
        trpaus = 0.1
        for k in range(nlev - 1):
            if 0.1 < eta[k] < 0.4 and t_fg[k] > t_fg[k + 1]:
                trpaus = eta[k]

        rfl = sfl = covptot = 0.0
        aph_s = aph[nlev, i]
        for k in range(nlev):
            t = t_fg[k]
            q = q_in[k, i] + dt * cq[k, i] + supsat[k, i]
            ql = ql_in[k, i] + dt * cql[k, i]
            qi = qi_in[k, i] + dt * cqi[k, i]

            ckcodtl = 2.0 * c.RKCONV * dt
            ckcodti = 5.0 * c.RKCONV * dt
            cons2 = 1.0 / (c.RG * dt)
            cons3 = c.RLVTT / c.RCPD
            meltp2 = c.RTT + 2.0
            scalm = c.ZSCAL * max(eta[k] - 0.2, c.ZEPS1) ** 0.2

            dp = aph[k + 1, i] - aph[k, i]
            zz = c.RCPD + c.RCPD * c.RVTMP2 * q
            lfdcp = c.RLMLT / zz
            lsdcp = c.RLSTT / zz
            lvdcp = c.RLVTT / zz

            # dqs/dT correction factor (:140-160)
            if c.LPHYLIN or c.LDRAIN1D:
                if t < c.RTT:
                    fwat = 0.545 * (math.tanh(0.17 * (t - c.RLPTRC)) + 1.0)
                    z3es, z4es = c.R3IES, c.R4IES
                else:
                    fwat = 1.0
                    z3es, z4es = c.R3LES, c.R4LES
                foeew = c.R2ES * math.exp(z3es * (t - c.RTT) / (t - z4es))
                esdp = min(foeew / ap[k, i], c.ZQMAX)
            else:
                talfa = min(c.RTWAT, max(c.RTICE, t))
                fwat = min(1.0, ((talfa - c.RTICE) * c.RTWAT_RTICE_R) ** 2)
                foeew = c.R2ES * (
                    fwat * math.exp(c.R3LES * (t - c.RTT) / (t - c.R4LES))
                    + (1 - fwat) * math.exp(c.R3IES * (t - c.RTT) / (t - c.R4IES))
                )
                esdp = foeew / ap[k, i]
            facw = c.R5LES / (t - c.R4LES) ** 2
            faci = c.R5IES / (t - c.R4IES) ** 2
            fac = fwat * facw + (1 - fwat) * faci
            dqsdtemp = fac * qsat_in[k, i] / (1.0 - c.RETV * esdp)
            corqs = 1.0 + cons3 * dqsdtemp

            qlim = min(q, qsat_in[k, i])

            # critical humidity (:166-186)
            rh2 = (
                0.35
                + 0.14 * ((trpaus - 0.25) / 0.15) ** 2
                + 0.04 * min(trpaus - 0.25, 0.0) / 0.15
            )
            if eta[k] < trpaus:
                crh2 = 1.0
            else:
                deta2 = 0.3
                if eta[k] < trpaus + deta2:
                    crh2 = 1.0 + (rh2 - 1.0) * (eta[k] - trpaus) / deta2
                else:
                    deta1 = 0.09 + 0.16 * (0.4 - trpaus) / 0.3
                    if eta[k] < 1.0 - deta1:
                        crh2 = rh2
                    else:
                        crh2 = 1.0 + (rh2 - 1.0) * math.sqrt((1.0 - eta[k]) / deta1)

            # ice supersaturation (:188-193)
            if t < c.RTICE:
                qsat = qsat_in[k, i] * (1.8 - 0.003 * t)
            else:
                qsat = qsat_in[k, i]
            qcrit = crh2 * qsat

            # cloud cover (:195-207)
            qt = q + ql + qi
            if qt < qcrit:
                clc = 0.0
                qc = 0.0
            elif qt >= qsat:
                clc = 1.0
                qc = (1.0 - scalm) * (qsat - qcrit)
            else:
                qpd = qsat - qt
                qcd = qsat - qcrit
                clc = 1.0 - math.sqrt(qpd / (qcd - scalm * (qt - qcrit)))
                qc = (scalm * qpd + (1.0 - scalm) * qcd) * clc**2

            # convective component (:209-215)
            gdp = c.RG / (aph[k + 1, i] - aph[k, i])
            lude_k = dt * lude[k, i] * gdp
            lu_next = lu[k + 1, i] if k + 1 < nlev else 0.0
            if lude_k >= c.RLMIN and lu_next >= c.ZEPS2:
                clc += (1.0 - clc) * (1.0 - math.exp(-lude_k / lu_next))
                qc += lude_k

            # compensating subsidence (:217-224)
            rho = ap[k, i] / (c.RD * t)
            rodqsdp = -rho * qsat_in[k, i] / (ap[k, i] - c.RETV * foeew)
            ldcp = fwat * lvdcp + (1 - fwat) * lsdcp
            dtdzmo = c.RG * (1.0 / c.RCPD - ldcp * rodqsdp) / (1.0 + ldcp * dqsdtemp)
            dqsdz = dqsdtemp * dtdzmo - c.RG * rodqsdp
            dqc = min(dt * dqsdz * (mfu[k, i] + mfd[k, i]) / rho, qc)
            qc -= dqc

            qlwc = qc * fwat
            qiwc = qc * (1 - fwat)
            condl = (qlwc - ql) / dt
            condi = (qiwc - qi) / dt

            covptot = max(covptot, clc)
            covpclr = max(covptot - clc, 0.0)

            # melting (:237-246)
            if sfl != 0.0:
                cons = cons2 * dp / lfdcp
                snmlt = min(sfl, cons * max(t - meltp2, 0.0))
                rfln = rfl + snmlt
                sfln = sfl - snmlt
                t -= snmlt / cons
            else:
                rfln, sfln = rfl, sfl

            # autoconversion (:248-272)
            if clc > c.ZEPS2:
                lcrit = 1.9 * c.RCLCRIT if (c.LEVAPLS2 or c.LDRAIN1D) else 2.0 * c.RCLCRIT
                cldl = qlwc / clc
                dl = ckcodtl * (1.0 - math.exp(-((cldl / lcrit) ** 2)))
                prr = qlwc - clc * cldl * math.exp(-dl)
                qlwc -= prr
            else:
                prr = 0.0
            if clc > c.ZEPS2:
                icrit = 0.0001 if (c.LEVAPLS2 or c.LDRAIN1D) else 2.0 * c.RCLCRIT
                cldi = qiwc / clc
                di = ckcodti * math.exp(0.025 * (t - c.RTT)) * (1.0 - math.exp(-((cldi / icrit) ** 2)))
                prs = qiwc - clc * cldi * math.exp(-di)
                qiwc -= prs
            else:
                prs = 0.0

            dr = cons2 * dp * (prr + prs)
            if t < c.RTT:
                rfreeze = cons2 * dp * prr
                fwatr = 0.0
            else:
                rfreeze = 0.0
                fwatr = 1.0
            rfln += fwatr * dr
            sfln += (1.0 - fwatr) * dr

            # precipitation evaporation (:287-321)
            prtot = rfln + sfln
            if prtot > c.ZEPS2 and covpclr > c.ZEPS2 and (c.LEVAPLS2 or c.LDRAIN1D):
                preclr = prtot * covpclr / covptot
                qe = qsat_in[k, i] - (qsat_in[k, i] - qlim) * covpclr / (1.0 - clc) ** 2
                beta = (
                    c.RG
                    * c.RPECONS
                    * (math.sqrt(ap[k, i] / aph_s) / 0.00509 * preclr / covpclr) ** 0.5777
                )
                b = dt * beta * (qsat_in[k, i] - qe) / (1.0 + dt * beta * corqs)
                dtgdp = dt * c.RG / (aph[k + 1, i] - aph[k, i])
                dpr = min(covpclr * b / dtgdp, preclr)
                preclr -= dpr
                if preclr <= 0.0:
                    covptot = clc
                diag["covptot"][k, i] = covptot
                evapr = dpr * rfln / prtot
                rfln -= evapr
                evaps = dpr * sfln / prtot
                sfln -= evaps
            else:
                evapr = evaps = 0.0

            # tendencies, first guess, clipping (:323-364)
            dqdt = -(condl + condi) + (lude[k, i] + evapr + evaps) * gdp
            dtdt = (
                lvdcp * condl
                + lsdcp * condi
                - (
                    lvdcp * evapr
                    + lsdcp * evaps
                    + lude[k, i] * (fwat * lvdcp + (1 - fwat) * lsdcp)
                    - (lsdcp - lvdcp) * rfreeze
                )
                * gdp
            )
            t += dt * dtdt
            q += dt * dqdt
            qold = q
            t, q = _cuadjtqs_nl(ap[k, i], t, q, c)
            dq = max(qold - q, 0.0)
            dr2 = cons2 * dp * dq
            if t < c.RTT:
                rfreeze2 = fwat * dr2
                fwatr = 0.0
            else:
                rfreeze2 = 0.0
                fwatr = 1.0
            rn = fwatr * dr2
            sn = (1.0 - fwatr) * dr2
            condl += fwatr * dq / dt
            condi += (1.0 - fwatr) * dq / dt
            rfln += rn
            sfln += sn
            rfreeze += rfreeze2

            tnd["q"][k, i] = -(condl + condi) + (lude[k, i] + evapr + evaps) * gdp
            tnd["t"][k, i] = (
                lvdcp * condl
                + lsdcp * condi
                - (
                    lvdcp * evapr
                    + lsdcp * evaps
                    + lude[k, i] * (fwat * lvdcp + (1 - fwat) * lsdcp)
                    - (lsdcp - lvdcp) * rfreeze
                )
                * gdp
            )
            tnd["ql"][k, i] = (qlwc - ql) / dt
            tnd["qi"][k, i] = (qiwc - qi) / dt
            diag["clc"][k, i] = clc

            diag["fplsl"][k + 1, i] = rfln
            diag["fplsn"][k + 1, i] = sfln
            rfl, sfl = rfln, sfln

    diag["fhpsl"] = -diag["fplsl"] * c.RLVTT
    diag["fhpsn"] = -diag["fplsn"] * c.RLSTT
    return tnd, diag


def golden_outputs(state: Fields, dt: float, c, dtype) -> Tuple[Fields, Fields]:
    """The golden tendencies and diagnostics of ``state`` in ``dtype``: the
    state rounded to ``dtype``, eta from column 0 and the saturation in
    ``dtype``, then the scheme in float64 math."""
    s = {k: v.astype(dtype) for k, v in state.items()}
    s["eta"] = (s["ap"][:, 0] / s["aph"][-1, 0]).astype(dtype)
    s["qsat"] = oracle_saturation(s["ap"], s["t"], c).astype(dtype)
    return oracle_nonlinear(s, dt, c)


def synthetic_golden(ncols: int, precision: str) -> Tuple[Fields, Fields]:
    """The golden tendencies and diagnostics of
    ``data/reference_synth_{precision}.h5`` tiled to ``ncols``, as
    :func:`cloudsc2_tpu_torch.iox.read_reference` reads them, computed in
    process."""
    from cloudsc2_tpu_torch import iox
    from cloudsc2_tpu_torch.params import make_constants

    dtype = np.float64 if precision == "double" else np.float32
    _, state, dt = iox.synthesize_input(ncols=iox.SYNTH_NCOLS, nlev=iox.SYNTH_NLEV, seed=iox.SYNTH_SEED)
    tends, diags = golden_outputs(state, dt, make_constants(lphylin=True, ldrain1d=False), dtype)

    def tile(d: Fields) -> Fields:
        return {k: iox._tile_columns(np.asarray(v, np.float64), ncols).astype(dtype) for k, v in d.items()}

    return tile(tends), tile(diags)
