// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// One level of the CLOUDSC2 nonlinear scheme for one column, and the
// per-column body that runs it through the level scan (levelscan.cuh).
//
// The scalar twin of nl_level (cloudsc2_tpu/physics/nonlinear.py:607) and of
// the plain torch version (cloudsc2_tpu_torch/physics/nonlinear.py): every
// expression is the JAX expression with the same operand order, so that
// the roundings are the same (the rules are in scalar_math.h).
// Static switches are template parameters, as the JAX body's Python values:
//   THERMO = LPHYLIN || LDRAIN1D,   EVAP = LEVAPLS2 || LDRAIN1D,
//   TRAJ: also write the carry entering each level, the trajectory the
//   adjoint's reverse sweep re-linearizes around (with_trajectory of
//   cloudsc2_tpu/pallas/nonlinear.py:214-226),
//   TRAJ_ONLY (with TRAJ): write the trajectory and nothing else, the
//   forward sweep of a gradient-only adjoint (traj_only, :386-392),
//   FUSE: diagnose qsat inside the kernel from ap and t instead of reading
//   it, and write it (unless TRAJ_ONLY) (fuse_saturation, :105-110,
//   :186-212, :394-395, :483-484),
//   D: the divide policy of Constants.FAST_DIV (scalar_math.h).
#pragma once

#include <string.h>

#include "scalar_math.h"

namespace cloudsc2 {

// ------------------------------------------------------------ argument lists
// Each list is mirrored in Python (state.NL_CONST_NAMES, kernels/nonlinear.py
// NL_INPUTS / NL_OUTPUTS); nl_signature() reports them for the wrapper to check.
// (sat_tice, sat_twat_r: the liquid-fraction ramp of the fused saturation,
// foealfa's RTICE or foealfcu's RTICECU by LPHYLIN and kflag; zscal, zeps1:
// scalm's, ScalmTable)
#define CLOUDSC2_NL_CONSTS(X)                                                  \
  X(dt) X(rdt) X(ckcodtl) X(ckcodti) X(cons2) X(cons3) X(cons2_rlmlt)          \
  X(meltp2) X(rcpd) X(rcpd_rvtmp2) X(rcpd_inv) X(rlmlt) X(rlstt) X(rlvtt)      \
  X(rtt) X(rtice) X(rtwat) X(rtwat_rtice_r) X(rlptrc) X(r2es) X(r3les)         \
  X(r3ies) X(r4les) X(r4ies) X(r5les) X(r5ies) X(r5alvcp) X(r5alscp)           \
  X(ralvdcp) X(ralsdcp) X(retv) X(zqmax) X(cor_clip) X(rg) X(rd) X(rlmin)      \
  X(zeps2) X(lcrit_k) X(icrit_k) X(dt_rg) X(rg_rpecons) X(sat_tice)            \
  X(sat_twat_r) X(zscal) X(zeps1)

// (nlev, ncols) fields, except aph (nlev+1, ncols) and eta (nlev,); with
// FUSE qsat is not read and may be null
#define CLOUDSC2_NL_INPUTS(X)                                                  \
  X(ap) X(aph) X(lu) X(lude) X(mfd) X(mfu) X(q) X(qi) X(ql) X(qsat) X(supsat)  \
  X(t) X(tnd_cml_q) X(tnd_cml_qi) X(tnd_cml_ql) X(tnd_cml_t) X(eta)

// (nlev, ncols) fields, except the fluxes (nlev+1, ncols).  The trajectory
// c_rfl, c_sfl, c_cov is written only with TRAJ, and c_cov only with EVAP
// too: with the evaporation branch compiled out the TL never reads the
// covptot carry (the c_cov elision of pallas/nonlinear.py:218-225); with
// TRAJ_ONLY the first ten are not written.  qsat_out, the diagnosed qsat,
// is written only with FUSE and without TRAJ_ONLY.  Those not written may
// be null.
#define CLOUDSC2_NL_OUTPUTS(X)                                                 \
  X(tnd_t) X(tnd_q) X(tnd_ql) X(tnd_qi) X(clc) X(covptot) X(fplsl) X(fplsn)    \
  X(fhpsl) X(fhpsn) X(c_rfl) X(c_sfl) X(c_cov) X(qsat_out)

// the int switches of the launch entry points, in their order (traj: 0 none,
// 1 the trajectory too, 2 the trajectory only; div: a DivMode; compact:
// CUADJ_COMPACT, which the library's form fixes, scalar_math.h)
#define CLOUDSC2_NL_SWITCHES(X) X(is_double) X(thermo) X(evap) X(traj) X(fuse) X(div) X(compact)

#define CLOUDSC2_STR(n) #n ","
inline const char* nl_signature() {
  return "switches:" CLOUDSC2_NL_SWITCHES(CLOUDSC2_STR)
         ";consts:" CLOUDSC2_NL_CONSTS(CLOUDSC2_STR)
         ";inputs:" CLOUDSC2_NL_INPUTS(CLOUDSC2_STR)
         ";outputs:" CLOUDSC2_NL_OUTPUTS(CLOUDSC2_STR);
}
#undef CLOUDSC2_STR

template <typename T>
struct NLConst {
#define CLOUDSC2_FIELD(n) T n;
  CLOUDSC2_NL_CONSTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
};

// scalm as every body reads it, scalm[k]: the level table (levelscan.cuh)
// of ZSCAL * max(eta - 0.2, ZEPS1) ** 0.2 (physics/nonlinear.py
// scalm_profile) from eta and the constant struct's zscal and zeps1, in
// torch's operations and order: the difference, the clamp (a NaN passes),
// the power, the product, each rounded once in T.  Every form of every
// kernel derives it so.  On an H100 it is bitwise torch's in float; in
// double libdevice's pow, built here without FMA contraction and in
// PyTorch with it, parts by up to 2 ulps at some 5e-7 of the arguments.
template <typename T>
struct ScalmTable {
  const T* eta;
  T zscal, zeps1;
  CLOUDSC2_HD T derive(int k) const { return zscal * m_pow(m_max(eta[k] - T(0.2), zeps1), T(0.2)); }
  CLOUDSC2_HD T operator[](int k) const { return level_table_at(*this, k); }
};

template <typename T>
struct NLFields {
#define CLOUDSC2_FIELD(n) const T* n;
  CLOUDSC2_NL_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
#define CLOUDSC2_FIELD(n) T* n;
  CLOUDSC2_NL_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  ScalmTable<T> scalm;  // from eta and the constants, not an input
};

// One level's inputs, with the combines the JAX wrapper forms in XLA
// (cloudsc2_tpu/pallas/nonlinear.py:165-191) already applied.
template <typename T>
struct NLLevelIn {
  T ap, dp, lu_next, lude, mf, q2, ql_fg, qi_fg, qsat, t_fg, eta, scalm;
};

// Per-column values: surface pressure and the critical-RH coefficients.
template <typename T>
struct NLCol {
  T aph_s, trpaus, rh2, deta1, rsq;
};

template <typename T>
struct NLCarry {
  T rfl, sfl, covptot;
};

template <typename T>
struct NLLevelOut {
  T tnd_t, tnd_q, tnd_ql, tnd_qi, clc, covptot;
};

// ------------------------------------------------------ pointwise physics ----
template <typename T>
CLOUDSC2_HD T foealfa(T t, const NLConst<T>& c) {
  const T x = (m_min(m_max(t, c.rtice), c.rtwat) - c.rtice) * c.rtwat_rtice_r;
  return m_min(T(1), x * x);
}

// The mixed-phase saturation pressure alfa * liquid + (1 - alfa) * ice,
// alfa the ramp from tice up to RTWAT with scale twat_r: foeewm
// (fcttre.py:40) with foealfa's RTICE, foeewmcu (:51) with foealfcu's
// RTICECU.
template <int D, typename T>
CLOUDSC2_HD T foeew_mixed(T t, T tice, T twat_r, const NLConst<T>& c) {
  const T x = (m_min(m_max(t, tice), c.rtwat) - tice) * twat_r;
  const T alfa = m_min(T(1), x * x);
  const T liq = c.r2es * m_exp(fdiv<D>(c.r3les * (t - c.rtt), t - c.r4les));
  const T ice = c.r2es * m_exp(fdiv<D>(c.r3ies * (t - c.rtt), t - c.r4ies));
  return alfa * liq + (T(1) - alfa) * ice;
}

template <int D, typename T>
CLOUDSC2_HD T foeewm(T t, const NLConst<T>& c) {
  return foeew_mixed<D>(t, c.rtice, c.rtwat_rtice_r, c);
}

// saturation (physics/saturation.py:52-59) at one point: qsat from the
// state temperature t (not the first guess).  Its branch is keyed on LPHYLIN
// and kflag, not on THERMO: LPHYLIN blends with foealfa, as foeewm does
// (kflag 2 without LPHYLIN), and kflag 1 without LPHYLIN is foeewmcu; the
// host picks the ramp (sat_tice, sat_twat_r).  Its divides are its own,
// not the level body's 1/ap: sharing that reciprocal moved the fused path
// off the unfused one (pallas/nonlinear.py:270-276).
template <int D, typename T>
CLOUDSC2_HD T saturation(T ap, T t, const NLConst<T>& c) {
  const T ew = foeew_mixed<D>(t, c.sat_tice, c.sat_twat_r, c);
  const T qs = m_min(fdiv<D>(ew, ap), c.zqmax);
  return fdiv<D>(qs, T(1) - c.retv * qs);
}

// tropopause_eta (nonlinear.py:59) for one column: the last level k with
// 0.1 < eta[k] < 0.4 and t_fg[k] > t_fg[k+1] wins; default 0.1.  t and
// tnd_cml_t are (nlev, ncols) with columns contiguous.
template <typename T>
CLOUDSC2_HD T tropopause_eta(const T* t, const T* tnd_cml_t, const T* eta, T dt, int nlev,
                             int ncols, int col) {
  T trpaus = T(0.1);
  size_t i = static_cast<size_t>(col);
  T tfg_next = t[i] + dt * tnd_cml_t[i];
  for (int k = 0; k + 1 < nlev; ++k) {
    const T tfg = tfg_next;
    i += static_cast<size_t>(ncols);
    tfg_next = t[i] + dt * tnd_cml_t[i];
    const T e = eta[k];
    if (e > T(0.1) && e < T(0.4) && tfg > tfg_next) trpaus = e;
  }
  return trpaus;
}

// critical_rh (nonlinear.py:127) with the hoisted per-column coefficients
template <typename T>
CLOUDSC2_HD T critical_rh(T eta, const NLCol<T>& col) {
  const T one = T(1);
  const T sq = m_sqrt(m_max(one - eta, T(0))) * col.rsq;
  if (eta < col.trpaus) return one;
  if (eta < col.trpaus + T(0.3))
    return one + (col.rh2 - one) * ((eta - col.trpaus) * T(1.0 / 0.3));
  if (eta < one - col.deta1) return col.rh2;
  return one + (col.rh2 - one) * sq;
}

// critical_rh_coeffs (nonlinear.py:111)
template <typename T>
CLOUDSC2_HD void critical_rh_coeffs(NLCol<T>& col) {
  const T d = (col.trpaus - T(0.25)) / T(0.15);
  col.rh2 = T(0.35) + T(0.14) * (d * d) +
            T(0.04) * m_min(col.trpaus - T(0.25), T(0)) / T(0.15);
  col.deta1 = T(0.09) + T(0.16) * (T(0.4) - col.trpaus) / T(0.3);
  col.rsq = T(1) / m_sqrt(col.deta1);
}

// cuadjtqs_nl (physics/cuadjtqs.py:85), rap = rcp<D>(ap): the compact form,
// or with kCompact off the reference-shaped one (:75-81), whose quotient
// fdiv<D>(foeew, ap) is foeew * rap under a non-exact policy, as the JAX
// form computes it in float
template <int D, typename T>
CLOUDSC2_HD void cuadjtqs_nl(T ap, T rap, T& t, T& q, const NLConst<T>& c) {
  const bool warm = t > c.rtt;
  const T z3es = warm ? c.r3les : c.r3ies;
  const T z4es = warm ? c.r4les : c.r4ies;
  const T z5alcp = warm ? c.r5alvcp : c.r5alscp;
  const T zaldcp = warm ? c.ralvdcp : c.ralsdcp;
  for (int it = 0; it < 2; ++it) {
    const T rt4 = rcp<D>(t - z4es);
    const T foeew = c.r2es * m_exp(z3es * (t - c.rtt) * rt4);
    T cond;
    if constexpr (kCompact) {
      const T s = m_min(foeew * rap, c.zqmax);
      const T u = T(1) - c.retv * s;
      const T z2s = z5alcp * rt4 * rt4;
      cond = fdiv<D>((q * u - s) * u, u * u + s * z2s);
    } else {
      const T qs = m_min(fdiv<D>(foeew, ap), c.zqmax);
      const T cor = rcp<D>(T(1) - c.retv * qs);
      const T qsat = qs * cor;
      const T z2s = z5alcp * rt4 * rt4;
      cond = fdiv<D>(q - qsat, T(1) + qsat * cor * z2s);
    }
    t = t + zaldcp * cond;
    q = q - cond;
  }
}

// ---------------------------------------------------------------- nl_level ----
// nl_level_pre (nonlinear.py:147) + nl_level_post (:399) on one point.
template <typename T, bool THERMO, bool EVAP, int D = DIV_EXACT>
CLOUDSC2_HD NLLevelOut<T> nl_level(NLCarry<T>& carry, const NLLevelIn<T>& x,
                                   const NLCol<T>& col, const NLConst<T>& c) {
  const T one = T(1), zero = T(0);
  NLLevelOut<T> out;

  // ---- phase A: carry-independent
  const T ap = x.ap, t = x.t_fg, q = x.q2, ql = x.ql_fg, qi = x.qi_fg;
  const T qsat_in = x.qsat, dp = x.dp, scalm = x.scalm;
  const T rap = rcp<D>(ap);

  // thermodynamic coefficients
  const T zz = c.rcpd + c.rcpd_rvtmp2 * q;
  const T rzz = rcp<D>(zz);
  const T lfdcp = c.rlmlt * rzz;
  const T lsdcp = c.rlstt * rzz;
  const T lvdcp = c.rlvtt * rzz;

  // dqs/dT correction factor
  const T rl = rcp<D>(t - c.r4les);
  const T ri = rcp<D>(t - c.r4ies);
  T fwat, foeew;
  if (THERMO) {
    const bool cold = t < c.rtt;
    fwat = cold ? T(0.545) * (m_tanh(T(0.17) * (t - c.rlptrc)) + one) : one;
    const T z3es = cold ? c.r3ies : c.r3les;
    const T rz4es = cold ? ri : rl;
    foeew = c.r2es * m_exp(z3es * (t - c.rtt) * rz4es);
  } else {
    fwat = foealfa(t, c);
    foeew = foeewm<D>(t, c);
  }
  const T esdp1 = foeew * rap;
  const T facw = c.r5les * rl * rl;
  const T faci = c.r5ies * ri * ri;
  const T fac = fwat * facw + (one - fwat) * faci;
  const T fac2 = rcp<D>(ap - c.retv * foeew);
  T cor = ap * fac2;
  if (THERMO) cor = esdp1 <= c.zqmax ? cor : c.cor_clip;
  const T dqsdtemp = fac * cor * qsat_in;
  const T corqs = one + c.cons3 * dqsdtemp;
  const T qlim = m_min(q, qsat_in);

  // critical humidity and ice supersaturation
  const T crh2 = critical_rh(x.eta, col);
  const T supsat_fac = t < c.rtice ? T(1.8) - T(0.003) * t : one;
  const T qsat = qsat_in * supsat_fac;
  const T qcrit = crh2 * qsat;

  // Letreut & Li cloud cover
  const T qt = q + ql + qi;
  const bool low = qt < qcrit;
  const bool high = qt >= qsat;
  const bool mid = !(low || high);
  const T qpd = qsat - qt;
  const T qcd = qsat - qcrit;
  const T denom_safe = mid ? qcd - scalm * (qt - qcrit) : one;
  const T ratio = m_min(mid ? fdiv<D>(qpd, denom_safe) : zero, one);
  const T clc_mid = one - m_sqrt(ratio);
  const T qc_mid = (scalm * qpd + (one - scalm) * qcd) * (clc_mid * clc_mid);
  const T qc_high = (one - scalm) * (qsat - qcrit);
  T clc = low ? zero : (high ? one : clc_mid);
  T qc = low ? zero : (high ? qc_high : qc_mid);

  // convective detrainment
  const T gdp = fdiv<D>(c.rg, dp);
  const T lude = c.dt * x.lude * gdp;
  const bool lo1 = (lude >= c.rlmin) && (x.lu_next >= c.zeps2);
  const T lu1_safe = lo1 ? x.lu_next : one;
  const T tmp2 = m_exp(fdiv<D>(-lude, lu1_safe));
  clc = clc + (lo1 ? (one - clc) * (one - tmp2) : zero);
  qc = qc + (lo1 ? lude : zero);

  // compensating subsidence
  const T fac1 = rcp<D>(c.rd * t);
  const T rho = ap * fac1;
  const T rodqsdp = -rho * qsat_in * fac2;
  const T ldcp = fwat * lvdcp + (one - fwat) * lsdcp;
  const T fac3 = rcp<D>(one + ldcp * dqsdtemp);
  const T dtdzmo = c.rg * (c.rcpd_inv - ldcp * rodqsdp) * fac3;
  const T dqsdz = dqsdtemp * dtdzmo - c.rg * rodqsdp;
  const T fac4 = c.rd * t * rap;
  const T sub = c.dt * dqsdz * x.mf * fac4;
  qc = sub < qc ? qc - sub : zero;

  // new condensate and condensation rates
  T qlwc = qc * fwat;
  T qiwc = qc * (one - fwat);
  const T condl = (qlwc - ql) * c.rdt;
  const T condi = (qiwc - qi) * c.rdt;

  // melt constants
  const T cons = c.cons2_rlmlt * dp * zz;
  const T rcons = c.dt * gdp * lfdcp;
  const T z2s = cons * m_max(t - c.meltp2, zero);

  // carry-free half of the autoconversion
  const bool act = clc > c.zeps2;
  const T rclc = rcp<D>(act ? clc : one);
  const T cldl = qlwc * rclc;
  const T ltmp1 = m_exp(-(cldl * cldl * c.lcrit_k));
  const T dl = c.ckcodtl * (one - ltmp1);
  const T ltmp2 = m_exp(-dl);
  const T qlnew = clc * cldl * ltmp2;
  const T prr = act ? m_max(qlwc - qlnew, zero) : zero;
  qlwc = qlwc - prr;
  const T cldi = qiwc * rclc;
  const T itmp11 = m_exp(-(cldi * cldi * c.icrit_k));
  out.tnd_ql = (qlwc - ql) * c.rdt;

  // ---- phase B: carry-dependent
  T covptot = m_max(carry.covptot, clc);
  const T covpclr = m_max(covptot - clc, zero);

  // melting of incoming snow
  const T sfl = carry.sfl;
  const T sm = sfl != zero ? m_min(sfl, z2s) : zero;
  T rfln = carry.rfl + sm;
  T sfln = sfl - sm;
  const T tm = t - sm * rcons;

  // melt-temperature half of the snow autoconversion
  const T itmp12 = m_exp(T(0.025) * (tm - c.rtt));
  const T di = c.ckcodti * itmp12 * (one - itmp11);
  const T itmp2 = m_exp(-di);
  const T qinew = clc * cldi * itmp2;
  const T prs = act ? m_max(qiwc - qinew, zero) : zero;
  qiwc = qiwc - prs;

  // new precipitation and rain fraction
  const T dr1 = c.cons2 * dp * (prr + prs);
  const bool coldt = tm < c.rtt;
  const T rfreeze = coldt ? c.cons2 * dp * prr : zero;
  const T fwatr1 = coldt ? zero : one;
  rfln = rfln + fwatr1 * dr1;
  sfln = sfln + (one - fwatr1) * dr1;

  // precipitation evaporation
  T evapr = zero, evaps = zero, covptot_out = zero;
  if (EVAP) {
    const T prtot = rfln + sfln;
    const bool eact = (prtot > c.zeps2) && (covpclr > c.zeps2);
    const T covptot_safe = eact ? covptot : one;
    const T covpclr_safe = eact ? covpclr : one;
    const T preclr1 = fdiv<D>(prtot * covpclr, covptot_safe);
    const T clcc = eact ? one - clc : one;
    const T qe = qsat_in - fdiv<D>((qsat_in - qlim) * covpclr, clcc * clcc);
    const T sqr = m_sqrt(fdiv<D>(ap, col.aph_s));
    const T barg = eact ? fdiv<D>(sqr / T(0.00509) * preclr1, covpclr_safe) : one;
    const T beta = c.rg_rpecons * m_pow(barg, T(0.5777));
    const T b = fdiv<D>(c.dt * beta * (qsat_in - qe), one + c.dt * beta * corqs);
    const T dtgdp = fdiv<D>(c.dt_rg, dp);
    const T dpr1 = fdiv<D>(covpclr * b, dtgdp);
    const T dpr = eact ? m_min(dpr1, preclr1) : zero;
    const T preclr = preclr1 - dpr;
    covptot = (eact && preclr <= zero) ? clc : covptot;
    covptot_out = eact ? covptot : zero;
    const T prtot_safe = eact ? prtot : one;
    evapr = eact ? fdiv<D>(dpr * rfln, prtot_safe) : zero;
    evaps = eact ? fdiv<D>(dpr * sfln, prtot_safe) : zero;
    rfln = rfln - evapr;
    sfln = sfln - evaps;
  }

  // T / q tendency update and first guess
  const T mix = fwat * lvdcp + (one - fwat) * lsdcp;
  const T dqdt = -(condl + condi) + (x.lude + evapr + evaps) * gdp;
  const T tmp7 = lvdcp * evapr + lsdcp * evaps + x.lude * mix - (lsdcp - lvdcp) * rfreeze;
  const T dtdt = lvdcp * condl + lsdcp * condi - tmp7 * gdp;
  T ta = tm + c.dt * dtdt;
  T qa = q + c.dt * dqdt;
  const T qold1 = qa;

  // saturation-adjustment clipping
  cuadjtqs_nl<D>(ap, rap, ta, qa, c);

  // post-clipping rain fraction and freezing, on the adjusted temperature
  const T dq = m_max(qold1 - qa, zero);
  const T dr2 = c.cons2 * dp * dq;
  const bool coldt2 = ta < c.rtt;
  const T rfreeze2 = coldt2 ? fwat * dr2 : zero;
  const T fwatr2 = coldt2 ? zero : one;
  const T condl2 = condl + fwatr2 * dq * c.rdt;
  const T condi2 = condi + (one - fwatr2) * dq * c.rdt;
  rfln = rfln + fwatr2 * dr2;
  sfln = sfln + (one - fwatr2) * dr2;
  const T rfreeze3 = rfreeze + rfreeze2;

  // output tendencies
  out.tnd_q = -(condl2 + condi2) + (x.lude + evapr + evaps) * gdp;
  const T tmp8 = lvdcp * evapr + lsdcp * evaps + x.lude * mix - (lsdcp - lvdcp) * rfreeze3;
  out.tnd_t = lvdcp * condl2 + lsdcp * condi2 - tmp8 * gdp;
  out.tnd_qi = (qiwc - qi) * c.rdt;
  out.clc = clc;
  out.covptot = covptot_out;
  carry.rfl = rfln;
  carry.sfl = sfln;
  carry.covptot = covptot;
  return out;
}

// ------------------------------------------------------------ column body ----
// The Body of level_scan_column: what cloudsc2_nl_pallas
// (cloudsc2_tpu/pallas/nonlinear.py:76) computes, for one column.
template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY = false, bool FUSE = false,
          int D = DIV_EXACT>
struct NLBody {
  static_assert(TRAJ || !TRAJ_ONLY, "TRAJ_ONLY requires TRAJ");
  NLFields<T> f;
  NLConst<T> c;
  int nlev, ncols;

  struct Column {
    NLCol<T> col;
    NLCarry<T> carry;
  };

  CLOUDSC2_HD size_t at(int k, int col) const {
    return static_cast<size_t>(k) * static_cast<size_t>(ncols) + static_cast<size_t>(col);
  }

  CLOUDSC2_HD const ScalmTable<T>& level_table() const { return f.scalm; }

  // Prologue: the tropopause, the critical-RH coefficients, and the zero
  // top interface of the fluxes.
  CLOUDSC2_HD Column begin(int col) const {
    Column s;
    s.col.trpaus = tropopause_eta(f.t, f.tnd_cml_t, f.eta, c.dt, nlev, ncols, col);
    critical_rh_coeffs(s.col);
    s.col.aph_s = f.aph[at(nlev, col)];
    s.carry.rfl = T(0);
    s.carry.sfl = T(0);
    s.carry.covptot = T(0);
    if (!TRAJ_ONLY) {
      f.fplsl[at(0, col)] = T(0);
      f.fplsn[at(0, col)] = T(0);
      f.fhpsl[at(0, col)] = -T(0) * c.rlvtt;
      f.fhpsn[at(0, col)] = -T(0) * c.rlstt;
    }
    return s;
  }

  // The level's inputs, folded from the raw fields; with FUSE qsat is
  // diagnosed from ap and t instead of read.
  CLOUDSC2_HD NLLevelIn<T> load(int col, int k) const {
    const size_t i = at(k, col);
    const size_t ib = at(k + 1, col);
    NLLevelIn<T> x;
    x.ap = f.ap[i];
    x.dp = f.aph[ib] - f.aph[i];
    x.lu_next = k + 1 < nlev ? f.lu[ib] : T(0);
    x.lude = f.lude[i];
    x.mf = f.mfu[i] + f.mfd[i];
    x.q2 = f.q[i] + c.dt * f.tnd_cml_q[i] + f.supsat[i];
    x.ql_fg = f.ql[i] + c.dt * f.tnd_cml_ql[i];
    x.qi_fg = f.qi[i] + c.dt * f.tnd_cml_qi[i];
    if constexpr (FUSE) {
      x.qsat = saturation<D>(x.ap, f.t[i], c);
    } else {
      x.qsat = f.qsat[i];
    }
    x.t_fg = f.t[i] + c.dt * f.tnd_cml_t[i];
    x.eta = f.eta[k];
    x.scalm = f.scalm[k];
    return x;
  }

  // The step's outputs at level k, from the level's outputs and the carry
  // leaving it (the fluxes at interface k+1).
  CLOUDSC2_HD void store(const Column& s, const NLLevelOut<T>& o, int col, int k) const {
    const size_t i = at(k, col);
    const size_t ib = at(k + 1, col);
    f.tnd_t[i] = o.tnd_t;
    f.tnd_q[i] = o.tnd_q;
    f.tnd_ql[i] = o.tnd_ql;
    f.tnd_qi[i] = o.tnd_qi;
    f.clc[i] = o.clc;
    f.covptot[i] = o.covptot;
    f.fplsl[ib] = s.carry.rfl;
    f.fplsn[ib] = s.carry.sfl;
    f.fhpsl[ib] = -s.carry.rfl * c.rlvtt;
    f.fhpsn[ib] = -s.carry.sfl * c.rlstt;
  }

  CLOUDSC2_HD void level(Column& s, int col, int k) const { step(s, load(col, k), col, k); }

  // Level k from its folded inputs: the trajectory entering it, the
  // diagnosed qsat, the level, its outputs.
  CLOUDSC2_HD void step(Column& s, const NLLevelIn<T>& x, int col, int k) const {
    const size_t i = at(k, col);
    if (TRAJ) {
      f.c_rfl[i] = s.carry.rfl;
      f.c_sfl[i] = s.carry.sfl;
      if (EVAP) f.c_cov[i] = s.carry.covptot;
    }
    if (FUSE && !TRAJ_ONLY) f.qsat_out[i] = x.qsat;
    const NLLevelOut<T> o = nl_level<T, THERMO, EVAP, D>(s.carry, x, s.col, c);
    if (!TRAJ_ONLY) store(s, o, col, k);
  }
};

// ------------------------------------------------------- pipelined body ----
// The raw inputs of one level in a slot of the pipelined scan's ring, in
// this order; qsat last, and absent with FUSE.  aph and lu are rows k+1
// (lu_next, and the interface below the level; the one above is carried
// from the level before).
enum NLRingField {
  NR_AP, NR_APH, NR_LU, NR_LUDE, NR_MFD, NR_MFU, NR_Q, NR_QI, NR_QL, NR_SUPSAT, NR_T, NR_TND_Q,
  NR_TND_QI, NR_TND_QL, NR_TND_T, NR_QSAT
};

// The ring of a dtype: its slots (DEPTH - 1 levels in flight while one
// runs) and where it lives, chosen by measurement on an H100 (an A/B of
// depths 2-7 in shared memory and of two slots in registers, with
// drivers/kernel_ab_torch.py; PERF.md section 6): in float three slots in
// shared memory (a slot is 16 fields x 128 values, 8 KB a block; 24 KB in
// all, so eight blocks of 128 fit an SM's 228 KB; four slots and more ran
// slower at four blocks an SM); in double two slots in registers
// (RegisterPair), where a ring in shared memory ran the unfused and
// trajectory forms 7-11% slower than the direct scan.
template <typename T>
struct NLRing {
  static constexpr int DEPTH = sizeof(T) == 4 ? 3 : 2;
  static constexpr bool SHARED = sizeof(T) == 4;
};

// tropopause_eta with the loads of U levels issued together, so that the
// pre-pass over the column has them in flight at once: the same values,
// compared in the same order (the last level in the window wins).
template <int U, typename T>
CLOUDSC2_HD T tropopause_eta_ahead(const T* t, const T* tnd_cml_t, const T* eta, T dt, int nlev,
                                   int ncols, int col) {
  T trpaus = T(0.1);
  const size_t n = static_cast<size_t>(ncols);
  T tfg_above = t[col] + dt * tnd_cml_t[col];
  for (int k0 = 1; k0 < nlev; k0 += U) {
    T tv[U], dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = static_cast<size_t>(k0 + u) * n + static_cast<size_t>(col);
      tv[u] = k0 + u < nlev ? t[i] : T(0);
      dv[u] = k0 + u < nlev ? tnd_cml_t[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < nlev) {
        const T tfg = tv[u] + dt * dv[u];
        const T e = eta[k0 + u - 1];
        if (e > T(0.1) && e < T(0.4) && tfg_above > tfg) trpaus = e;
        tfg_above = tfg;
      }
    }
  }
  return trpaus;
}

// The Body of level_scan_pipelined_column: NLBody's step, its inputs copied
// into the ring ahead of the level and folded from the slot as NLBody::load
// folds them from memory (the same operations in the same order).
template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY = false, bool FUSE = false,
          int D = DIV_EXACT>
struct NLPipeBody : NLBody<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D> {
  using Base = NLBody<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>;
  static constexpr int FIELDS = FUSE ? NR_QSAT : NR_QSAT + 1;

  struct Column : Base::Column {
    T aph_top;  // aph at the interface above the level
  };

  // Prologue: NLBody::begin with the tropopause pass's loads issued eight
  // levels at a time.
  CLOUDSC2_HD Column begin(int col) const {
    Column s;
    const NLFields<T>& f = this->f;
    s.col.trpaus = tropopause_eta_ahead<8>(f.t, f.tnd_cml_t, f.eta, this->c.dt, this->nlev, this->ncols, col);
    critical_rh_coeffs(s.col);
    s.col.aph_s = f.aph[this->at(this->nlev, col)];
    s.aph_top = f.aph[this->at(0, col)];
    s.carry.rfl = T(0);
    s.carry.sfl = T(0);
    s.carry.covptot = T(0);
    if (!TRAJ_ONLY) {
      f.fplsl[this->at(0, col)] = T(0);
      f.fplsn[this->at(0, col)] = T(0);
      f.fhpsl[this->at(0, col)] = -T(0) * this->c.rlvtt;
      f.fhpsn[this->at(0, col)] = -T(0) * this->c.rlstt;
    }
    return s;
  }

  template <class Ring>
  CLOUDSC2_HD void prefetch(Ring& r, int slot, int col, int k) const {
    const NLFields<T>& f = this->f;
    const size_t i = this->at(k, col);
    const size_t ib = this->at(k + 1, col);
    r.copy(slot, NR_AP, f.ap + i);
    r.copy(slot, NR_APH, f.aph + ib);
    if (k + 1 < this->nlev) r.copy(slot, NR_LU, f.lu + ib);
    r.copy(slot, NR_LUDE, f.lude + i);
    r.copy(slot, NR_MFD, f.mfd + i);
    r.copy(slot, NR_MFU, f.mfu + i);
    r.copy(slot, NR_Q, f.q + i);
    r.copy(slot, NR_QI, f.qi + i);
    r.copy(slot, NR_QL, f.ql + i);
    r.copy(slot, NR_SUPSAT, f.supsat + i);
    r.copy(slot, NR_T, f.t + i);
    r.copy(slot, NR_TND_Q, f.tnd_cml_q + i);
    r.copy(slot, NR_TND_QI, f.tnd_cml_qi + i);
    r.copy(slot, NR_TND_QL, f.tnd_cml_ql + i);
    r.copy(slot, NR_TND_T, f.tnd_cml_t + i);
    if constexpr (!FUSE) r.copy(slot, NR_QSAT, f.qsat + i);
  }

  template <class Slot>
  CLOUDSC2_HD void level(Column& s, const Slot& r, int col, int k) const {
    const NLLevelIn<T> x = fold(s, r, k);
    this->step(s, x, col, k);
  }

  // Level k's inputs folded from its slot (and the interface above it,
  // which then moves down a level): what NLBody::load folds from memory.
  // The fused AD's forward sweep (ad_fused.h) calls it alone.
  template <class Slot>
  CLOUDSC2_HD NLLevelIn<T> fold(Column& s, const Slot& r, int k) const {
    const NLConst<T>& c = this->c;
    NLLevelIn<T> x;
    const T aph_below = r(NR_APH);
    x.ap = r(NR_AP);
    x.dp = aph_below - s.aph_top;
    x.lu_next = k + 1 < this->nlev ? r(NR_LU) : T(0);
    x.lude = r(NR_LUDE);
    x.mf = r(NR_MFU) + r(NR_MFD);
    x.q2 = r(NR_Q) + c.dt * r(NR_TND_Q) + r(NR_SUPSAT);
    x.ql_fg = r(NR_QL) + c.dt * r(NR_TND_QL);
    x.qi_fg = r(NR_QI) + c.dt * r(NR_TND_QI);
    if constexpr (FUSE) {
      x.qsat = saturation<D>(x.ap, r(NR_T), c);
    } else {
      x.qsat = r(NR_QSAT);
    }
    x.t_fg = r(NR_T) + c.dt * r(NR_TND_T);
    const T* __restrict__ eta = this->f.eta;
    x.eta = eta[k];
    x.scalm = this->f.scalm[k];
    s.aph_top = aph_below;
    return x;
  }
};

// Fill a body from the wrapper's pointer lists (orders as in the X-lists).
template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY = false, bool FUSE = false,
          int D = DIV_EXACT>
inline NLBody<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D> make_nl_body(const void* const* in, void* const* out,
                                                                     const void* consts, int nlev, int ncols) {
  NLBody<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D> b;
  int i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<const T*>(in[i++]);
  CLOUDSC2_NL_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<T*>(out[i++]);
  CLOUDSC2_NL_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  memcpy(&b.c, consts, sizeof(NLConst<T>));
  b.f.scalm = {b.f.eta, b.c.zscal, b.c.zeps1};
  b.nlev = nlev;
  b.ncols = ncols;
  return b;
}

// Call L.template run<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>() for the
// runtime switches (traj: 0 none, 1 the trajectory too, 2 the trajectory
// only): 96 bodies in a library of either saturation-adjustment form, the
// exact divide in float and double and the faithful and approx policies in
// float, the only type the JAX kernel takes them in (f64 divides exactly).  Every body combines FUSE with every TRAJ form, as
// the JAX kernel accepts them.
template <class L, typename T, int D, bool THERMO, bool EVAP, bool FUSE>
inline int nl_dispatch_traj(const L& launcher, int traj) {
  if (traj == 2) return launcher.template run<T, THERMO, EVAP, true, true, FUSE, D>();
  return traj ? launcher.template run<T, THERMO, EVAP, true, false, FUSE, D>()
              : launcher.template run<T, THERMO, EVAP, false, false, FUSE, D>();
}

template <class L, typename T, int D, bool THERMO, bool EVAP>
inline int nl_dispatch_fuse(const L& launcher, int traj, int fuse) {
  return fuse ? nl_dispatch_traj<L, T, D, THERMO, EVAP, true>(launcher, traj)
              : nl_dispatch_traj<L, T, D, THERMO, EVAP, false>(launcher, traj);
}

template <class L, typename T, int D>
inline int nl_dispatch_t(const L& launcher, int thermo, int evap, int traj, int fuse) {
  if (thermo)
    return evap ? nl_dispatch_fuse<L, T, D, true, true>(launcher, traj, fuse)
                : nl_dispatch_fuse<L, T, D, true, false>(launcher, traj, fuse);
  return evap ? nl_dispatch_fuse<L, T, D, false, true>(launcher, traj, fuse)
              : nl_dispatch_fuse<L, T, D, false, false>(launcher, traj, fuse);
}

// The switches' range and the library's form, checked by both entries
// before nl_dispatch; returns true when valid.
inline bool nl_switches_valid(int nlev, int ncols, int is_double, int traj, int div, int compact) {
  return nlev >= 1 && ncols >= 1 && traj >= 0 && traj <= 2 && forms_valid(is_double, div, compact);
}

template <class L>
inline int nl_dispatch(const L& launcher, int is_double, int thermo, int evap, int traj, int fuse, int div) {
  return dispatch_type_div(is_double, div, -1, [&](auto t, auto d) {
    return nl_dispatch_t<L, decltype(t), decltype(d)::value>(launcher, thermo, evap, traj, fuse);
  });
}

#ifdef __CUDACC__
// rcp<D> alone, one point a thread (cloudsc2_rcp_probe, nonlinear.cu).
template <int D>
__global__ void rcp_probe_kernel(const float* x, float* r, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) r[i] = rcp<D>(x[i]);
}

// The kernels' derivation of scalm alone, one eta a thread
// (cloudsc2_scalm_probe, nonlinear.cu).
template <typename T>
__global__ void scalm_probe_kernel(const ScalmTable<T> table, T* scalm, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) scalm[i] = table.derive(i);
}
#endif

// Shared memory of one SM (228 KB), and what the card reserves of it for
// each resident block; the memory an SM splits between its shared memory
// and its L1 (256 KB).
constexpr size_t kSmSharedBytes = 233472;
constexpr size_t kBlockReservedBytes = 1024;
constexpr size_t kSmSramBytes = 262144;

// The blocks an SM that a launch of the float kernel (its ring in shared
// memory) sizes its shared-memory carveout for: the fewest of those its
// registers allow (register_blocks, the card's count with no shared
// memory asked), those the SM's memory holds, and those a launch of
// grid_blocks blocks on sms SMs keeps busy in its first wave, but never
// fewer than four.  A block holds shared_bytes and the 1 KB the card
// reserves in shared memory, and in L1 the lines of the copies it keeps in
// flight, in_flight_bytes: the ring's 4-byte cp.async copies pass through
// L1, and the carveout takes what it gives to shared memory from L1.  At
// 65,536 columns or fewer (512 blocks of 128 on 132 SMs) that is four, the
// grid in one wave; at 262,144 (2,048 blocks) it is what the memory holds,
// six in every float form, where the registers allow eight and four made
// 3.88 waves of 4 blocks.  Measured at 262,144 x 137 on an H100, four to
// eight blocks in turns: six ran the fused form 2.4% faster than four and
// 0.8% faster than eight, and eight blocks under the whole 228 KB carveout
// (L1 28 KB) 1.1-2.5% slower than under the 196 KB that eight need (L1 60
// KB).  At 65,536 columns the grid term's four ran every float form as
// fast as a carveout for six (L1 92 KB against 156 KB) or faster, by up to
// 3% (traj_only).  What the card then holds is what it makes of the
// carveout, rounded up to a size it offers (NLQuery).
constexpr int nl_carveout_blocks(int register_blocks, size_t shared_bytes, size_t in_flight_bytes,
                                 int grid_blocks, int sms) {
  const size_t block = shared_bytes + kBlockReservedBytes;
  const size_t by_shared = kSmSharedBytes / block;
  const size_t by_sram = kSmSramBytes / (block + in_flight_bytes);
  const int by_memory = static_cast<int>(by_shared < by_sram ? by_shared : by_sram);
  const int waves = (grid_blocks + sms - 1) / sms;
  const int wanted = waves > 4 ? waves : 4;
  const int cap = register_blocks < by_memory ? register_blocks : by_memory;
  return wanted < cap ? wanted : cap;
}

#ifdef __CUDACC__
constexpr int kNLThreads = 128;  // threads a block
// Devices whose attributes NLKernel::prepare keeps (any further one sets
// them at every launch).
constexpr int kNLMaxDevices = 64;

namespace {
// What NLKernel K's prepare has read and set on each device.  In an
// unnamed namespace, so that each library keeps its own: the libraries of
// both saturation-adjustment forms instantiate the same NLKernel for
// kernels of their own, and a static of NLKernel itself would be one
// object in the whole process (the loader unifies them), so one library
// would take the other's kernel's attributes for set.
template <class K>
struct NLAttributes {
  static inline int limits[kNLMaxDevices][2];  // {register blocks, SMs}; 0 SMs: not read yet
  static inline long long set[kNLMaxDevices];  // nlev * 64 + blocks set; 0: not yet set
};
}  // namespace

// The device kernel of one body: its entry point, and what its launch
// needs (dynamic shared bytes a block of `threads` at `nlev` levels: the
// level table, then the ring).
template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY, bool FUSE, int D>
struct NLKernel {
  using Body = NLPipeBody<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>;
  static constexpr int DEPTH = NLRing<T>::DEPTH;
  static constexpr bool SHARED = NLRing<T>::SHARED;
  static auto fn() { return &level_scan_pipelined_kernel<Body, T, DEPTH, SHARED, false, kNLThreads, 4>; }
  // a ring slot's bytes a block of `threads` (0: the ring is in registers)
  static size_t slot_bytes(int threads) {
    return SHARED ? static_cast<size_t>(Body::FIELDS) * static_cast<size_t>(threads) * sizeof(T) : 0;
  }
  static size_t shared_bytes(int threads, int nlev) { return level_table_bytes<T>(nlev) + DEPTH * slot_bytes(threads); }
  // The card's limits of fn() on device dev, read once per device: the
  // blocks of kNLThreads an SM its registers allow (no shared memory
  // asked) and the SMs.
  static cudaError_t limits(int dev, int* register_blocks, int* sms) {
    auto& read = NLAttributes<NLKernel>::limits;
    if (dev < kNLMaxDevices && __atomic_load_n(&read[dev][1], __ATOMIC_ACQUIRE)) {
      *register_blocks = read[dev][0];
      *sms = read[dev][1];
      return cudaSuccess;
    }
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(register_blocks, fn(), kNLThreads, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < kNLMaxDevices) {
      read[dev][0] = *register_blocks;
      __atomic_store_n(&read[dev][1], *sms, __ATOMIC_RELEASE);
    }
    return err;
  }
  // Ready fn() for a launch of ncols columns at nlev levels on the current
  // device: allow the bytes and, with the ring in shared memory, ask for
  // the carveout that nl_carveout_blocks' blocks need (each block costs 1
  // KB more; the rest of the SM's memory stays L1); *blocks is that count,
  // 0 where the kernel asks for none (the ring in registers).  The
  // attributes are set once per device, depth and count, and again only
  // when another is wanted.
  static cudaError_t prepare(int threads, int nlev, int ncols, int* blocks) {
    const size_t bytes = shared_bytes(threads, nlev);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    *blocks = 0;
    if (SHARED) {
      int register_blocks = 0, sms = 0;
      err = limits(dev, &register_blocks, &sms);
      if (err != cudaSuccess) return err;
      // in flight while a level runs: the slots of the levels ahead
      *blocks = nl_carveout_blocks(register_blocks, bytes, (DEPTH - 1) * slot_bytes(threads),
                                   (ncols + threads - 1) / threads, sms);
    }
    auto& set = NLAttributes<NLKernel>::set;
    const long long key = static_cast<long long>(nlev) * 64 + *blocks;
    if (dev < kNLMaxDevices && __atomic_load_n(&set[dev], __ATOMIC_ACQUIRE) == key) return cudaSuccess;
    err = allow_dynamic_shared(fn(), bytes);
    if (err == cudaSuccess && SHARED) {
      const size_t want = static_cast<size_t>(*blocks) * (bytes + kBlockReservedBytes);
      const int percent = static_cast<int>((want * 100 + kSmSharedBytes - 1) / kSmSharedBytes);
      err = cudaFuncSetAttribute(fn(), cudaFuncAttributePreferredSharedMemoryCarveout, percent > 100 ? 100 : percent);
    }
    if (err == cudaSuccess && dev < kNLMaxDevices) __atomic_store_n(&set[dev], key, __ATOMIC_RELEASE);
    return err;
  }
  static void launch(int blocks, int threads, cudaStream_t stream,
                     const NLBody<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>& body) {
    level_scan_pipelined_kernel<Body, T, DEPTH, SHARED, false, kNLThreads, 4>
        <<<blocks, threads, shared_bytes(threads, body.nlev), stream>>>(Body{body});
  }
};

// The device launcher (nonlinear.cu): one thread per column, 128 a block,
// on the caller's stream; returns the launch's cudaError_t.
struct NLLauncher {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;
  cudaStream_t stream;

  template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY, bool FUSE, int D>
  int run() const {
    using K = NLKernel<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>;
    int carveout_blocks = 0;
    const cudaError_t err = K::prepare(kNLThreads, nlev, ncols, &carveout_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto body = make_nl_body<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>(in, out, consts, nlev, ncols);
    const int blocks = (ncols + kNLThreads - 1) / kNLThreads;
    K::launch(blocks, kNLThreads, stream, body);
    return static_cast<int>(cudaGetLastError());
  }
};

// What the card makes of one body's kernel at 128 threads a block, nlev
// levels and a launch of ncols columns (cloudsc2_nl_occupancy,
// nonlinear.cu), after the attributes that launch sets: out[0..5] =
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
// carveout asked), registers and local (spill) bytes a thread
// (cudaFuncGetAttributes), dynamic shared bytes a block, ring depth, and
// the blocks the carveout was sized for (nl_carveout_blocks; 0: none
// asked).  Returns a cudaError_t.
struct NLQuery {
  int* out;
  int nlev, ncols;

  template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY, bool FUSE, int D>
  int run() const {
    using K = NLKernel<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>;
    int carveout_blocks = 0;
    cudaError_t err = K::prepare(kNLThreads, nlev, ncols, &carveout_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K::fn(), kNLThreads,
                                                        K::shared_bytes(kNLThreads, nlev));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, K::fn());
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = per_sm;
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = static_cast<int>(K::shared_bytes(kNLThreads, nlev));
    out[4] = K::DEPTH;
    out[5] = carveout_blocks;
    return 0;
  }
};
#endif

// The host build's runners (nonlinear_host.cpp): the columns in a loop,
// through the pipelined scan the card runs (the card's ring, the shared
// one as HostRing models it), or with DIRECT through the direct scan of
// NLBody.
template <bool DIRECT>
struct NLHostRunner {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;

  template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY, bool FUSE, int D>
  int run() const {
    const auto body = make_nl_body<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>(in, out, consts, nlev, ncols);
    if constexpr (DIRECT) {
      level_scan_host(body);
    } else {
      using Pipe = NLPipeBody<T, THERMO, EVAP, TRAJ, TRAJ_ONLY, FUSE, D>;
      level_scan_pipelined_host<NLRing<T>::DEPTH, NLRing<T>::SHARED, Pipe, T>(Pipe{body});
    }
    return 0;
  }
};

}  // namespace cloudsc2
