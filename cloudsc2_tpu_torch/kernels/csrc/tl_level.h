// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// One level of the CLOUDSC2 tangent-linear scheme for one column, and the
// per-column body that runs it through the level scan (levelscan.cuh).
//
// The scalar twin of tl_level (cloudsc2_tpu/physics/tangent_linear.py:739)
// and of the plain torch version (cloudsc2_tpu_torch/physics/
// tangent_linear.py): every forward value x travels with its perturbation
// x_i, and every expression is the JAX expression with the same operand
// order (rules in scalar_math.h).  The critical RH and the tropopause are
// the NL body's (nl_level.h), as the JAX TL imports them from the NL.
// Static switches are template parameters:
//   EVAP = LEVAPLS2 || LDRAIN1D;  LREGCL (the three in-level damping sites;
//   the autoconversion one is folded into dl_k/di_k);  TANGENT_ONLY (write
//   only the *_i outputs);  D, the divide policy of Constants.FAST_DIV
//   (scalar_math.h) at every divide the JAX body routes through fastmath.
// The library's form picks the saturation adjustment (kCompact).
// The TL always uses the tanh water fraction, so it has no THERMO switch.
#pragma once

#include <string.h>

#include "nl_level.h"
#include "scalar_math.h"

namespace cloudsc2 {

// ------------------------------------------------------------ argument lists
// Mirrored in Python (state.TL_CONST_NAMES, kernels/tangent_linear.py
// TL_INPUTS / TL_OUTPUTS); tl_signature() reports them for the wrapper.
// (zscal, zeps1: scalm's, nl_level.h ScalmTable)
#define CLOUDSC2_TL_CONSTS(X)                                                  \
  X(dt) X(rdt) X(cons2) X(cons3) X(cons2_rlmlt) X(meltp2) X(rcpd)              \
  X(rcpd_rvtmp2) X(rcpd_inv) X(rlmlt) X(rlstt) X(rlvtt) X(rtt) X(rtice)        \
  X(rlptrc) X(r2es) X(r3les) X(r3ies) X(r4les) X(r4ies) X(r5les) X(r5ies)      \
  X(m2_r5les) X(m2_r5ies) X(r5alvcp) X(r5alscp) X(ralvdcp) X(ralsdcp) X(retv)  \
  X(zqmax) X(rg) X(rd) X(rlmin) X(zeps2) X(ckcodtl) X(ckcodti) X(lcrit_k)      \
  X(icrit_k) X(icrit_k2) X(dl_k) X(di_k) X(dt_rg) X(mdt_rg) X(rg_rpecons)      \
  X(beta_i_k) X(zscal) X(zeps1)

// (nlev, ncols) fields, except aph, aph_i (nlev+1, ncols) and eta (nlev,)
#define CLOUDSC2_TL_INPUTS(X)                                                  \
  X(ap) X(aph) X(lu) X(lude) X(mfd) X(mfu) X(q) X(qi) X(ql) X(qsat) X(supsat)  \
  X(t) X(tnd_cml_q) X(tnd_cml_qi) X(tnd_cml_ql) X(tnd_cml_t)                   \
  X(ap_i) X(aph_i) X(lu_i) X(lude_i) X(mfd_i) X(mfu_i) X(q_i) X(qi_i) X(ql_i)  \
  X(qsat_i) X(supsat_i) X(t_i) X(tnd_cml_q_i) X(tnd_cml_qi_i) X(tnd_cml_ql_i)  \
  X(tnd_cml_t_i) X(eta)

// (nlev, ncols) fields, except the fluxes (nlev+1, ncols); the first ten
// are not written (and may be null) with TANGENT_ONLY
#define CLOUDSC2_TL_OUTPUTS(X)                                                 \
  X(tnd_t) X(tnd_q) X(tnd_ql) X(tnd_qi) X(clc) X(covptot) X(fplsl) X(fplsn)    \
  X(fhpsl) X(fhpsn) X(tnd_t_i) X(tnd_q_i) X(tnd_ql_i) X(tnd_qi_i) X(clc_i)     \
  X(covptot_i) X(fplsl_i) X(fplsn_i) X(fhpsl_i) X(fhpsn_i)

#define CLOUDSC2_STR(n) #n ","
inline const char* tl_signature() {
  return "consts:" CLOUDSC2_TL_CONSTS(CLOUDSC2_STR)
         ";inputs:" CLOUDSC2_TL_INPUTS(CLOUDSC2_STR)
         ";outputs:" CLOUDSC2_TL_OUTPUTS(CLOUDSC2_STR);
}
#undef CLOUDSC2_STR

template <typename T>
struct TLConst {
#define CLOUDSC2_FIELD(n) T n;
  CLOUDSC2_TL_CONSTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
};

template <typename T>
struct TLFields {
#define CLOUDSC2_FIELD(n) const T* n;
  CLOUDSC2_TL_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
#define CLOUDSC2_FIELD(n) T* n;
  CLOUDSC2_TL_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  ScalmTable<T> scalm;  // from eta and the constants, not an input
};

// One level's inputs, with the combines the JAX wrapper forms in XLA
// (cloudsc2_tpu/pallas/tangent_linear.py:109-156) already applied.
template <typename T>
struct TLLevelIn {
  T ap, dp, lu_next, lude, mf, q2, ql_fg, qi_fg, qsat, t_fg;
  T ap_i, dp_i, lu_next_i, lude_i, mf_i, q2_i, ql_fg_i, qi_fg_i, qsat_i, t_fg_i;
  T eta, scalm;
};

// Per-column values: the NL body's (surface pressure, critical-RH
// coefficients) and the surface-pressure perturbation.
template <typename T>
struct TLCol : NLCol<T> {
  T aph_s_i;
};

template <typename T>
struct TLCarry {
  T rfl, sfl, covptot, rfl_i, sfl_i, covptot_i;
};

template <typename T>
struct TLLevelOut {
  T tnd_t, tnd_q, tnd_ql, tnd_qi, clc, covptot;
  T tnd_t_i, tnd_q_i, tnd_ql_i, tnd_qi_i, clc_i, covptot_i;
};

// cuadjtqs_tl (physics/cuadjtqs.py:147): two iterations with the phase
// chosen once from the input temperature and qp = 1/ap shared; the compact
// form, or with kCompact off the reference-shaped one (:134-143).
template <int D, typename T>
CLOUDSC2_HD void cuadjtqs_tl(T ap, T ap_i, T& t, T& t_i, T& q, T& q_i, const TLConst<T>& c) {
  const T one = T(1), zero = T(0);
  const bool warm = t > c.rtt;
  const T z3es = warm ? c.r3les : c.r3ies;
  const T z4es = warm ? c.r4les : c.r4ies;
  const T z5alcp = warm ? c.r5alvcp : c.r5alscp;
  const T zaldcp = warm ? c.ralvdcp : c.ralsdcp;
  const T qp = rcp<D>(ap);
  for (int it = 0; it < 2; ++it) {
    const T qp_i = -ap_i * qp * qp;
    const T rt4 = rcp<D>(t - z4es);
    const T foeew = c.r2es * m_exp(z3es * (t - c.rtt) * rt4);
    const T foeew_i = foeew * z3es * t_i * (c.rtt - z4es) * rt4 * rt4;
    const T qsat = qp * foeew;
    const T qsat_i = qp_i * foeew + qp * foeew_i;
    const bool noclip = qsat <= c.zqmax;
    const T s = m_min(qsat, c.zqmax);
    const T s_i = noclip ? qsat_i : zero;
    const T z2s = z5alcp * rt4 * rt4;
    const T z2s_i = T(-2) * z2s * t_i * rt4;
    T cond, cond_i;
    if constexpr (kCompact) {
      const T u = one - c.retv * s;
      const T u_i = -c.retv * s_i;
      const T w = q * u - s;
      const T num = w * u;
      const T den = u * u + s * z2s;
      const T num_i = (q_i * u + q * u_i - s_i) * u + w * u_i;
      const T den_i = T(2) * u * u_i + s_i * z2s + s * z2s_i;
      const T rden = rcp<D>(den);
      cond = num * rden;
      cond_i = (num_i - cond * den_i) * rden;
    } else {
      const T cor = rcp<D>(one - c.retv * s);
      const T cor_i = c.retv * s_i * cor * cor;
      const T qs_i = s_i * cor + s * cor_i;
      const T qs = s * cor;
      const T rdenom = rcp<D>(one + qs * cor * z2s);
      cond = (q - qs) * rdenom;
      cond_i = (q_i - qs_i) * rdenom -
               (q - qs) * (qs_i * cor * z2s + qs * cor_i * z2s + qs * cor * z2s_i) * rdenom * rdenom;
    }
    t = t + zaldcp * cond;
    t_i = t_i + zaldcp * cond_i;
    q = q - cond;
    q_i = q_i - cond_i;
  }
}

// ---------------------------------------------------------------- tl_level ----
// tl_level_pre (tangent_linear.py:54) + tl_level_post (:403) on one point.
template <typename T, bool EVAP, bool LREGCL, int D = DIV_EXACT>
CLOUDSC2_HD TLLevelOut<T> tl_level(TLCarry<T>& carry, const TLLevelIn<T>& x,
                                   const TLCol<T>& col, const TLConst<T>& c) {
  const T one = T(1), zero = T(0);
  TLLevelOut<T> out;

  // ---- phase A: carry-independent
  const T ap = x.ap, ap_i = x.ap_i, qsat_in = x.qsat, qsat_in_i = x.qsat_i;
  const T t = x.t_fg, t_i = x.t_fg_i, q = x.q2, q_i = x.q2_i;
  const T ql = x.ql_fg, ql_i = x.ql_fg_i, qi = x.qi_fg, qi_i = x.qi_fg_i;
  const T dp = x.dp, dp_i = x.dp_i, scalm = x.scalm;

  // thermodynamic coefficients, one shared reciprocal of D
  const T zd = c.rcpd + c.rcpd_rvtmp2 * q;
  const T zd_i = c.rcpd_rvtmp2 * q_i;
  const T zz = rcp<D>(zd);
  const T zz_i = -zd_i * (zz * zz);
  const T lfdcp = c.rlmlt * zz, lfdcp_i = c.rlmlt * zz_i;
  const T lsdcp = c.rlstt * zz, lsdcp_i = c.rlstt * zz_i;
  const T lvdcp = c.rlvtt * zz, lvdcp_i = c.rlvtt * zz_i;

  // dqs/dT correction factor, tanh branch
  const bool cold = t < c.rtt;
  const T th = m_tanh(T(0.17) * (t - c.rlptrc));
  const T fwat = cold ? T(0.545) * (th + one) : one;
  const T fwat_i = cold ? T(0.545 * 0.17) * t_i * (one - th * th) : zero;
  const T z3es = cold ? c.r3ies : c.r3les;
  const T z4es = cold ? c.r4ies : c.r4les;
  const T rl = rcp<D>(t - c.r4les);
  const T ri = rcp<D>(t - c.r4ies);
  const T rz4es = cold ? ri : rl;
  const T rap = rcp<D>(ap);
  const T foeew = c.r2es * m_exp(z3es * (t - c.rtt) * rz4es);
  const T foeew_i = z3es * (c.rtt - z4es) * t_i * foeew * (rz4es * rz4es);
  const T esdp0 = foeew * rap;
  const T esdp0_i = (foeew_i - esdp0 * ap_i) * rap;
  const bool noclip = esdp0 <= c.zqmax;
  const T esdp = m_min(esdp0, c.zqmax);
  const T esdp_i = noclip ? esdp0_i : zero;

  const T facw = c.r5les * (rl * rl);
  const T facw_i = c.m2_r5les * t_i * (rl * rl * rl);
  const T faci = c.r5ies * (ri * ri);
  const T faci_i = c.m2_r5ies * t_i * (ri * ri * ri);
  const T fac = fwat * facw + (one - fwat) * faci;
  const T fac_i = fwat_i * (facw - faci) + fwat * facw_i + (one - fwat) * faci_i;
  const T cor = rcp<D>(one - c.retv * esdp);
  const T cor_i = c.retv * esdp_i * (cor * cor);
  const T dqsdtemp = fac * cor * qsat_in;
  const T dqsdtemp_i = fac_i * cor * qsat_in + fac * cor_i * qsat_in + fac * cor * qsat_in_i;
  const T corqs = one + c.cons3 * dqsdtemp;
  const T corqs_i = c.cons3 * dqsdtemp_i;

  // clipped state
  const T qlim = m_min(q, qsat_in);
  const T qlim_i = q > qsat_in ? qsat_in_i : q_i;

  // critical humidity and ice supersaturation
  const T crh2 = critical_rh(x.eta, static_cast<const NLCol<T>&>(col));
  const bool cold_ice = t < c.rtice;
  const T supsat_fac = cold_ice ? T(1.8) - T(0.003) * t : one;
  const T supsat_fac_i = cold_ice ? T(-0.003) * t_i : zero;
  const T qsat = qsat_in * supsat_fac;
  const T qsat_i = qsat_in_i * supsat_fac + qsat_in * supsat_fac_i;
  const T qcrit = crh2 * qsat;
  const T qcrit_i = crh2 * qsat_i;

  // cloud cover and its perturbation
  const T qt = q + ql + qi;
  const T qt_i = q_i + ql_i + qi_i;
  const bool low = qt < qcrit;
  const bool high = qt >= qsat;
  const bool mid = !(low || high);
  const T qpd = qsat - qt, qpd_i = qsat_i - qt_i;
  const T qcd = qsat - qcrit, qcd_i = qsat_i - qcrit_i;
  const T denom = qcd - scalm * (qt - qcrit);
  const T rdenom = rcp<D>(mid ? denom : one);
  const T ratio = mid ? qpd * rdenom : zero;
  const T clc_mid = one - m_sqrt(ratio);
  const T rtmp1 = one / m_sqrt(mid ? ratio : one);
  T clc_mid_i = T(-0.5) * rtmp1 * (qpd_i * denom - qpd * (qcd_i - scalm * (qt_i - qcrit_i))) *
                (rdenom * rdenom);
  if (LREGCL) {
    // regularization of the cloud-fraction perturbation
    const T rat = fdiv<D>(qpd, mid ? qcd : one);
    const T u = one - scalm * (one - rat);
    const T yyy = m_min(fdiv_scalar<D>(T(3.5) * m_sqrt(m_max(rat * (u * u * u), zero)), one - scalm), T(0.3));
    clc_mid_i = clc_mid_i * yyy;
  }
  const T qc_mid = (scalm * qpd + (one - scalm) * qcd) * (clc_mid * clc_mid);
  const T qc_mid_i = (scalm * qpd_i + (one - scalm) * qcd_i) * (clc_mid * clc_mid) +
                     T(2) * (scalm * qpd + (one - scalm) * qcd) * clc_mid * clc_mid_i;
  const T qc_high = (one - scalm) * (qsat - qcrit);
  const T qc_high_i = (one - scalm) * (qsat_i - qcrit_i);
  T clc = low ? zero : (high ? one : clc_mid);
  T clc_i = low ? zero : (high ? zero : clc_mid_i);
  T qc = low ? zero : (high ? qc_high : qc_mid);
  T qc_i = low ? zero : (high ? qc_high_i : qc_mid_i);

  // convective detrainment; one reciprocal each of dp and lu1_safe
  const T rdp = rcp<D>(dp);
  const T gdp = c.rg * rdp;
  const T gdp_i = -c.rg * dp_i * (rdp * rdp);
  const T lude = c.dt * x.lude * gdp;
  const T lude_i = c.dt * (x.lude_i * gdp + x.lude * gdp_i);
  const bool lo1 = (lude >= c.rlmin) && (x.lu_next >= c.zeps2);
  const T rlu1 = rcp<D>(lo1 ? x.lu_next : one);
  const T tmp2 = m_exp(-lude * rlu1);
  const T clc_i_conv = -clc_i * (one - tmp2) +
                       (one - clc) * tmp2 * ((lude_i - lude * x.lu_next_i * rlu1) * rlu1);
  clc_i = clc_i + (lo1 ? clc_i_conv : zero);
  clc = clc + (lo1 ? (one - clc) * (one - tmp2) : zero);
  qc = qc + (lo1 ? lude : zero);
  qc_i = qc_i + (lo1 ? lude_i : zero);

  // compensating subsidence
  const T fac1 = rcp<D>(c.rd * t);
  const T rho = ap * fac1;
  const T rho_i = (ap_i - ap * t_i * (c.rd * fac1)) * fac1;
  const T fac2 = rcp<D>(ap - c.retv * foeew);
  const T rodqsdp = -rho * qsat_in * fac2;
  const T rodqsdp_i =
      (-rho_i * qsat_in - rho * qsat_in_i + rho * qsat_in * (ap_i - c.retv * foeew_i) * fac2) *
      fac2;
  const T ldcp = fwat * lvdcp + (one - fwat) * lsdcp;
  const T ldcp_i = fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (one - fwat) * lsdcp_i;
  const T fac3 = rcp<D>(one + ldcp * dqsdtemp);
  const T dtdzmo = c.rg * (c.rcpd_inv - ldcp * rodqsdp) * fac3;
  const T dtdzmo_i = -(c.rg * (ldcp_i * rodqsdp + ldcp * rodqsdp_i) +
                       dtdzmo * (ldcp_i * dqsdtemp + ldcp * dqsdtemp_i)) *
                     fac3;
  const T dqsdz = dqsdtemp * dtdzmo - c.rg * rodqsdp;
  const T dqsdz_i = dqsdtemp_i * dtdzmo + dqsdtemp * dtdzmo_i - c.rg * rodqsdp_i;
  const T fac4 = c.rd * t * rap;
  const T sub = c.dt * dqsdz * x.mf * fac4;
  const bool lo3 = sub < qc;
  const T dqc = lo3 ? sub : qc;
  T dqc_i_sub = (c.dt * (dqsdz_i * x.mf + dqsdz * x.mf_i) - dqc * rho_i) * fac4;
  if (LREGCL) dqc_i_sub = dqc_i_sub * T(0.1);
  qc = lo3 ? qc - sub : zero;
  qc_i = lo3 ? qc_i - dqc_i_sub : zero;

  // new condensate and condensation rates
  T qlwc = qc * fwat;
  T qlwc_i = qc_i * fwat + qc * fwat_i;
  T qiwc = qc * (one - fwat);
  T qiwc_i = qc_i * (one - fwat) - qc * fwat_i;
  T condl = (qlwc - ql) * c.rdt, condl_i = (qlwc_i - ql_i) * c.rdt;
  T condi = (qiwc - qi) * c.rdt, condi_i = (qiwc_i - qi_i) * c.rdt;

  // melt constants, division-free (rcons = 1/cons exactly)
  const T cons = c.cons2_rlmlt * dp * zd;
  const T cons_i = c.cons2_rlmlt * (dp_i * zd + dp * zd_i);
  const T rcons = c.dt * gdp * lfdcp;
  const T rcons_i = c.dt * (gdp_i * lfdcp + gdp * lfdcp_i);
  const bool warm = t > c.meltp2;
  const T z2s = cons * m_max(t - c.meltp2, zero);
  const T z2s_i = warm ? cons_i * (t - c.meltp2) + cons * t_i : zero;

  // autoconversion of cloud water, and the carry-free half for ice
  const bool act = clc > c.zeps2;
  const T rclc = rcp<D>(act ? clc : one);
  const T cldl = qlwc * rclc;
  const T cldl_i = (qlwc_i - cldl * clc_i) * rclc;
  const T ltmp4 = m_exp(-(cldl * cldl * c.lcrit_k));
  const T dl = c.ckcodtl * (one - ltmp4);
  const T ltmp5 = m_exp(-dl);
  const T dl_i = c.dl_k * ltmp4 * cldl * cldl_i;
  const T qlnew = clc * cldl * ltmp5;
  const T qlnew_i = clc_i * cldl * ltmp5 + clc * cldl_i * ltmp5 - clc * cldl * ltmp5 * dl_i;
  const T prr = act ? qlwc - qlnew : zero;
  const T prr_i = act ? qlwc_i - qlnew_i : zero;
  qlwc = qlwc - prr;
  qlwc_i = qlwc_i - prr_i;
  const T cldi = qiwc * rclc;
  const T cldi_i = (qiwc_i - cldi * clc_i) * rclc;
  const T itmp41 = m_exp(-(cldi * cldi * c.icrit_k));
  out.tnd_ql = (qlwc - ql) * c.rdt;
  out.tnd_ql_i = (qlwc_i - ql_i) * c.rdt;

  // ---- phase B: carry-dependent
  // maximum precipitation overlap
  const bool grow = clc > carry.covptot;
  T covptot = m_max(carry.covptot, clc);
  T covptot_i = grow ? clc_i : carry.covptot_i;
  const T covpclr1 = covptot - clc;
  const bool pos = covpclr1 >= zero;
  const T covpclr = m_max(covpclr1, zero);
  const T covpclr_i = pos ? covptot_i - clc_i : zero;

  // melting of incoming snow
  const T sfl = carry.sfl, sfl_i = carry.sfl_i;
  const bool melt = sfl != zero;
  const T snmlt = m_min(sfl, z2s);
  const T snmlt_i = sfl <= z2s ? sfl_i : z2s_i;
  const T sm = melt ? snmlt : zero;
  const T smi = melt ? snmlt_i : zero;
  T rfln = carry.rfl + sm, rfln_i = carry.rfl_i + smi;
  T sfln = sfl - sm, sfln_i = sfl_i - smi;
  const T tm_i = t_i - (smi * rcons + sm * rcons_i);
  const T tm = t - sm * rcons;

  // melt-temperature half of the ice autoconversion
  const T itmp42 = m_exp(T(0.025) * (tm - c.rtt));
  const T di = c.ckcodti * itmp42 * (one - itmp41);
  const T itmp5 = m_exp(-di);
  const T di_i = c.di_k * itmp42 *
                 (itmp41 * (T(2) * cldi * cldi_i * c.icrit_k2 - T(0.025) * tm_i) + T(0.025) * tm_i);
  const T qinew = clc * cldi * itmp5;
  const T qinew_i = clc_i * cldi * itmp5 + clc * cldi_i * itmp5 - clc * cldi * itmp5 * di_i;
  const T prs = act ? qiwc - qinew : zero;
  const T prs_i = act ? qiwc_i - qinew_i : zero;
  qiwc = qiwc - prs;
  qiwc_i = qiwc_i - prs_i;

  // new precipitation and rain fraction
  const T dr = c.cons2 * dp * (prr + prs);
  const T dr_i = c.cons2 * (dp_i * (prr + prs) + dp * (prr_i + prs_i));
  const bool coldt = tm < c.rtt;
  T rfreeze = coldt ? c.cons2 * dp * prr : zero;
  T rfreeze_i = coldt ? c.cons2 * (dp_i * prr + dp * prr_i) : zero;
  const T fwatr = coldt ? zero : one;
  rfln = rfln + fwatr * dr;
  rfln_i = rfln_i + fwatr * dr_i;
  sfln = sfln + (one - fwatr) * dr;
  sfln_i = sfln_i + (one - fwatr) * dr_i;

  // precipitation evaporation
  T evapr = zero, evapr_i = zero, evaps = zero, evaps_i = zero;
  T covptot_out = zero, covptot_out_i = zero;
  if (EVAP) {
    const T prtot = rfln + sfln;
    const T prtot_i = rfln_i + sfln_i;
    const bool eact = (prtot > c.zeps2) && (covpclr > c.zeps2);
    const T covptot_safe = eact ? covptot : one;
    const T covpclr_safe = eact ? covpclr : one;
    const T prtot_safe = eact ? prtot : one;
    T preclr = fdiv<D>(prtot * covpclr, covptot_safe);
    T preclr_i = fdiv<D>(prtot_i * covpclr + prtot * covpclr_i, covptot_safe) -
                 fdiv<D>(prtot * covpclr * covptot_i, covptot_safe * covptot_safe);
    const T clcc = eact ? one - clc : one;
    // the qlim, corqs and tmp6, dtgdp factors of tl_level_pre
    const T qe = qsat_in - fdiv<D>((qsat_in - qlim) * covpclr, clcc * clcc);
    const T qe_i =
        qsat_in_i -
        fdiv<D>(qsat_in_i * covpclr - qlim_i * covpclr + (qsat_in - qlim) * covpclr_i, clcc * clcc) -
        fdiv<D>(T(2) * (qsat_in - qlim) * covpclr * clc_i, clcc * clcc * clcc);
    const T tmp6 = m_sqrt(fdiv<D>(ap, col.aph_s));
    const T preclr_safe = (eact && preclr > zero) ? preclr : one;
    const T beta = c.rg_rpecons *
                   m_pow(fdiv<D>(tmp6 * preclr_safe, T(0.00509) * covpclr_safe), T(0.5777));
    // exact derivatives of tmp6 = sqrt(ap/aph_s) and of the b quotient,
    // where the JAX package departs from GT4Py
    const T beta_i =
        c.beta_i_k * m_pow(fdiv<D>(T(0.00509) * covpclr_safe, tmp6 * preclr_safe), T(0.4223)) *
        ((tmp6 * preclr_i + fdiv<D>(T(0.5) * preclr_safe * ap_i, tmp6 * col.aph_s) -
          fdiv<D>(T(0.5) * preclr_safe * tmp6 * col.aph_s_i, col.aph_s)) *
             rcp<D>(covpclr_safe) -
         fdiv<D>(tmp6 * preclr_safe * covpclr_i, covpclr_safe * covpclr_safe));
    const T vb = one + c.dt * beta * corqs;
    const T b = fdiv<D>(c.dt * beta * (qsat_in - qe), vb);
    const T b_i = fdiv<D>(c.dt * (beta_i * (qsat_in - qe) + beta * (qsat_in_i - qe_i)), vb) -
                  fdiv<D>(c.dt * b * (beta_i * corqs + beta * corqs_i), vb);
    const T dtgdp = fdiv<D>(c.dt_rg, dp);
    const T dtgdp_i = fdiv<D>(c.mdt_rg * dp_i, dp * dp);
    T dpr = fdiv<D>(covpclr * b, dtgdp);
    T dpr_i = fdiv<D>(covpclr_i * b + covpclr * b_i, dtgdp) - fdiv<D>(covpclr * b * dtgdp_i, dtgdp * dtgdp);
    const bool big = dpr > preclr;
    dpr = eact ? (big ? preclr : dpr) : zero;
    dpr_i = eact ? (big ? preclr_i : dpr_i) : zero;
    preclr = preclr - dpr;
    preclr_i = preclr_i - dpr_i;
    const bool drained = eact && preclr <= zero;
    covptot = drained ? clc : covptot;
    covptot_i = drained ? clc_i : covptot_i;
    covptot_out = eact ? covptot : zero;
    covptot_out_i = eact ? covptot_i : zero;
    evapr = eact ? fdiv<D>(dpr * rfln, prtot_safe) : zero;
    evapr_i = eact ? fdiv<D>(dpr_i * rfln + dpr * rfln_i, prtot_safe) -
                         fdiv<D>(dpr * rfln * prtot_i, prtot_safe * prtot_safe)
                   : zero;
    rfln = rfln - evapr;
    rfln_i = rfln_i - evapr_i;
    evaps = eact ? fdiv<D>(dpr * sfln, prtot_safe) : zero;
    evaps_i = eact ? fdiv<D>(dpr_i * sfln + dpr * sfln_i, prtot_safe) -
                         fdiv<D>(dpr * sfln * prtot_i, prtot_safe * prtot_safe)
                   : zero;
    sfln = sfln - evaps;
    sfln_i = sfln_i - evaps_i;
  }

  // T and q increments; the tendency form is used twice (before and after
  // the final clipping)
  const T mix = fwat * lvdcp + (one - fwat) * lsdcp;
  const T mix_i = fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (one - fwat) * lsdcp_i;
  const T lude_raw = x.lude, lude_raw_i = x.lude_i;
  auto tendencies = [&](T cl, T cl_i, T ci, T ci_i, T rf, T rf_i, T& dqdt, T& dqdt_i, T& dtdt,
                        T& dtdt_i) {
    dqdt = -(cl + ci) + (lude_raw + evapr + evaps) * gdp;
    dqdt_i = -(cl_i + ci_i) + (lude_raw_i + evapr_i + evaps_i) * gdp +
             (lude_raw + evapr + evaps) * gdp_i;
    const T tmp = lvdcp * evapr + lsdcp * evaps + lude_raw * mix - (lsdcp - lvdcp) * rf;
    dtdt = lvdcp * cl + lsdcp * ci - tmp * gdp;
    dtdt_i = lvdcp_i * cl + lvdcp * cl_i + lsdcp_i * ci + lsdcp * ci_i -
             (lvdcp_i * evapr + lvdcp * evapr_i + lsdcp_i * evaps + lsdcp * evaps_i +
              lude_raw_i * mix + lude_raw * mix_i - (lsdcp_i - lvdcp_i) * rf -
              (lsdcp - lvdcp) * rf_i) *
                 gdp -
             tmp * gdp_i;
  };
  T dqdt, dqdt_i, dtdt, dtdt_i;
  tendencies(condl, condl_i, condi, condi_i, rfreeze, rfreeze_i, dqdt, dqdt_i, dtdt, dtdt_i);
  T ta = tm + c.dt * dtdt, ta_i = tm_i + c.dt * dtdt_i;
  const T qold = q + c.dt * dqdt, qold_i = q_i + c.dt * dqdt_i;
  T qa = qold, qa_i = qold_i;

  // final clipping
  cuadjtqs_tl<D>(ap, ap_i, ta, ta_i, qa, qa_i, c);
  const bool clipped = qold >= qa;
  const T dq = m_max(qold - qa, zero);
  T dq_i = clipped ? qold_i - qa_i : zero;
  if (LREGCL) dq_i = dq_i * T(0.7);
  const T dr2 = c.cons2 * dp * dq;
  const T dr2_i = c.cons2 * (dp_i * dq + dp * dq_i);

  // update rain fraction and freezing
  const bool coldt2 = ta < c.rtt;
  const T rfreeze2 = coldt2 ? fwat * dr2 : zero;
  const T rfreeze2_i = coldt2 ? fwat_i * dr2 + fwat * dr2_i : zero;
  const T fwatr2 = coldt2 ? zero : one;
  condl = condl + fwatr2 * dq * c.rdt;
  condl_i = condl_i + fwatr2 * dq_i * c.rdt;
  condi = condi + (one - fwatr2) * dq * c.rdt;
  condi_i = condi_i + (one - fwatr2) * dq_i * c.rdt;
  rfln = rfln + fwatr2 * dr2;
  rfln_i = rfln_i + fwatr2 * dr2_i;
  sfln = sfln + (one - fwatr2) * dr2;
  sfln_i = sfln_i + (one - fwatr2) * dr2_i;
  rfreeze = rfreeze + rfreeze2;
  rfreeze_i = rfreeze_i + rfreeze2_i;

  // output tendencies
  tendencies(condl, condl_i, condi, condi_i, rfreeze, rfreeze_i, out.tnd_q, out.tnd_q_i,
             out.tnd_t, out.tnd_t_i);
  out.tnd_qi = (qiwc - qi) * c.rdt;
  out.tnd_qi_i = (qiwc_i - qi_i) * c.rdt;
  out.clc = clc;
  out.clc_i = clc_i;
  out.covptot = covptot_out;
  out.covptot_i = covptot_out_i;
  carry.rfl = rfln;
  carry.sfl = sfln;
  carry.covptot = covptot;
  carry.rfl_i = rfln_i;
  carry.sfl_i = sfln_i;
  carry.covptot_i = covptot_i;
  return out;
}

// ------------------------------------------------------------ column body ----
// The Body of level_scan_column: what cloudsc2_tl_pallas
// (cloudsc2_tpu/pallas/tangent_linear.py:69) and its XLA wrapper compute,
// for one column.
template <typename T, bool EVAP, bool LREGCL, bool TANGENT_ONLY, int D = DIV_EXACT>
struct TLBody {
  TLFields<T> f;
  TLConst<T> c;
  int nlev, ncols;

  struct Column {
    TLCol<T> col;
    TLCarry<T> carry;
  };

  CLOUDSC2_HD size_t at(int k, int col) const {
    return static_cast<size_t>(k) * static_cast<size_t>(ncols) + static_cast<size_t>(col);
  }

  CLOUDSC2_HD const ScalmTable<T>& level_table() const { return f.scalm; }

  // the four fluxes and their enthalpy partners at interface ib
  CLOUDSC2_HD void fluxes(size_t ib, const TLCarry<T>& s) const {
    if (!TANGENT_ONLY) {
      f.fplsl[ib] = s.rfl;
      f.fplsn[ib] = s.sfl;
      f.fhpsl[ib] = -s.rfl * c.rlvtt;
      f.fhpsn[ib] = -s.sfl * c.rlstt;
    }
    f.fplsl_i[ib] = s.rfl_i;
    f.fplsn_i[ib] = s.sfl_i;
    f.fhpsl_i[ib] = -s.rfl_i * c.rlvtt;
    f.fhpsn_i[ib] = -s.sfl_i * c.rlstt;
  }

  // Prologue: the tropopause, the critical-RH coefficients, the surface
  // pressure and its perturbation, a zero carry, and the zero top
  // interface of the fluxes.
  CLOUDSC2_HD Column begin(int col) const {
    Column s;
    s.col.trpaus = tropopause_eta(f.t, f.tnd_cml_t, f.eta, c.dt, nlev, ncols, col);
    critical_rh_coeffs(static_cast<NLCol<T>&>(s.col));
    s.col.aph_s = f.aph[at(nlev, col)];
    s.col.aph_s_i = f.aph_i[at(nlev, col)];
    s.carry = TLCarry<T>{T(0), T(0), T(0), T(0), T(0), T(0)};
    fluxes(at(0, col), s.carry);
    return s;
  }

  CLOUDSC2_HD void level(Column& s, int col, int k) const {
    const size_t i = at(k, col);
    const size_t ib = at(k + 1, col);
    const bool below = k + 1 < nlev;
    TLLevelIn<T> x;
    x.ap = f.ap[i];
    x.dp = f.aph[ib] - f.aph[i];
    x.lu_next = below ? f.lu[ib] : T(0);
    x.lude = f.lude[i];
    x.mf = f.mfu[i] + f.mfd[i];
    x.q2 = f.q[i] + c.dt * f.tnd_cml_q[i] + f.supsat[i];
    x.ql_fg = f.ql[i] + c.dt * f.tnd_cml_ql[i];
    x.qi_fg = f.qi[i] + c.dt * f.tnd_cml_qi[i];
    x.qsat = f.qsat[i];
    x.t_fg = f.t[i] + c.dt * f.tnd_cml_t[i];
    x.ap_i = f.ap_i[i];
    x.dp_i = f.aph_i[ib] - f.aph_i[i];
    x.lu_next_i = below ? f.lu_i[ib] : T(0);
    x.lude_i = f.lude_i[i];
    x.mf_i = f.mfu_i[i] + f.mfd_i[i];
    x.q2_i = f.q_i[i] + c.dt * f.tnd_cml_q_i[i] + f.supsat_i[i];
    x.ql_fg_i = f.ql_i[i] + c.dt * f.tnd_cml_ql_i[i];
    x.qi_fg_i = f.qi_i[i] + c.dt * f.tnd_cml_qi_i[i];
    x.qsat_i = f.qsat_i[i];
    x.t_fg_i = f.t_i[i] + c.dt * f.tnd_cml_t_i[i];
    x.eta = f.eta[k];
    x.scalm = f.scalm[k];
    const TLLevelOut<T> o = tl_level<T, EVAP, LREGCL, D>(s.carry, x, s.col, c);
    if (!TANGENT_ONLY) {
      f.tnd_t[i] = o.tnd_t;
      f.tnd_q[i] = o.tnd_q;
      f.tnd_ql[i] = o.tnd_ql;
      f.tnd_qi[i] = o.tnd_qi;
      f.clc[i] = o.clc;
      f.covptot[i] = o.covptot;
    }
    f.tnd_t_i[i] = o.tnd_t_i;
    f.tnd_q_i[i] = o.tnd_q_i;
    f.tnd_ql_i[i] = o.tnd_ql_i;
    f.tnd_qi_i[i] = o.tnd_qi_i;
    f.clc_i[i] = o.clc_i;
    f.covptot_i[i] = o.covptot_i;
    fluxes(ib, s.carry);
  }
};

// Fill a body from the wrapper's pointer lists (orders as in the X-lists).
template <typename T, bool EVAP, bool LREGCL, bool TANGENT_ONLY, int D = DIV_EXACT>
inline TLBody<T, EVAP, LREGCL, TANGENT_ONLY, D> make_tl_body(const void* const* in,
                                                            void* const* out,
                                                            const void* consts, int nlev,
                                                            int ncols) {
  TLBody<T, EVAP, LREGCL, TANGENT_ONLY, D> b;
  int i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<const T*>(in[i++]);
  CLOUDSC2_TL_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<T*>(out[i++]);
  CLOUDSC2_TL_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  memcpy(&b.c, consts, sizeof(TLConst<T>));
  b.f.scalm = {b.f.eta, b.c.zscal, b.c.zeps1};
  b.nlev = nlev;
  b.ncols = ncols;
  return b;
}

// Call L.template run<T, EVAP, LREGCL, TANGENT_ONLY, D>() for the runtime
// switches: the 8 switch triples for each type and divide policy the
// library holds (scalar_math.h "library forms"; check forms_valid first).
template <class L, typename T, int D, bool EVAP, bool LREGCL>
inline int tl_dispatch_only(const L& launcher, int tangent_only) {
  return tangent_only ? launcher.template run<T, EVAP, LREGCL, true, D>()
                      : launcher.template run<T, EVAP, LREGCL, false, D>();
}

template <class L, typename T, int D>
inline int tl_dispatch_t(const L& launcher, int evap, int lregcl, int tangent_only) {
  if (evap)
    return lregcl ? tl_dispatch_only<L, T, D, true, true>(launcher, tangent_only)
                  : tl_dispatch_only<L, T, D, true, false>(launcher, tangent_only);
  return lregcl ? tl_dispatch_only<L, T, D, false, true>(launcher, tangent_only)
                : tl_dispatch_only<L, T, D, false, false>(launcher, tangent_only);
}

template <class L>
inline int tl_dispatch(const L& launcher, int is_double, int evap, int lregcl, int tangent_only,
                       int div) {
  return dispatch_type_div(is_double, div, -1, [&](auto t, auto d) {
    return tl_dispatch_t<L, decltype(t), decltype(d)::value>(launcher, evap, lregcl, tangent_only);
  });
}

}  // namespace cloudsc2
