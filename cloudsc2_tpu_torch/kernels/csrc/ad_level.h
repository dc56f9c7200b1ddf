// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// One reverse level of the CLOUDSC2 adjoint for one column, and the
// per-column bodies that run it bottom-up through the level scan: ADBody
// through the direct scan (levelscan.cuh, REVERSE), ADPipeBody through the
// pipelined scan that the reverse kernel runs.  The reverse half of
// cloudsc2_ad_pallas (cloudsc2_tpu/pallas/adjoint.py:125): its reverse body
// _make_rev_body (:320, jax.vjp of tl_level, one reverse sweep per level),
// its input folds _reverse_problem (:260) and its assembly _assemble
// (:362), which cloudsc2_ad_pallas_fused (:432) shares: the fused kernel
// (ad_fused.h) runs ADBody too, from its stack.
//
// The TL level (tl_level of tl_level.h) is exactly linear in its
// perturbations: every branch depends on forward values only.  ad_level is
// its transpose written by hand, one primal pass and one adjoint pass:
//   (a) primal: the statements of tl_level without their perturbations,
//       around the forward carry the NL kernel stored entering the level
//       (its trajectory): every forward value, predicate and guarded
//       operand the transpose reads;
//   (b) adjoint: the perturbation statements of tl_level in reverse order,
//       each y_i = a*x1_i + b*x2_i becoming x1_b += a*y_b, x2_b += b*y_b.
//       A selection sends the cotangent to the branch the TL took, by the
//       TL's own predicate; a product is taken in the order an autograd
//       tape over the plain TL takes it, so f32 rounds as the plain AD does.
// The saturation adjustment transposes as physics/cuadjtqs.py cuadjtqs_ad:
// both iterations forward, then iteration 2 and iteration 1 in reverse, the
// ap cotangent gathered through qp = 1/ap.  The tendency form, used twice by
// the TL, is transposed twice, in reverse order.
//
// Its cost, counted by hand: about 700 flops per column-level with EVAP off
// (a primal pass of about 280 with 9 exp, a tanh and 2 sqrt, an adjoint
// pass of about 420), about 860 with evaporation (a sqrt and 2 pow more),
// where running tl_level once per input direction (12-14 times) cost
// 8,400-9,800.  The primal values the adjoint reads stay in registers.  On
// the card the reverse kernel runs ADPipeBody (below), its level's inputs
// copied ahead into a ring in shared memory: in f32 under launch bounds of
// 4 blocks of 128, 124 registers without evaporation and 128 with, where
// ptxas spills 108 bytes; in f64 without bounds, 250 registers without
// evaporation and 255 with, and 160 bytes of local memory (ptxas and
// cudaFuncGetAttributes, sm_90a, on an NVIDIA H100 80GB HBM3, 700.00 W;
// adjoint.cu).
//
// Static switches are template parameters: EVAP = LEVAPLS2 || LDRAIN1D,
// LREGCL, and D, the divide policy (scalar_math.h): the primal pass divides
// as tl_level does, and the adjoint pass divides each cotangent by the same
// forward value under the same policy.  The library's form picks the
// saturation adjustment (kCompact), whose two forms transpose apart
// (adj_iter_ad).  The TL, and so the AD, does not read LPHYLIN: the
// trajectory is the NL step's under linearized physics (THERMO), which is
// the TL's own forward, whatever LPHYLIN the caller's constants hold.
#pragma once

#include <string.h>

#include "tl_level.h"

namespace cloudsc2 {

// ------------------------------------------------------------ argument lists
// Mirrored in Python (kernels/adjoint.py AD_INPUTS / AD_OUTPUTS; the
// constants are TLConst's); ad_signature() reports them for the wrapper.
// (nlev, ncols) fields, except aph and the four flux seeds (nlev+1, ncols)
// and eta (nlev,); c_cov and covptot_i are read only with EVAP and may be
// null otherwise.
#define CLOUDSC2_AD_INPUTS(X)                                                  \
  X(ap) X(aph) X(lu) X(lude) X(mfd) X(mfu) X(q) X(qi) X(ql) X(qsat) X(supsat)  \
  X(t) X(tnd_cml_q) X(tnd_cml_qi) X(tnd_cml_ql) X(tnd_cml_t)                   \
  X(tnd_t_i) X(tnd_q_i) X(tnd_ql_i) X(tnd_qi_i) X(clc_i) X(covptot_i)          \
  X(fplsl_i) X(fplsn_i) X(fhpsl_i) X(fhpsn_i) X(c_rfl) X(c_sfl) X(c_cov)       \
  X(eta)

// (nlev, ncols) fields, except aph_i (nlev+1, ncols)
#define CLOUDSC2_AD_OUTPUTS(X)                                                 \
  X(cml_t_i) X(cml_q_i) X(cml_ql_i) X(cml_qi_i) X(ap_i) X(aph_i) X(t_i) X(q_i) \
  X(qsat_i) X(ql_i) X(qi_i) X(lu_i) X(lude_i) X(mfd_i) X(mfu_i) X(supsat_i)

// The input directions of one TL level: the carry perturbations, the folded
// inputs, the surface pressure.
#define CLOUDSC2_AD_DIRS(X)                                                    \
  X(rfl) X(sfl) X(cov) X(ap) X(dp) X(lu_next) X(lude) X(mf) X(q2) X(ql_fg)     \
  X(qi_fg) X(qsat) X(t_fg) X(aph_s)

// The outputs of one TL level: the carry leaving it, its six perturbation
// outputs.
#define CLOUDSC2_AD_WEIGHTS(X)                                                 \
  X(rfl) X(sfl) X(cov) X(tnd_t) X(tnd_q) X(tnd_ql) X(tnd_qi) X(clc) X(covptot)

// The two-way choices of tl_level, as bits of the mask ad_level_traced
// reports (for the tests): fwat's branch, esdp's clip, qlim, the ice
// supersaturation, cloud cover low / mid / high, detrainment, subsidence,
// the melt temperature, autoconversion, covptot's growth, melting and its
// limit, rain freezing, evaporation, its cap and the drained cover, the
// adjustment's phase and its two clips, the final clip, refreezing.
// covpclr's clip is not among them: covptot = max(carry, clc) >= clc.
#define CLOUDSC2_AD_BRANCHES(X)                                                \
  X(cold) X(noclip) X(qlim_sat) X(cold_ice) X(low) X(mid) X(high) X(lo1) X(lo3) \
  X(warm) X(act) X(grow) X(melt) X(snow_all) X(coldt) X(eact) X(big)            \
  X(drained) X(adj_warm) X(adj_noclip1) X(adj_noclip2) X(clipped) X(coldt2)

#define CLOUDSC2_STR(n) #n ","
inline const char* ad_signature() {
  return "consts:" CLOUDSC2_TL_CONSTS(CLOUDSC2_STR)
         ";inputs:" CLOUDSC2_AD_INPUTS(CLOUDSC2_STR)
         ";outputs:" CLOUDSC2_AD_OUTPUTS(CLOUDSC2_STR);
}
#undef CLOUDSC2_STR

// The bit of each branch in the mask.
enum ADBranch {
#define CLOUDSC2_ENUM(n) AD_BR_##n,
  CLOUDSC2_AD_BRANCHES(CLOUDSC2_ENUM)
#undef CLOUDSC2_ENUM
};

template <typename T>
struct ADFields {
#define CLOUDSC2_FIELD(n) const T* n;
  CLOUDSC2_AD_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
#define CLOUDSC2_FIELD(n) T* n;
  CLOUDSC2_AD_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  ScalmTable<T> scalm;  // from eta and the constants, not an input
};

// One cotangent per input direction.
template <typename T>
struct ADCot {
#define CLOUDSC2_FIELD(n) T n;
  CLOUDSC2_AD_DIRS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
};

// The cotangents of one TL level's outputs: the carry leaving the level
// (the carry cotangent from below plus, for the fluxes, the folded flux
// seeds) and the level's six perturbation outputs.
template <typename T>
struct ADWeights {
#define CLOUDSC2_FIELD(n) T n;
  CLOUDSC2_AD_WEIGHTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
};

// ---------------------------------------------------- saturation adjustment ----
// One iteration of cuadjtqs_tl (tl_level.h) without its perturbations: the
// forward values its transpose reads (u, w in the compact form; cor and
// qs = s * cor in the reference-shaped one).  The caller advances t +=
// zaldcp * cond, q -= cond, as the TL does.
template <typename T>
struct AdjIter {
  T q, rt4, foeew, s, z2s, u, w, cor, qs, rden, cond;
  bool noclip;
};

template <int D, typename T>
CLOUDSC2_HD AdjIter<T> adj_iter(T qp, T t, T q, T z3es, T z4es, T z5alcp, const TLConst<T>& c) {
  const T one = T(1);
  AdjIter<T> r;
  r.q = q;
  r.rt4 = rcp<D>(t - z4es);
  r.foeew = c.r2es * m_exp(z3es * (t - c.rtt) * r.rt4);
  const T qsat = qp * r.foeew;
  r.noclip = qsat <= c.zqmax;
  r.s = m_min(qsat, c.zqmax);
  r.z2s = z5alcp * r.rt4 * r.rt4;
  if constexpr (kCompact) {
    r.u = one - c.retv * r.s;
    r.w = q * r.u - r.s;
    const T num = r.w * r.u;
    const T den = r.u * r.u + r.s * r.z2s;
    r.rden = rcp<D>(den);
    r.cond = num * r.rden;
  } else {
    r.cor = rcp<D>(one - c.retv * r.s);
    r.qs = r.s * r.cor;
    r.rden = rcp<D>(one + r.qs * r.cor * r.z2s);
    r.cond = (q - r.qs) * r.rden;
  }
  return r;
}

// The transpose of one iteration of cuadjtqs_tl around its forward values
// r: t_b, q_b hold the cotangents of the iteration's outputs on entry and of
// its inputs on return; qp_b gathers the cotangent of qp_i.
template <typename T>
CLOUDSC2_HD void adj_iter_ad(const AdjIter<T>& r, T qp, T z3es, T z4es, T zaldcp, T& t_b, T& q_b,
                             T& qp_b, const TLConst<T>& c) {
  T s_b, z2s_b;
  if constexpr (kCompact) {
    // t_i += zaldcp * cond_i; q_i -= cond_i; cond_i = (num_i - cond * den_i) * rden
    const T num_b = (zaldcp * t_b - q_b) * r.rden;
    const T den_b = -(num_b * r.cond);
    // num_i = (q_i * u + q * u_i - s_i) * u + w * u_i
    const T in_b = num_b * r.u;
    q_b = q_b + in_b * r.u;
    T u_b = in_b * r.q + num_b * r.w;
    s_b = -in_b;
    // den_i = 2 * u * u_i + s_i * z2s + s * z2s_i
    u_b = u_b + den_b * (T(2) * r.u);
    s_b = s_b + den_b * r.z2s;
    z2s_b = den_b * r.s;
    // u_i = -retv * s_i
    s_b = s_b - u_b * c.retv;
  } else {
    // t_i += zaldcp * cond_i; q_i -= cond_i;
    // cond_i = (q_i - qs_i) * rden - (q - qs) * X * rden * rden,
    // X = qs_i * cor * z2s + qs * cor_i * z2s + qs * cor * z2s_i
    const T cond_b = zaldcp * t_b - q_b;
    const T a_b = cond_b * r.rden;
    const T x_b = (-cond_b * r.rden * r.rden) * (r.q - r.qs);
    q_b = q_b + a_b;
    const T xz = x_b * r.z2s;
    const T qs_b = xz * r.cor - a_b;
    T cor_b = xz * r.qs;
    z2s_b = x_b * (r.qs * r.cor);
    // qs_i = s_i * cor + s * cor_i; cor_i = retv * s_i * cor * cor
    s_b = qs_b * r.cor;
    cor_b = cor_b + qs_b * r.s;
    s_b = s_b + ((cor_b * r.cor) * r.cor) * c.retv;
  }
  // z2s_i = -2 * z2s * t_i * rt4
  t_b = t_b + z2s_b * r.rt4 * (T(-2) * r.z2s);
  // s_i = noclip ? qsat_i : 0;  qsat_i = qp_i * foeew + qp * foeew_i
  const T qsat_b = r.noclip ? s_b : T(0);
  qp_b = qp_b + qsat_b * r.foeew;
  // foeew_i = foeew * z3es * t_i * (rtt - z4es) * rt4 * rt4
  t_b = t_b + qsat_b * qp * r.rt4 * r.rt4 * (c.rtt - z4es) * (r.foeew * z3es);
}

// ---------------------------------------------------------------- ad_level ----
// The transpose of tl_level at one point: x holds the level's forward
// values (its perturbations are ignored), traj the forward carry entering
// the level, w the cotangents of the level's outputs.  Returns the
// cotangent of every input direction.  With EVAP off the covptot carry
// feeds nothing but itself and aph_s is not read: g.cov and g.aph_s are 0.
// `branches`, where not null, receives the mask of CLOUDSC2_AD_BRANCHES.
template <typename T, bool EVAP, bool LREGCL, int D = DIV_EXACT>
CLOUDSC2_HD ADCot<T> ad_level_traced(const TLLevelIn<T>& x, const TLCol<T>& col,
                                     const NLCarry<T>& traj, const ADWeights<T>& w,
                                     const TLConst<T>& c, unsigned* branches) {
  const T one = T(1), zero = T(0);

  // ================================================= (a) primal ==========
  // ---- phase A (tl_level.h:154-326)
  const T ap = x.ap, qsat_in = x.qsat, t = x.t_fg, q = x.q2, ql = x.ql_fg, qi = x.qi_fg;
  const T dp = x.dp, scalm = x.scalm;
  const T zd = c.rcpd + c.rcpd_rvtmp2 * q;
  const T zz = rcp<D>(zd);
  const T lfdcp = c.rlmlt * zz, lsdcp = c.rlstt * zz, lvdcp = c.rlvtt * zz;
  const bool cold = t < c.rtt;
  const T th = m_tanh(T(0.17) * (t - c.rlptrc));
  const T fwat = cold ? T(0.545) * (th + one) : one;
  const T z3es = cold ? c.r3ies : c.r3les;
  const T z4es = cold ? c.r4ies : c.r4les;
  const T rl = rcp<D>(t - c.r4les);
  const T ri = rcp<D>(t - c.r4ies);
  const T rz4es = cold ? ri : rl;
  const T rap = rcp<D>(ap);
  const T foeew = c.r2es * m_exp(z3es * (t - c.rtt) * rz4es);
  const T esdp0 = foeew * rap;
  const bool noclip = esdp0 <= c.zqmax;
  const T esdp = m_min(esdp0, c.zqmax);
  const T facw = c.r5les * (rl * rl);
  const T faci = c.r5ies * (ri * ri);
  const T fac = fwat * facw + (one - fwat) * faci;
  const T cor = rcp<D>(one - c.retv * esdp);
  const T dqsdtemp = fac * cor * qsat_in;
  const T corqs = one + c.cons3 * dqsdtemp;
  const T qlim = m_min(q, qsat_in);
  const bool qlim_sat = q > qsat_in;
  const T crh2 = critical_rh(x.eta, static_cast<const NLCol<T>&>(col));
  const bool cold_ice = t < c.rtice;
  const T supsat_fac = cold_ice ? T(1.8) - T(0.003) * t : one;
  const T qsat = qsat_in * supsat_fac;
  const T qcrit = crh2 * qsat;
  const T qt = q + ql + qi;
  const bool low = qt < qcrit;
  const bool high = qt >= qsat;
  const bool mid = !(low || high);
  const T qpd = qsat - qt;
  const T qcd = qsat - qcrit;
  const T denom = qcd - scalm * (qt - qcrit);
  const T rdenom = rcp<D>(mid ? denom : one);
  const T ratio = mid ? qpd * rdenom : zero;
  const T clc_mid = one - m_sqrt(ratio);
  const T rtmp1 = one / m_sqrt(mid ? ratio : one);
  T yyy = one;
  if (LREGCL) {
    const T rat = fdiv<D>(qpd, mid ? qcd : one);
    const T u = one - scalm * (one - rat);
    yyy = m_min(fdiv_scalar<D>(T(3.5) * m_sqrt(m_max(rat * (u * u * u), zero)), one - scalm), T(0.3));
  }
  const T qc_mid = (scalm * qpd + (one - scalm) * qcd) * (clc_mid * clc_mid);
  const T qc_high = (one - scalm) * (qsat - qcrit);
  const T clc0 = low ? zero : (high ? one : clc_mid);
  const T qc0 = low ? zero : (high ? qc_high : qc_mid);
  const T rdp = rcp<D>(dp);
  const T gdp = c.rg * rdp;
  const T lude = c.dt * x.lude * gdp;
  const bool lo1 = (lude >= c.rlmin) && (x.lu_next >= c.zeps2);
  const T rlu1 = rcp<D>(lo1 ? x.lu_next : one);
  const T tmp2 = m_exp(-lude * rlu1);
  const T clc = clc0 + (lo1 ? (one - clc0) * (one - tmp2) : zero);
  const T qc1 = qc0 + (lo1 ? lude : zero);
  const T fac1 = rcp<D>(c.rd * t);
  const T rho = ap * fac1;
  const T fac2 = rcp<D>(ap - c.retv * foeew);
  const T rodqsdp = -rho * qsat_in * fac2;
  const T ldcp = fwat * lvdcp + (one - fwat) * lsdcp;
  const T fac3 = rcp<D>(one + ldcp * dqsdtemp);
  const T dtdzmo = c.rg * (c.rcpd_inv - ldcp * rodqsdp) * fac3;
  const T dqsdz = dqsdtemp * dtdzmo - c.rg * rodqsdp;
  const T fac4 = c.rd * t * rap;
  const T sub = c.dt * dqsdz * x.mf * fac4;
  const bool lo3 = sub < qc1;
  const T dqc = lo3 ? sub : qc1;
  const T qc = lo3 ? qc1 - sub : zero;
  const T qlwc = qc * fwat;
  const T qiwc = qc * (one - fwat);
  const T condl = (qlwc - ql) * c.rdt;
  const T condi = (qiwc - qi) * c.rdt;
  const T cons = c.cons2_rlmlt * dp * zd;
  const T rcons = c.dt * gdp * lfdcp;
  const bool warm = t > c.meltp2;
  const T z2s = cons * m_max(t - c.meltp2, zero);
  const bool act = clc > c.zeps2;
  const T rclc = rcp<D>(act ? clc : one);
  const T cldl = qlwc * rclc;
  const T ltmp4 = m_exp(-(cldl * cldl * c.lcrit_k));
  const T dl = c.ckcodtl * (one - ltmp4);
  const T ltmp5 = m_exp(-dl);
  const T qlnew = clc * cldl * ltmp5;
  const T prr = act ? qlwc - qlnew : zero;
  const T cldi = qiwc * rclc;
  const T itmp41 = m_exp(-(cldi * cldi * c.icrit_k));

  // ---- melt, ice autoconversion, new precipitation (:328-373)
  const bool grow = clc > traj.covptot;
  const T covptot = m_max(traj.covptot, clc);
  const T covpclr1 = covptot - clc;
  const bool pos = covpclr1 >= zero;
  const T covpclr = m_max(covpclr1, zero);
  const T sfl = traj.sfl;
  const bool melt = sfl != zero;
  const bool snow_all = sfl <= z2s;
  const T sm = melt ? m_min(sfl, z2s) : zero;
  T rfln = traj.rfl + sm;
  T sfln = sfl - sm;
  const T tm = t - sm * rcons;
  const T itmp42 = m_exp(T(0.025) * (tm - c.rtt));
  const T di = c.ckcodti * itmp42 * (one - itmp41);
  const T itmp5 = m_exp(-di);
  const T qinew = clc * cldi * itmp5;
  const T prs = act ? qiwc - qinew : zero;
  const T dr = c.cons2 * dp * (prr + prs);
  const bool coldt = tm < c.rtt;
  const T rfreeze1 = coldt ? c.cons2 * dp * prr : zero;
  const T fwatr = coldt ? zero : one;
  rfln = rfln + fwatr * dr;
  sfln = sfln + (one - fwatr) * dr;

  // ---- precipitation evaporation (:375-437)
  bool eact = false, big = false, drained = false;
  T evapr = zero, evaps = zero;
  T prtot = zero, covptot_safe = one, covpclr_safe = one, prtot_safe = one, clcc = one;
  T qe = zero, tmp6 = one, preclr_safe = one, beta = zero, pw = zero, vb = one, bq = zero;
  T dtgdp = one, dpr = zero;
  if (EVAP) {
    prtot = rfln + sfln;
    eact = (prtot > c.zeps2) && (covpclr > c.zeps2);
    covptot_safe = eact ? covptot : one;
    covpclr_safe = eact ? covpclr : one;
    prtot_safe = eact ? prtot : one;
    const T preclr = fdiv<D>(prtot * covpclr, covptot_safe);
    clcc = eact ? one - clc : one;
    qe = qsat_in - fdiv<D>((qsat_in - qlim) * covpclr, clcc * clcc);
    tmp6 = m_sqrt(fdiv<D>(ap, col.aph_s));
    preclr_safe = (eact && preclr > zero) ? preclr : one;
    beta = c.rg_rpecons * m_pow(fdiv<D>(tmp6 * preclr_safe, T(0.00509) * covpclr_safe), T(0.5777));
    pw = m_pow(fdiv<D>(T(0.00509) * covpclr_safe, tmp6 * preclr_safe), T(0.4223));
    vb = one + c.dt * beta * corqs;
    bq = fdiv<D>(c.dt * beta * (qsat_in - qe), vb);
    dtgdp = fdiv<D>(c.dt_rg, dp);
    const T dpr0 = fdiv<D>(covpclr * bq, dtgdp);
    big = dpr0 > preclr;
    dpr = eact ? (big ? preclr : dpr0) : zero;
    drained = eact && preclr - dpr <= zero;
    evapr = eact ? fdiv<D>(dpr * rfln, prtot_safe) : zero;
    evaps = eact ? fdiv<D>(dpr * sfln, prtot_safe) : zero;
  }

  // ---- tendencies and final clipping (:439-503)
  const T mix = fwat * lvdcp + (one - fwat) * lsdcp;
  const T lude_raw = x.lude;
  // the forward half of tendencies (:444-457) and its tmp
  const T ttmp1 = lvdcp * evapr + lsdcp * evaps + lude_raw * mix - (lsdcp - lvdcp) * rfreeze1;
  const T dqdt = -(condl + condi) + (lude_raw + evapr + evaps) * gdp;
  const T dtdt = lvdcp * condl + lsdcp * condi - ttmp1 * gdp;
  const T ta = tm + c.dt * dtdt;
  const T qold = q + c.dt * dqdt;
  // cuadjtqs_tl's forward: the phase from the input temperature, qp = 1/ap
  const bool adj_warm = ta > c.rtt;
  const T az3es = adj_warm ? c.r3les : c.r3ies;
  const T az4es = adj_warm ? c.r4les : c.r4ies;
  const T az5alcp = adj_warm ? c.r5alvcp : c.r5alscp;
  const T azaldcp = adj_warm ? c.ralvdcp : c.ralsdcp;
  const T qp = rcp<D>(ap);
  const AdjIter<T> it1 = adj_iter<D>(qp, ta, qold, az3es, az4es, az5alcp, c);
  const T ta1 = ta + azaldcp * it1.cond;
  const T qa1 = qold - it1.cond;
  const AdjIter<T> it2 = adj_iter<D>(qp, ta1, qa1, az3es, az4es, az5alcp, c);
  const T ta2 = ta1 + azaldcp * it2.cond;
  const T qa = qa1 - it2.cond;
  const bool adj_noclip1 = it1.noclip, adj_noclip2 = it2.noclip;
  const bool clipped = qold >= qa;
  const T dq = m_max(qold - qa, zero);
  const T dr2 = c.cons2 * dp * dq;
  const bool coldt2 = ta2 < c.rtt;
  const T fwatr2 = coldt2 ? zero : one;
  const T condl2 = condl + fwatr2 * dq * c.rdt;
  const T condi2 = condi + (one - fwatr2) * dq * c.rdt;
  const T rfreeze = rfreeze1 + (coldt2 ? fwat * dr2 : zero);
  const T ttmp2 = lvdcp * evapr + lsdcp * evaps + lude_raw * mix - (lsdcp - lvdcp) * rfreeze;

  if (branches) {
    unsigned m = 0;
#define CLOUDSC2_BIT(n) m |= static_cast<unsigned>(n) << AD_BR_##n;
    CLOUDSC2_AD_BRANCHES(CLOUDSC2_BIT)
#undef CLOUDSC2_BIT
    *branches = m;
  }

  // ================================================ (b) adjoint ==========
  // cotangents of the input directions, and of the intermediates read in
  // more than one place
  T g_ap = zero, g_dp = zero, g_mf = zero, g_q = zero, g_ql = zero, g_qi = zero, g_qs = zero;
  T g_t = zero, g_aphs = zero, g_lu = zero, g_rfl = zero, g_sfl = zero, g_cov = zero;
  T b_lude = zero, b_gdp = zero, b_fwat = zero, b_lvdcp = zero, b_lsdcp = zero, b_mix = zero;
  T b_evapr = zero, b_evaps = zero, b_clc = w.clc, b_rfln = w.rfl, b_sfln = w.sfl;
  T b_cl = zero, b_ci = zero, b_rf = zero, b_qlim = zero, b_corqs = zero, b_covpclr = zero;

  // the transpose of tendencies(cl, ci, rf) (:444-457), whose tmp is ttmp,
  // at the cotangents dqdt_b, dtdt_b of its outputs
  auto tendencies_ad = [&](T cl, T ci, T rf, T ttmp, T dqdt_b, T dtdt_b) {
    // dqdt_i = -(cl_i + ci_i) + (lude_i + evapr_i + evaps_i) * gdp + (lude + evapr + evaps) * gdp_i
    b_cl = b_cl - dqdt_b;
    b_ci = b_ci - dqdt_b;
    const T s = dqdt_b * gdp;
    b_lude = b_lude + s;
    if (EVAP) {
      b_evapr = b_evapr + s;
      b_evaps = b_evaps + s;
    }
    b_gdp = b_gdp + dqdt_b * (lude_raw + evapr + evaps);
    // dtdt_i = lvdcp_i * cl + lvdcp * cl_i + lsdcp_i * ci + lsdcp * ci_i - P * gdp - tmp * gdp_i
    b_lvdcp = b_lvdcp + dtdt_b * cl;
    b_cl = b_cl + dtdt_b * lvdcp;
    b_lsdcp = b_lsdcp + dtdt_b * ci;
    b_ci = b_ci + dtdt_b * lsdcp;
    const T p = -(dtdt_b * gdp);
    b_gdp = b_gdp - dtdt_b * ttmp;
    // P = lvdcp_i * evapr + lvdcp * evapr_i + lsdcp_i * evaps + lsdcp * evaps_i
    //     + lude_i * mix + lude * mix_i - (lsdcp_i - lvdcp_i) * rf - (lsdcp - lvdcp) * rf_i
    if (EVAP) {
      b_lvdcp = b_lvdcp + p * evapr;
      b_evapr = b_evapr + p * lvdcp;
      b_lsdcp = b_lsdcp + p * evaps;
      b_evaps = b_evaps + p * lsdcp;
    }
    b_lude = b_lude + p * mix;
    b_mix = b_mix + p * lude_raw;
    const T d = p * rf;
    b_lsdcp = b_lsdcp - d;
    b_lvdcp = b_lvdcp + d;
    b_rf = b_rf - p * (lsdcp - lvdcp);
  };

  // ---- tendencies and final clipping, in reverse
  // tnd_qi_i = (qiwc_i - qi_i) * rdt, qiwc after the ice autoconversion
  const T a_qi = w.tnd_qi * c.rdt;
  T b_qiwc = a_qi;
  g_qi = g_qi - a_qi;
  // the output tendencies: the second tendency form
  tendencies_ad(condl2, condi2, rfreeze, ttmp2, w.tnd_q, w.tnd_t);
  // rfreeze_i += rfreeze2_i: b_rf is the cotangent of both
  // rfln_i += fwatr2 * dr2_i; sfln_i += (1 - fwatr2) * dr2_i
  T b_dr2 = coldt2 ? b_sfln : b_rfln;
  // condl_i += fwatr2 * dq_i * rdt; condi_i += (1 - fwatr2) * dq_i * rdt
  T b_dq = (coldt2 ? b_ci : b_cl) * c.rdt;
  // rfreeze2_i = coldt2 ? fwat_i * dr2 + fwat * dr2_i : 0
  if (coldt2) {
    b_fwat = b_fwat + b_rf * dr2;
    b_dr2 = b_dr2 + b_rf * fwat;
  }
  // dr2_i = cons2 * (dp_i * dq + dp * dq_i)
  {
    const T a = b_dr2 * c.cons2;
    g_dp = g_dp + a * dq;
    b_dq = b_dq + a * dp;
  }
  // dq_i = clipped ? qold_i - qa_i : 0 (times 0.7 with LREGCL), qa_i the
  // adjusted qold_i
  if (LREGCL) b_dq = b_dq * T(0.7);
  T b_qold = zero, b_ta = zero;
  if (clipped) {
    T b_qa = -b_dq;
    T b_qp = zero;
    adj_iter_ad(it2, qp, az3es, az4es, azaldcp, b_ta, b_qa, b_qp, c);
    adj_iter_ad(it1, qp, az3es, az4es, azaldcp, b_ta, b_qa, b_qp, c);
    // qp_i = -ap_i * qp * qp
    g_ap = g_ap - b_qp * qp * qp;
    b_qold = b_dq + b_qa;
  }
  // qold_i = q_i + dt * dqdt_i; ta_i = tm_i + dt * dtdt_i: the first tendency form
  g_q = g_q + b_qold;
  T b_tm = b_ta;
  tendencies_ad(condl, condi, rfreeze1, ttmp1, b_qold * c.dt, b_ta * c.dt);
  // mix_i = fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (1 - fwat) * lsdcp_i
  b_fwat = b_fwat + b_mix * (lvdcp - lsdcp);
  b_lvdcp = b_lvdcp + b_mix * fwat;
  b_lsdcp = b_lsdcp + b_mix * (one - fwat);

  // ---- precipitation evaporation, in reverse; b_cov is the cotangent of
  // covptot_i (the carry leaving the level, then the one entering the drain)
  T b_cov = zero;
  if (EVAP) {
    b_cov = w.cov;
    if (eact) {
      // rfln_i -= evapr_i; sfln_i -= evaps_i; the pre-evaporation fluxes
      const T rfle = rfln, sfle = sfln;
      b_evapr = b_evapr - b_rfln;
      b_evaps = b_evaps - b_sfln;
      // evaps_i = (dpr_i * sfln + dpr * sfln_i) / prtot_safe - dpr * sfln * prtot_i / prtot_safe^2
      T a = fdiv<D>(b_evaps, prtot_safe);
      T b_dpr = a * sfle;
      b_sfln = b_sfln + a * dpr;
      T b_prtot = -fdiv<D>(b_evaps, prtot_safe * prtot_safe) * (dpr * sfle);
      // evapr_i likewise with rfln
      a = fdiv<D>(b_evapr, prtot_safe);
      b_dpr = b_dpr + a * rfle;
      b_rfln = b_rfln + a * dpr;
      b_prtot = b_prtot - fdiv<D>(b_evapr, prtot_safe * prtot_safe) * (dpr * rfle);
      // covptot_out_i = covptot_i; covptot_i = drained ? clc_i : covptot_i
      b_cov = b_cov + w.covptot;
      if (drained) {
        b_clc = b_clc + b_cov;
        b_cov = zero;
      }
      // dpr_i = big ? preclr_i : dpr_i
      T b_preclr = big ? b_dpr : zero;
      const T b_dpr0 = big ? zero : b_dpr;
      // dpr_i = (covpclr_i * b + covpclr * b_i) / dtgdp - covpclr * b * dtgdp_i / dtgdp^2
      a = fdiv<D>(b_dpr0, dtgdp);
      b_covpclr = b_covpclr + a * bq;
      const T b_b = a * covpclr;
      // dtgdp_i = mdt_rg * dp_i / (dp * dp)
      g_dp = g_dp + fdiv<D>(-fdiv<D>(b_dpr0, dtgdp * dtgdp) * (covpclr * bq), dp * dp) * c.mdt_rg;
      // b_i = dt * (beta_i * (qsat_in - qe) + beta * (qsat_in_i - qe_i)) / vb
      //       - dt * b * (beta_i * corqs + beta * corqs_i) / vb
      a = fdiv<D>(b_b, vb) * c.dt;
      T b_beta = a * (qsat_in - qe);
      const T e = a * beta;
      g_qs = g_qs + e;
      T b_qe = -e;
      a = -fdiv<D>(b_b, vb) * (c.dt * bq);
      b_beta = b_beta + a * corqs;
      b_corqs = b_corqs + a * beta;
      // beta_i = beta_i_k * pw * (W / covpclr_safe - tmp6 * preclr_safe * covpclr_i / covpclr_safe^2),
      // W = tmp6 * preclr_i + 0.5 * preclr_safe * ap_i / (tmp6 * aph_s)
      //     - 0.5 * preclr_safe * tmp6 * aph_s_i / aph_s
      const T z = b_beta * (c.beta_i_k * pw);
      a = z * rcp<D>(covpclr_safe);
      b_preclr = b_preclr + a * tmp6;
      g_ap = g_ap + fdiv<D>(a, tmp6 * col.aph_s) * (T(0.5) * preclr_safe);
      g_aphs = g_aphs - fdiv<D>(a, col.aph_s) * (T(0.5) * preclr_safe * tmp6);
      b_covpclr = b_covpclr - fdiv<D>(z, covpclr_safe * covpclr_safe) * (tmp6 * preclr_safe);
      // qe_i = qsat_in_i - (qsat_in_i * covpclr - qlim_i * covpclr + (qsat_in - qlim) * covpclr_i)
      //        / clcc^2 - 2 * (qsat_in - qlim) * covpclr * clc_i / clcc^3
      g_qs = g_qs + b_qe;
      a = -fdiv<D>(b_qe, clcc * clcc);
      g_qs = g_qs + a * covpclr;
      b_qlim = b_qlim - a * covpclr;
      b_covpclr = b_covpclr + a * (qsat_in - qlim);
      b_clc = b_clc - fdiv<D>(b_qe, clcc * clcc * clcc) * (T(2) * (qsat_in - qlim) * covpclr);
      // preclr_i = (prtot_i * covpclr + prtot * covpclr_i) / covptot_safe
      //            - prtot * covpclr * covptot_i / covptot_safe^2
      a = fdiv<D>(b_preclr, covptot_safe);
      b_prtot = b_prtot + a * covpclr;
      b_covpclr = b_covpclr + a * prtot;
      b_cov = b_cov - fdiv<D>(b_preclr, covptot_safe * covptot_safe) * (prtot * covpclr);
      // prtot_i = rfln_i + sfln_i
      b_rfln = b_rfln + b_prtot;
      b_sfln = b_sfln + b_prtot;
    }
  }

  // ---- melt, ice autoconversion, new precipitation, in reverse
  // rfln_i += fwatr * dr_i; sfln_i += (1 - fwatr) * dr_i
  const T b_dr = coldt ? b_sfln : b_rfln;
  // rfreeze_i = coldt ? cons2 * (dp_i * prr + dp * prr_i) : 0
  T b_prr = zero;
  if (coldt) {
    const T a = b_rf * c.cons2;
    g_dp = g_dp + a * prr;
    b_prr = a * dp;
  }
  // dr_i = cons2 * (dp_i * (prr + prs) + dp * (prr_i + prs_i))
  T b_prs;
  {
    const T a = b_dr * c.cons2;
    g_dp = g_dp + a * (prr + prs);
    const T e = a * dp;
    b_prr = b_prr + e;
    b_prs = e;
  }
  // qiwc_i -= prs_i
  b_prs = b_prs - b_qiwc;
  T b_cldi = zero;
  if (act) {
    // prs_i = qiwc_i - qinew_i
    b_qiwc = b_qiwc + b_prs;
    // qinew_i = clc_i * cldi * itmp5 + clc * cldi_i * itmp5 - clc * cldi * itmp5 * di_i
    const T a = -b_prs * itmp5;
    b_clc = b_clc + a * cldi;
    b_cldi = a * clc;
    const T b_di = b_prs * (clc * cldi * itmp5);
    // di_i = di_k * itmp42 * (itmp41 * (2 * cldi * cldi_i * icrit_k2 - 0.025 * tm_i) + 0.025 * tm_i)
    const T e = b_di * (c.di_k * itmp42);
    const T f = e * itmp41;
    b_cldi = b_cldi + (f * c.icrit_k2) * (T(2) * cldi);
    b_tm = b_tm - f * T(0.025) + e * T(0.025);
  }
  // tm_i = t_i - (smi * rcons + sm * rcons_i)
  g_t = g_t + b_tm;
  T b_smi = -(b_tm * rcons);
  const T b_rcons = -(b_tm * sm);
  // rfln_i = rfl_i + smi; sfln_i = sfl_i - smi
  g_rfl = b_rfln;
  g_sfl = b_sfln;
  b_smi = b_smi + b_rfln - b_sfln;
  // smi = melt ? (sfl <= z2s ? sfl_i : z2s_i) : 0
  T b_z2s = zero;
  if (melt) {
    if (snow_all) {
      g_sfl = g_sfl + b_smi;
    } else {
      b_z2s = b_smi;
    }
  }
  if (EVAP) {
    // covpclr_i = pos ? covptot_i - clc_i : 0
    if (pos) {
      b_cov = b_cov + b_covpclr;
      b_clc = b_clc - b_covpclr;
    }
    // covptot_i = grow ? clc_i : carry covptot_i
    if (grow) {
      b_clc = b_clc + b_cov;
    } else {
      g_cov = b_cov;
    }
  }

  // ---- phase A, in reverse
  // tnd_ql_i = (qlwc_i - ql_i) * rdt, qlwc after the autoconversion
  const T a_ql = w.tnd_ql * c.rdt;
  T b_qlwc = a_ql;
  g_ql = g_ql - a_ql;
  if (act) {
    // cldi_i = (qiwc_i - cldi * clc_i) * rclc
    T a = b_cldi * rclc;
    b_qiwc = b_qiwc + a;
    b_clc = b_clc - a * cldi;
    // qlwc_i -= prr_i; prr_i = qlwc_i - qlnew_i
    b_prr = b_prr - a_ql;
    b_qlwc = b_qlwc + b_prr;
    // qlnew_i = clc_i * cldl * ltmp5 + clc * cldl_i * ltmp5 - clc * cldl * ltmp5 * dl_i
    a = -b_prr * ltmp5;
    b_clc = b_clc + a * cldl;
    T b_cldl = a * clc;
    // dl_i = dl_k * ltmp4 * cldl * cldl_i
    b_cldl = b_cldl + (b_prr * (clc * cldl * ltmp5)) * (c.dl_k * ltmp4 * cldl);
    // cldl_i = (qlwc_i - cldl * clc_i) * rclc
    a = b_cldl * rclc;
    b_qlwc = b_qlwc + a;
    b_clc = b_clc - a * cldl;
  }
  // z2s_i = warm ? cons_i * (t - meltp2) + cons * t_i : 0
  T b_cons = zero;
  if (warm) {
    b_cons = b_z2s * (t - c.meltp2);
    g_t = g_t + b_z2s * cons;
  }
  // rcons_i = dt * (gdp_i * lfdcp + gdp * lfdcp_i)
  T a = b_rcons * c.dt;
  b_gdp = b_gdp + a * lfdcp;
  const T b_lfdcp = a * gdp;
  // cons_i = cons2_rlmlt * (dp_i * zd + dp * zd_i)
  a = b_cons * c.cons2_rlmlt;
  g_dp = g_dp + a * zd;
  T b_zd = a * dp;
  // condl_i = (qlwc_i - ql_i) * rdt; condi_i = (qiwc_i - qi_i) * rdt
  a = b_cl * c.rdt;
  b_qlwc = b_qlwc + a;
  g_ql = g_ql - a;
  a = b_ci * c.rdt;
  b_qiwc = b_qiwc + a;
  g_qi = g_qi - a;
  // qlwc_i = qc_i * fwat + qc * fwat_i; qiwc_i = qc_i * (1 - fwat) - qc * fwat_i
  const T b_qc = b_qlwc * fwat + b_qiwc * (one - fwat);
  b_fwat = b_fwat + b_qlwc * qc - b_qiwc * qc;
  // qc_i = lo3 ? qc_i - dqc_i_sub : 0; the subsidence terms feed dqc_i_sub alone
  T b_qc1 = zero;
  T b_foeew = zero, b_dqsdtemp = b_corqs * c.cons3;  // corqs_i = cons3 * dqsdtemp_i
  if (lo3) {
    b_qc1 = b_qc;
    // dqc_i_sub = (dt * (dqsdz_i * mf + dqsdz * mf_i) - dqc * rho_i) * fac4 (times 0.1 with LREGCL)
    T s = -b_qc;
    if (LREGCL) s = s * T(0.1);
    a = s * fac4;
    const T e = a * c.dt;
    const T b_dqsdz = e * x.mf;
    g_mf = e * dqsdz;
    T b_rho = -(a * dqc);
    // dqsdz_i = dqsdtemp_i * dtdzmo + dqsdtemp * dtdzmo_i - rg * rodqsdp_i
    b_dqsdtemp = b_dqsdtemp + b_dqsdz * dtdzmo;
    T b_rodqsdp = -(b_dqsdz * c.rg);
    // dtdzmo_i = -(rg * (ldcp_i * rodqsdp + ldcp * rodqsdp_i)
    //              + dtdzmo * (ldcp_i * dqsdtemp + ldcp * dqsdtemp_i)) * fac3
    const T m = -((b_dqsdz * dqsdtemp) * fac3);
    const T r = m * c.rg;
    T b_ldcp = r * rodqsdp;
    b_rodqsdp = b_rodqsdp + r * ldcp;
    const T d = m * dtdzmo;
    b_ldcp = b_ldcp + d * dqsdtemp;
    b_dqsdtemp = b_dqsdtemp + d * ldcp;
    // ldcp_i = fwat_i * (lvdcp - lsdcp) + fwat * lvdcp_i + (1 - fwat) * lsdcp_i
    b_fwat = b_fwat + b_ldcp * (lvdcp - lsdcp);
    b_lvdcp = b_lvdcp + b_ldcp * fwat;
    b_lsdcp = b_lsdcp + b_ldcp * (one - fwat);
    // rodqsdp_i = (-rho_i * qsat_in - rho * qsat_in_i
    //              + rho * qsat_in * (ap_i - retv * foeew_i) * fac2) * fac2
    const T o = b_rodqsdp * fac2;
    b_rho = b_rho - o * qsat_in;
    g_qs = g_qs - o * rho;
    const T h = (o * fac2) * (rho * qsat_in);
    g_ap = g_ap + h;
    b_foeew = b_foeew - h * c.retv;
    // rho_i = (ap_i - ap * t_i * (rd * fac1)) * fac1
    const T k = b_rho * fac1;
    g_ap = g_ap + k;
    g_t = g_t - (k * (c.rd * fac1)) * ap;
  }
  // qc_i += lo1 ? lude_i : 0; clc_i += lo1 ? clc_i_conv : 0, with
  // clc_i_conv = -clc_i * (1 - tmp2) + (1 - clc) * tmp2 * ((lude_i - lude * lu_next_i * rlu1) * rlu1)
  T b_ludes = zero, b_clc0 = b_clc;
  if (lo1) {
    b_ludes = b_qc1;
    b_clc0 = b_clc - b_clc * (one - tmp2);
    const T e = (b_clc * ((one - clc0) * tmp2)) * rlu1;
    b_ludes = b_ludes + e;
    g_lu = -(e * rlu1) * lude;
  }
  // lude_i = dt * (x.lude_i * gdp + x.lude * gdp_i)
  a = b_ludes * c.dt;
  b_lude = b_lude + a * gdp;
  b_gdp = b_gdp + a * x.lude;
  // gdp_i = -rg * dp_i * (rdp * rdp)
  g_dp = g_dp + (b_gdp * (rdp * rdp)) * (-c.rg);
  // clc_i = low ? 0 : (high ? 0 : clc_mid_i); qc_i = low ? 0 : (high ? qc_high_i : qc_mid_i)
  T b_qsat = zero, b_qcrit = zero, b_qt = zero;
  if (mid) {
    // qc_mid_i = (scalm * qpd_i + (1 - scalm) * qcd_i) * clc_mid^2
    //            + 2 * (scalm * qpd + (1 - scalm) * qcd) * clc_mid * clc_mid_i
    a = b_qc1 * (clc_mid * clc_mid);
    T b_qpd = a * scalm, b_qcd = a * (one - scalm);
    T b_cm = b_clc0 + b_qc1 * (T(2) * (scalm * qpd + (one - scalm) * qcd) * clc_mid);
    if (LREGCL) b_cm = b_cm * yyy;
    // clc_mid_i = -0.5 * rtmp1 * (qpd_i * denom - qpd * (qcd_i - scalm * (qt_i - qcrit_i))) * rdenom^2
    const T e = (b_cm * (rdenom * rdenom)) * (T(-0.5) * rtmp1);
    b_qpd = b_qpd + e * denom;
    const T f = -(e * qpd);
    b_qcd = b_qcd + f;
    const T h = -(f * scalm);
    b_qt = h;
    b_qcrit = -h;
    // qpd_i = qsat_i - qt_i; qcd_i = qsat_i - qcrit_i
    b_qsat = b_qpd + b_qcd;
    b_qt = b_qt - b_qpd;
    b_qcrit = b_qcrit - b_qcd;
  } else if (high) {
    // qc_high_i = (1 - scalm) * (qsat_i - qcrit_i)
    a = b_qc1 * (one - scalm);
    b_qsat = a;
    b_qcrit = -a;
  }
  // qt_i = q_i + ql_i + qi_i
  g_q = g_q + b_qt;
  g_ql = g_ql + b_qt;
  g_qi = g_qi + b_qt;
  // qcrit_i = crh2 * qsat_i
  b_qsat = b_qsat + b_qcrit * crh2;
  // qsat_i = qsat_in_i * supsat_fac + qsat_in * supsat_fac_i;
  // supsat_fac_i = cold_ice ? -0.003 * t_i : 0
  g_qs = g_qs + b_qsat * supsat_fac;
  if (cold_ice) g_t = g_t + (b_qsat * qsat_in) * T(-0.003);
  // qlim_i = q > qsat_in ? qsat_in_i : q_i
  if (EVAP) {
    if (qlim_sat) {
      g_qs = g_qs + b_qlim;
    } else {
      g_q = g_q + b_qlim;
    }
  }
  // dqsdtemp_i = fac_i * cor * qsat_in + fac * cor_i * qsat_in + fac * cor * qsat_in_i
  a = b_dqsdtemp * qsat_in;
  const T b_fac = a * cor;
  const T b_cor = a * fac;
  g_qs = g_qs + b_dqsdtemp * (fac * cor);
  // cor_i = retv * esdp_i * cor^2; esdp_i = noclip ? esdp0_i : 0;
  // esdp0_i = (foeew_i - esdp0 * ap_i) * rap
  if (noclip) {
    a = ((b_cor * (cor * cor)) * c.retv) * rap;
    b_foeew = b_foeew + a;
    g_ap = g_ap - a * esdp0;
  }
  // fac_i = fwat_i * (facw - faci) + fwat * facw_i + (1 - fwat) * faci_i,
  // facw_i = m2_r5les * t_i * rl^3, faci_i = m2_r5ies * t_i * ri^3
  b_fwat = b_fwat + b_fac * (facw - faci);
  g_t = g_t + ((b_fac * fwat) * (rl * rl * rl)) * c.m2_r5les;
  g_t = g_t + ((b_fac * (one - fwat)) * (ri * ri * ri)) * c.m2_r5ies;
  // foeew_i = z3es * (rtt - z4es) * t_i * foeew * rz4es^2
  g_t = g_t + ((b_foeew * (rz4es * rz4es)) * foeew) * (z3es * (c.rtt - z4es));
  // fwat_i = cold ? 0.545 * 0.17 * t_i * (1 - th * th) : 0
  if (cold) g_t = g_t + (b_fwat * (one - th * th)) * T(0.545 * 0.17);
  // l*dcp_i = L * zz_i; zz_i = -zd_i * zz^2; zd_i = rcpd_rvtmp2 * q_i
  const T b_zz = b_lfdcp * c.rlmlt + b_lsdcp * c.rlstt + b_lvdcp * c.rlvtt;
  b_zd = b_zd - b_zz * (zz * zz);
  g_q = g_q + b_zd * c.rcpd_rvtmp2;

  ADCot<T> g;
  g.rfl = g_rfl;
  g.sfl = g_sfl;
  g.cov = g_cov;
  g.ap = g_ap;
  g.dp = g_dp;
  g.lu_next = g_lu;
  g.lude = b_lude;
  g.mf = g_mf;
  g.q2 = g_q;
  g.ql_fg = g_ql;
  g.qi_fg = g_qi;
  g.qsat = g_qs;
  g.t_fg = g_t;
  g.aph_s = g_aphs;
  return g;
}

template <typename T, bool EVAP, bool LREGCL, int D = DIV_EXACT>
CLOUDSC2_HD ADCot<T> ad_level(const TLLevelIn<T>& x, const TLCol<T>& col, const NLCarry<T>& traj,
                              const ADWeights<T>& w, const TLConst<T>& c) {
  return ad_level_traced<T, EVAP, LREGCL, D>(x, col, traj, w, c, nullptr);
}

// ------------------------------------------------------------ column body ----
// The Body of level_scan_column<Body, true>: the reverse sweep of
// cloudsc2_ad_pallas and its XLA folds and assembly, for one column (the
// fused kernel's reverse sweep, and the host's reference of ADPipeBody).
template <typename T, bool EVAP, bool LREGCL, int D = DIV_EXACT>
struct ADBody {
  ADFields<T> f;
  TLConst<T> c;
  int nlev, ncols;

  struct Column {
    TLCol<T> col;
    T rfl, sfl, cov;  // carry cotangents, zero at the bottom
    T dp_below;       // cot_dp of the level below (0 under the bottom level)
    T dp_bottom;      // cot_dp of the bottom level, for aph_i[nlev]
    T surf;           // column sum of the aph_s cotangent
  };

  CLOUDSC2_HD size_t at(int k, int col) const {
    return static_cast<size_t>(k) * static_cast<size_t>(ncols) + static_cast<size_t>(col);
  }

  CLOUDSC2_HD const ScalmTable<T>& level_table() const { return f.scalm; }

  // Prologue: the tropopause, the critical-RH coefficients, the surface
  // pressure, and zero carry cotangents.
  CLOUDSC2_HD Column begin(int col) const {
    NLCol<T> nl;
    nl.trpaus = tropopause_eta(f.t, f.tnd_cml_t, f.eta, c.dt, nlev, ncols, col);
    critical_rh_coeffs(nl);
    nl.aph_s = f.aph[at(nlev, col)];
    return begin(nl);
  }

  // The same from per-column values already computed (by the forward
  // sweep of the fused kernel).
  CLOUDSC2_HD Column begin(const NLCol<T>& nl) const {
    Column s;
    static_cast<NLCol<T>&>(s.col) = nl;
    s.col.aph_s_i = T(0);
    s.rfl = s.sfl = s.cov = T(0);
    s.dp_below = s.dp_bottom = s.surf = T(0);
    return s;
  }

  CLOUDSC2_HD void level(Column& s, int col, int k) const {
    const size_t i = at(k, col);
    const NLCarry<T> traj{f.c_rfl[i], f.c_sfl[i], EVAP ? f.c_cov[i] : T(0)};
    step(s, load(col, k), traj, col, k);
  }

  // The forward inputs of level k folded as the TL kernel folds them (the
  // perturbations zero).
  CLOUDSC2_HD TLLevelIn<T> load(int col, int k) const {
    const size_t i = at(k, col);
    const size_t ib = at(k + 1, col);
    TLLevelIn<T> x = {};
    x.ap = f.ap[i];
    x.dp = f.aph[ib] - f.aph[i];
    x.lu_next = k + 1 < nlev ? f.lu[ib] : T(0);
    x.lude = f.lude[i];
    x.mf = f.mfu[i] + f.mfd[i];
    x.q2 = f.q[i] + c.dt * f.tnd_cml_q[i] + f.supsat[i];
    x.ql_fg = f.ql[i] + c.dt * f.tnd_cml_ql[i];
    x.qi_fg = f.qi[i] + c.dt * f.tnd_cml_qi[i];
    x.qsat = f.qsat[i];
    x.t_fg = f.t[i] + c.dt * f.tnd_cml_t[i];
    x.eta = f.eta[k];
    x.scalm = f.scalm[k];
    return x;
  }

  // Reverse level k around its forward inputs x and the carry traj that
  // entered it: fold the seeds, transpose, write the level's cotangents.
  CLOUDSC2_HD void step(Column& s, const TLLevelIn<T>& x, const NLCarry<T>& traj, int col,
                        int k) const {
    const size_t i = at(k, col);
    const size_t ib = at(k + 1, col);
    const bool below = k + 1 < nlev;
    // the seeds; a flux output k is interface k+1 and folds its enthalpy
    // partner (fhps* = -L * fpls*)
    ADWeights<T> w;
    w.rfl = s.rfl + (f.fplsl_i[ib] - c.rlvtt * f.fhpsl_i[ib]);
    w.sfl = s.sfl + (f.fplsn_i[ib] - c.rlstt * f.fhpsn_i[ib]);
    w.cov = s.cov;
    w.tnd_t = f.tnd_t_i[i];
    w.tnd_q = f.tnd_q_i[i];
    w.tnd_ql = f.tnd_ql_i[i];
    w.tnd_qi = f.tnd_qi_i[i];
    w.clc = f.clc_i[i];
    w.covptot = EVAP ? f.covptot_i[i] : T(0);
    const ADCot<T> g = ad_level<T, EVAP, LREGCL, D>(x, s.col, traj, w, c);
    s.rfl = g.rfl;
    s.sfl = g.sfl;
    s.cov = g.cov;
    // the folded cotangents expanded onto the raw fields (_assemble)
    f.cml_t_i[i] = c.dt * g.t_fg;
    f.cml_q_i[i] = c.dt * g.q2;
    f.cml_ql_i[i] = c.dt * g.ql_fg;
    f.cml_qi_i[i] = c.dt * g.qi_fg;
    f.ap_i[i] = g.ap;
    f.t_i[i] = g.t_fg;
    f.q_i[i] = g.q2;
    f.qsat_i[i] = g.qsat;
    f.ql_i[i] = g.ql_fg;
    f.qi_i[i] = g.qi_fg;
    f.lude_i[i] = g.lude;
    f.mfd_i[i] = g.mf;
    f.mfu_i[i] = g.mf;
    f.supsat_i[i] = g.q2;
    // lu_next[k] = lu[k+1]: lu_i[k+1] = cot_lu_next[k] (the bottom level's
    // lu_next is 0, its cotangent is dropped)
    if (below) f.lu_i[ib] = g.lu_next;
    // dp[k] = aph[k+1] - aph[k]: aph_i[k+1] = cot_dp[k] - cot_dp[k+1]; the
    // bottom interface waits for the surface-pressure sum (end)
    if (below) {
      f.aph_i[ib] = g.dp - s.dp_below;
    } else {
      s.dp_bottom = g.dp;
    }
    s.dp_below = g.dp;
    if (EVAP) s.surf = s.surf + g.aph_s;
  }

  // Epilogue: the top rows, and the bottom interface of aph_i with the
  // column sum of the surface-pressure cotangent, written last.
  CLOUDSC2_HD void end(Column& s, int col) const {
    f.lu_i[at(0, col)] = T(0);
    f.aph_i[at(0, col)] = T(0) - s.dp_below;
    f.aph_i[at(nlev, col)] = EVAP ? s.dp_bottom + s.surf : s.dp_bottom;
  }
};

// ------------------------------------------------------- pipelined body ----
// The values of one level in a slot of the pipelined reverse scan's ring,
// in this order: the raw fields (aph at the level's top interface k, lu at
// k+1), the flux seeds at interface k+1, the level's seeds, the trajectory;
// covptot_i and c_cov last, and absent without EVAP.
enum ADRingField {
  AR_AP, AR_APH, AR_LU, AR_LUDE, AR_MFD, AR_MFU, AR_Q, AR_QI, AR_QL, AR_QSAT, AR_SUPSAT, AR_T, AR_TND_Q,
  AR_TND_QI, AR_TND_QL, AR_TND_T, AR_FPLSL_I, AR_FPLSN_I, AR_FHPSL_I, AR_FHPSN_I, AR_TND_T_I, AR_TND_Q_I,
  AR_TND_QL_I, AR_TND_QI_I, AR_CLC_I, AR_C_RFL, AR_C_SFL, AR_COVPTOT_I, AR_C_COV
};

// The ring's slots by type (DEPTH - 1 levels in flight while one runs),
// in shared memory in both types, chosen by measurement on an H100 (a
// ladder of depths, PERF.md section 6): two in both, the level running and
// the one above it (27,648 B a block in float, 55,296 B in double; in
// float three slots ran 2-5% slower and four 7%, in double three 7%).
template <typename T>
struct ADRing {
  static constexpr int DEPTH = 2;
};

// The Body of level_scan_pipelined_column<DEPTH, true>: ADBody's reverse
// level, its values copied into the ring ahead of the level and folded
// from the slot as ADBody::load and ADBody::step fold them from memory
// (the same operations in the same order), then transposed and written as
// ADBody::step does.  aph at the level's bottom interface is carried from
// the level below.
template <typename T, bool EVAP, bool LREGCL, int D = DIV_EXACT>
struct ADPipeBody : ADBody<T, EVAP, LREGCL, D> {
  using Base = ADBody<T, EVAP, LREGCL, D>;
  static constexpr int FIELDS = EVAP ? AR_C_COV + 1 : AR_COVPTOT_I;

  struct Column : Base::Column {
    T aph_below;  // aph at the interface below the level
  };

  // Prologue: ADBody::begin with the tropopause pass's loads issued eight
  // levels at a time.
  CLOUDSC2_HD Column begin(int col) const {
    const ADFields<T>& f = this->f;
    NLCol<T> nl;
    nl.trpaus = tropopause_eta_ahead<8>(f.t, f.tnd_cml_t, f.eta, this->c.dt, this->nlev, this->ncols, col);
    critical_rh_coeffs(nl);
    nl.aph_s = f.aph[this->at(this->nlev, col)];
    Column s;
    static_cast<typename Base::Column&>(s) = Base::begin(nl);
    s.aph_below = nl.aph_s;
    return s;
  }

  template <class Ring>
  CLOUDSC2_HD void prefetch(Ring& r, int slot, int col, int k) const {
    const ADFields<T>& f = this->f;
    const size_t i = this->at(k, col);
    const size_t ib = this->at(k + 1, col);
    r.copy(slot, AR_AP, f.ap + i);
    r.copy(slot, AR_APH, f.aph + i);
    if (k + 1 < this->nlev) r.copy(slot, AR_LU, f.lu + ib);
    r.copy(slot, AR_LUDE, f.lude + i);
    r.copy(slot, AR_MFD, f.mfd + i);
    r.copy(slot, AR_MFU, f.mfu + i);
    r.copy(slot, AR_Q, f.q + i);
    r.copy(slot, AR_QI, f.qi + i);
    r.copy(slot, AR_QL, f.ql + i);
    r.copy(slot, AR_QSAT, f.qsat + i);
    r.copy(slot, AR_SUPSAT, f.supsat + i);
    r.copy(slot, AR_T, f.t + i);
    r.copy(slot, AR_TND_Q, f.tnd_cml_q + i);
    r.copy(slot, AR_TND_QI, f.tnd_cml_qi + i);
    r.copy(slot, AR_TND_QL, f.tnd_cml_ql + i);
    r.copy(slot, AR_TND_T, f.tnd_cml_t + i);
    r.copy(slot, AR_FPLSL_I, f.fplsl_i + ib);
    r.copy(slot, AR_FPLSN_I, f.fplsn_i + ib);
    r.copy(slot, AR_FHPSL_I, f.fhpsl_i + ib);
    r.copy(slot, AR_FHPSN_I, f.fhpsn_i + ib);
    r.copy(slot, AR_TND_T_I, f.tnd_t_i + i);
    r.copy(slot, AR_TND_Q_I, f.tnd_q_i + i);
    r.copy(slot, AR_TND_QL_I, f.tnd_ql_i + i);
    r.copy(slot, AR_TND_QI_I, f.tnd_qi_i + i);
    r.copy(slot, AR_CLC_I, f.clc_i + i);
    r.copy(slot, AR_C_RFL, f.c_rfl + i);
    r.copy(slot, AR_C_SFL, f.c_sfl + i);
    if constexpr (EVAP) {
      r.copy(slot, AR_COVPTOT_I, f.covptot_i + i);
      r.copy(slot, AR_C_COV, f.c_cov + i);
    }
  }

  // Level k from its slot (and the interface below it, which then moves up
  // a level): what ADBody::level loads and folds from memory.
  template <class Slot>
  CLOUDSC2_HD void level(Column& s, const Slot& r, int col, int k) const {
    const TLConst<T>& c = this->c;
    TLLevelIn<T> x = {};
    const T aph_above = r(AR_APH);
    x.ap = r(AR_AP);
    x.dp = s.aph_below - aph_above;
    x.lu_next = k + 1 < this->nlev ? r(AR_LU) : T(0);
    x.lude = r(AR_LUDE);
    x.mf = r(AR_MFU) + r(AR_MFD);
    x.q2 = r(AR_Q) + c.dt * r(AR_TND_Q) + r(AR_SUPSAT);
    x.ql_fg = r(AR_QL) + c.dt * r(AR_TND_QL);
    x.qi_fg = r(AR_QI) + c.dt * r(AR_TND_QI);
    x.qsat = r(AR_QSAT);
    x.t_fg = r(AR_T) + c.dt * r(AR_TND_T);
    x.eta = this->f.eta[k];
    x.scalm = this->f.scalm[k];
    s.aph_below = aph_above;
    NLCarry<T> traj{r(AR_C_RFL), r(AR_C_SFL), T(0)};
    if constexpr (EVAP) traj.covptot = r(AR_C_COV);
    ADWeights<T> w;
    w.rfl = s.rfl + (r(AR_FPLSL_I) - c.rlvtt * r(AR_FHPSL_I));
    w.sfl = s.sfl + (r(AR_FPLSN_I) - c.rlstt * r(AR_FHPSN_I));
    w.cov = s.cov;
    w.tnd_t = r(AR_TND_T_I);
    w.tnd_q = r(AR_TND_Q_I);
    w.tnd_ql = r(AR_TND_QL_I);
    w.tnd_qi = r(AR_TND_QI_I);
    w.clc = r(AR_CLC_I);
    w.covptot = T(0);
    if constexpr (EVAP) w.covptot = r(AR_COVPTOT_I);
    const ADCot<T> g = ad_level<T, EVAP, LREGCL, D>(x, s.col, traj, w, c);
    // the level's cotangents, written as ADBody::step writes them (step
    // stays as it is: the fused kernel's reverse sweep runs it, and moving
    // these stores into a helper of both changed that kernel's code)
    const ADFields<T>& f = this->f;
    const size_t i = this->at(k, col);
    const size_t ib = this->at(k + 1, col);
    const bool below = k + 1 < this->nlev;
    s.rfl = g.rfl;
    s.sfl = g.sfl;
    s.cov = g.cov;
    f.cml_t_i[i] = c.dt * g.t_fg;
    f.cml_q_i[i] = c.dt * g.q2;
    f.cml_ql_i[i] = c.dt * g.ql_fg;
    f.cml_qi_i[i] = c.dt * g.qi_fg;
    f.ap_i[i] = g.ap;
    f.t_i[i] = g.t_fg;
    f.q_i[i] = g.q2;
    f.qsat_i[i] = g.qsat;
    f.ql_i[i] = g.ql_fg;
    f.qi_i[i] = g.qi_fg;
    f.lude_i[i] = g.lude;
    f.mfd_i[i] = g.mf;
    f.mfu_i[i] = g.mf;
    f.supsat_i[i] = g.q2;
    if (below) f.lu_i[ib] = g.lu_next;
    if (below) {
      f.aph_i[ib] = g.dp - s.dp_below;
    } else {
      s.dp_bottom = g.dp;
    }
    s.dp_below = g.dp;
    if (EVAP) s.surf = s.surf + g.aph_s;
  }
};

// Fill a body from the wrapper's pointer lists (orders as in the X-lists).
template <typename T, bool EVAP, bool LREGCL, int D = DIV_EXACT>
inline ADBody<T, EVAP, LREGCL, D> make_ad_body(const void* const* in, void* const* out,
                                               const void* consts, int nlev, int ncols) {
  ADBody<T, EVAP, LREGCL, D> b;
  int i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<const T*>(in[i++]);
  CLOUDSC2_AD_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<T*>(out[i++]);
  CLOUDSC2_AD_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  memcpy(&b.c, consts, sizeof(TLConst<T>));
  b.f.scalm = {b.f.eta, b.c.zscal, b.c.zeps1};
  b.nlev = nlev;
  b.ncols = ncols;
  return b;
}

// Call L.template run<T, EVAP, LREGCL, D>() for the runtime switches: the 4
// switch pairs for each type and divide policy the library holds
// (scalar_math.h "library forms"; check forms_valid first).
template <class L, typename T, int D>
inline int ad_dispatch_t(const L& launcher, int evap, int lregcl) {
  if (evap)
    return lregcl ? launcher.template run<T, true, true, D>() : launcher.template run<T, true, false, D>();
  return lregcl ? launcher.template run<T, false, true, D>() : launcher.template run<T, false, false, D>();
}

template <class L>
inline int ad_dispatch(const L& launcher, int is_double, int evap, int lregcl, int div) {
  return dispatch_type_div(is_double, div, -1, [&](auto t, auto d) {
    return ad_dispatch_t<L, decltype(t), decltype(d)::value>(launcher, evap, lregcl);
  });
}

}  // namespace cloudsc2
