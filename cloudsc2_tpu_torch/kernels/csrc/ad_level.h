// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// One reverse level of the CLOUDSC2 adjoint for one column, and the
// per-column body that runs it bottom-up through the level scan
// (levelscan.cuh, REVERSE).  The reverse half of cloudsc2_ad_pallas
// (cloudsc2_tpu/pallas/adjoint.py:125): its reverse body _make_rev_body
// (:320), its input folds _reverse_problem (:260) and its assembly
// _assemble (:362), which cloudsc2_ad_pallas_fused (:432) shares: the fused
// kernel (ad_fused.h) runs this body too, from its stack.
//
// The TL level (tl_level of tl_level.h) is exactly linear in its
// perturbations: every branch depends on forward values only.  Its
// transpose at one level is therefore built from Jacobian columns: the
// already checked tl_level runs once per input direction with a unit
// perturbation there and zeros elsewhere, around the forward carry the NL
// kernel stored entering the level (its trajectory), and each result is
// dotted with the level's output cotangents.  That is the exact transpose
// up to rounding, with no hand-transposed code.  The directions are the 3
// carry perturbations, the 10 folded inputs (XI_NAMES, pallas/adjoint.py:107)
// and, with evaporation, the surface-pressure perturbation aph_s_i: 14.
// Without evaporation the covptot carry feeds nothing but itself (its
// cotangent stays 0) and aph_s_i is not read, so 12 directions run.
//
// Static switches are template bools: EVAP = LEVAPLS2 || LDRAIN1D, LREGCL.
// The AD requires LPHYLIN (the NL trajectory is the TL's forward only under
// linearized physics); the wrapper enforces it.
#pragma once

#include <string.h>

#include "tl_level.h"

namespace cloudsc2 {

// ------------------------------------------------------------ argument lists
// Mirrored in Python (kernels/adjoint.py AD_INPUTS / AD_OUTPUTS; the
// constants are TLConst's); ad_signature() reports them for the wrapper.
// (nlev, ncols) fields, except aph and the four flux seeds (nlev+1, ncols)
// and eta, scalm (nlev,); c_cov and covptot_i are read only with EVAP and
// may be null otherwise.
#define CLOUDSC2_AD_INPUTS(X)                                                  \
  X(ap) X(aph) X(lu) X(lude) X(mfd) X(mfu) X(q) X(qi) X(ql) X(qsat) X(supsat)  \
  X(t) X(tnd_cml_q) X(tnd_cml_qi) X(tnd_cml_ql) X(tnd_cml_t)                   \
  X(tnd_t_i) X(tnd_q_i) X(tnd_ql_i) X(tnd_qi_i) X(clc_i) X(covptot_i)          \
  X(fplsl_i) X(fplsn_i) X(fhpsl_i) X(fhpsn_i) X(c_rfl) X(c_sfl) X(c_cov)       \
  X(eta) X(scalm)

// (nlev, ncols) fields, except aph_i (nlev+1, ncols)
#define CLOUDSC2_AD_OUTPUTS(X)                                                 \
  X(cml_t_i) X(cml_q_i) X(cml_ql_i) X(cml_qi_i) X(ap_i) X(aph_i) X(t_i) X(q_i) \
  X(qsat_i) X(ql_i) X(qi_i) X(lu_i) X(lude_i) X(mfd_i) X(mfu_i) X(supsat_i)

// The input directions of one TL level: the carry perturbations, the folded
// inputs, the surface pressure.
#define CLOUDSC2_AD_DIRS(X)                                                    \
  X(rfl) X(sfl) X(cov) X(ap) X(dp) X(lu_next) X(lude) X(mf) X(q2) X(ql_fg)     \
  X(qi_fg) X(qsat) X(t_fg) X(aph_s)

#define CLOUDSC2_STR(n) #n ","
inline const char* ad_signature() {
  return "consts:" CLOUDSC2_TL_CONSTS(CLOUDSC2_STR)
         ";inputs:" CLOUDSC2_AD_INPUTS(CLOUDSC2_STR)
         ";outputs:" CLOUDSC2_AD_OUTPUTS(CLOUDSC2_STR);
}
#undef CLOUDSC2_STR

enum ADDir {
#define CLOUDSC2_ENUM(n) AD_##n,
  CLOUDSC2_AD_DIRS(CLOUDSC2_ENUM)
#undef CLOUDSC2_ENUM
  AD_NDIR
};

template <typename T>
struct ADFields {
#define CLOUDSC2_FIELD(n) const T* n;
  CLOUDSC2_AD_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
#define CLOUDSC2_FIELD(n) T* n;
  CLOUDSC2_AD_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
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
  T rfl, sfl, cov, tnd_t, tnd_q, tnd_ql, tnd_qi, clc, covptot;
};

// ---------------------------------------------------------------- ad_level ----
// The transpose of tl_level at one point: x holds the level's forward
// values (its perturbations are ignored), traj the forward carry entering
// the level, w the cotangents of the level's outputs.  Returns the
// cotangent of every input direction.
template <typename T, bool EVAP, bool LREGCL>
CLOUDSC2_HD ADCot<T> ad_level(const TLLevelIn<T>& x, const TLCol<T>& col, const NLCarry<T>& traj,
                              const ADWeights<T>& w, const TLConst<T>& c) {
  ADCot<T> g;
#define CLOUDSC2_ZERO(n) g.n = T(0);
  CLOUDSC2_AD_DIRS(CLOUDSC2_ZERO)
#undef CLOUDSC2_ZERO
  // one TL level per direction; kept rolled, so the body is compiled once
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int d = 0; d < AD_NDIR; ++d) {
    if (!EVAP && (d == AD_cov || d == AD_aph_s)) continue;
    TLCarry<T> carry{traj.rfl, traj.sfl, traj.covptot,
                     T(d == AD_rfl), T(d == AD_sfl), T(d == AD_cov)};
    TLLevelIn<T> xd = x;
    xd.ap_i = T(d == AD_ap);
    xd.dp_i = T(d == AD_dp);
    xd.lu_next_i = T(d == AD_lu_next);
    xd.lude_i = T(d == AD_lude);
    xd.mf_i = T(d == AD_mf);
    xd.q2_i = T(d == AD_q2);
    xd.ql_fg_i = T(d == AD_ql_fg);
    xd.qi_fg_i = T(d == AD_qi_fg);
    xd.qsat_i = T(d == AD_qsat);
    xd.t_fg_i = T(d == AD_t_fg);
    TLCol<T> cold = col;
    cold.aph_s_i = T(d == AD_aph_s);
    const TLLevelOut<T> o = tl_level<T, EVAP, LREGCL>(carry, xd, cold, c);
    T v = carry.rfl_i * w.rfl + carry.sfl_i * w.sfl + o.tnd_t_i * w.tnd_t +
          o.tnd_q_i * w.tnd_q + o.tnd_ql_i * w.tnd_ql + o.tnd_qi_i * w.tnd_qi + o.clc_i * w.clc;
    if (EVAP) v = v + carry.covptot_i * w.cov + o.covptot_i * w.covptot;
#define CLOUDSC2_PICK(n) g.n = d == AD_##n ? v : g.n;
    CLOUDSC2_AD_DIRS(CLOUDSC2_PICK)
#undef CLOUDSC2_PICK
  }
  return g;
}

// ------------------------------------------------------------ column body ----
// The Body of level_scan_column<Body, true>: the reverse sweep of
// cloudsc2_ad_pallas and its XLA folds and assembly, for one column.
template <typename T, bool EVAP, bool LREGCL>
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
    const ADCot<T> g = ad_level<T, EVAP, LREGCL>(x, s.col, traj, w, c);
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

// Fill a body from the wrapper's pointer lists (orders as in the X-lists).
template <typename T, bool EVAP, bool LREGCL>
inline ADBody<T, EVAP, LREGCL> make_ad_body(const void* const* in, void* const* out,
                                            const void* consts, int nlev, int ncols) {
  ADBody<T, EVAP, LREGCL> b;
  int i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<const T*>(in[i++]);
  CLOUDSC2_AD_INPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  i = 0;
#define CLOUDSC2_FIELD(n) b.f.n = static_cast<T*>(out[i++]);
  CLOUDSC2_AD_OUTPUTS(CLOUDSC2_FIELD)
#undef CLOUDSC2_FIELD
  memcpy(&b.c, consts, sizeof(TLConst<T>));
  b.nlev = nlev;
  b.ncols = ncols;
  return b;
}

// Call L.template run<T, EVAP, LREGCL>() for the runtime switches; this
// instantiates all 4 switch pairs x 2 dtypes.
template <class L, typename T>
inline int ad_dispatch_t(const L& launcher, int evap, int lregcl) {
  if (evap)
    return lregcl ? launcher.template run<T, true, true>() : launcher.template run<T, true, false>();
  return lregcl ? launcher.template run<T, false, true>() : launcher.template run<T, false, false>();
}

template <class L>
inline int ad_dispatch(const L& launcher, int is_double, int evap, int lregcl) {
  return is_double ? ad_dispatch_t<L, double>(launcher, evap, lregcl)
                   : ad_dispatch_t<L, float>(launcher, evap, lregcl);
}

}  // namespace cloudsc2
