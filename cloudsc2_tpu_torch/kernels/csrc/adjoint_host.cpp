// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Host build of the AD reverse kernel's body (ad_level.h ADPipeBody through
// the pipelined reverse scan of levelscan.cuh, and ADBody through its
// direct reverse scan for reference), compiled with g++ -ffp-contract=off.
// The CPU tests run it, after the host NL body with its trajectory, against
// the plain AD, so the kernel's own arithmetic is checked on a machine
// without a card, and the pipelined scan against the direct one.  Another
// entry runs one level pointwise, tl_level forward and ad_level in reverse,
// for the tests of the transpose's duality, in the arrays' type or, as
// their reference, in long double.  None is used on the main path.
#include <math.h>

#include "scalar_math.h"

// long double math for the reference evaluation, declared before the level
// bodies so that their templates find it.  Under a non-exact divide policy
// (float points only) the reference takes the approximate reciprocal of the
// same float operand, and carries out the Newton step and the products in
// long double.
namespace cloudsc2 {
inline long double m_exp(long double x) { return expl(x); }
inline long double m_tanh(long double x) { return tanhl(x); }
inline long double m_sqrt(long double x) { return sqrtl(x); }
inline long double m_pow(long double x, long double y) { return powl(x, y); }

template <int D>
inline long double rcp(long double x) {
  if constexpr (D == DIV_EXACT) {
    return 1.0L / x;
  } else {
    const long double r = rcp_approx(static_cast<float>(x));
    if constexpr (D == DIV_FAITHFUL) return r * (2.0L - x * r);
    return r;
  }
}

template <int D>
inline long double fdiv(long double a, long double b) {
  if constexpr (D == DIV_EXACT) {
    return a / b;
  } else {
    return a * rcp<D>(b);
  }
}

template <int D>
inline long double fdiv_scalar(long double a, long double b) {
  if constexpr (D == DIV_EXACT) {
    return a / b;
  } else {
    return a * (1.0L / b);
  }
}
}  // namespace cloudsc2

#include "ad_level.h"

// The pointwise level entry's arrays, one value per point: the level's
// forward inputs, the column's surface pressure and tropopause, the carry
// entering the level, the perturbation of each input direction and the
// cotangent of each output; then the TL level's outputs and the AD level's
// cotangents.
#define CLOUDSC2_LEVEL_X(X)                                                    \
  X(ap) X(dp) X(lu_next) X(lude) X(mf) X(q2) X(ql_fg) X(qi_fg) X(qsat) X(t_fg)  \
  X(eta) X(scalm)
#define CLOUDSC2_LEVEL_COL(X) X(aph_s) X(trpaus)
#define CLOUDSC2_LEVEL_TRAJ(X) X(rfl) X(sfl) X(covptot)

namespace {

// The columns in a loop, through the pipelined reverse scan the card runs
// (its ring in shared memory as HostRing models it), or with DIRECT
// through the direct reverse scan of ADBody.
template <bool DIRECT>
struct HostRunner {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;

  template <typename T, bool EVAP, bool LREGCL, int D>
  int run() const {
    const auto body = cloudsc2::make_ad_body<T, EVAP, LREGCL, D>(in, out, consts, nlev, ncols);
    if constexpr (DIRECT) {
      cloudsc2::level_scan_host<decltype(body), true>(body);
    } else {
      using Pipe = cloudsc2::ADPipeBody<T, EVAP, LREGCL, D>;
      cloudsc2::level_scan_pipelined_host<cloudsc2::ADRing<T>::DEPTH, true, Pipe, T, true>(Pipe{body});
    }
    return 0;
  }
};

// tl_level and ad_level at each point, as the AD body calls them, on
// arrays of S in the arithmetic of T.
template <typename S>
struct LevelRunner {
  const void* const* in;
  void* const* out;
  unsigned* branches;
  const void* consts;
  int npoints;

  template <typename T, bool EVAP, bool LREGCL, int D>
  int run() const {
    cloudsc2::TLConst<T> c;
    int k = 0;
#define CLOUDSC2_READ(n) c.n = static_cast<T>(static_cast<const S*>(consts)[k++]);
    CLOUDSC2_TL_CONSTS(CLOUDSC2_READ)
#undef CLOUDSC2_READ
    for (int p = 0; p < npoints; ++p) {
      int i = 0;
      auto next = [&]() { return static_cast<T>(static_cast<const S*>(in[i++])[p]); };
      cloudsc2::TLLevelIn<T> x = {};
#define CLOUDSC2_READ(n) x.n = next();
      CLOUDSC2_LEVEL_X(CLOUDSC2_READ)
#undef CLOUDSC2_READ
      cloudsc2::TLCol<T> col = {};
      col.aph_s = next();
      col.trpaus = next();
      cloudsc2::critical_rh_coeffs(static_cast<cloudsc2::NLCol<T>&>(col));
      cloudsc2::NLCarry<T> traj;
#define CLOUDSC2_READ(n) traj.n = next();
      CLOUDSC2_LEVEL_TRAJ(CLOUDSC2_READ)
#undef CLOUDSC2_READ
      cloudsc2::ADCot<T> d;
#define CLOUDSC2_READ(n) d.n = next();
      CLOUDSC2_AD_DIRS(CLOUDSC2_READ)
#undef CLOUDSC2_READ
      cloudsc2::ADWeights<T> w;
#define CLOUDSC2_READ(n) w.n = next();
      CLOUDSC2_AD_WEIGHTS(CLOUDSC2_READ)
#undef CLOUDSC2_READ
      // the TL level at the perturbations d
      cloudsc2::TLCarry<T> carry{traj.rfl, traj.sfl, traj.covptot, d.rfl, d.sfl, d.cov};
      cloudsc2::TLLevelIn<T> xd = x;
      xd.ap_i = d.ap;
      xd.dp_i = d.dp;
      xd.lu_next_i = d.lu_next;
      xd.lude_i = d.lude;
      xd.mf_i = d.mf;
      xd.q2_i = d.q2;
      xd.ql_fg_i = d.ql_fg;
      xd.qi_fg_i = d.qi_fg;
      xd.qsat_i = d.qsat;
      xd.t_fg_i = d.t_fg;
      cloudsc2::TLCol<T> cold = col;
      cold.aph_s_i = d.aph_s;
      const cloudsc2::TLLevelOut<T> o = cloudsc2::tl_level<T, EVAP, LREGCL, D>(carry, xd, cold, c);
      const cloudsc2::ADWeights<T> tl{carry.rfl_i, carry.sfl_i, carry.covptot_i, o.tnd_t_i,
                                      o.tnd_q_i,   o.tnd_ql_i,  o.tnd_qi_i,      o.clc_i,
                                      o.covptot_i};
      // the AD level at the weights w
      const cloudsc2::ADCot<T> g =
          cloudsc2::ad_level_traced<T, EVAP, LREGCL, D>(x, col, traj, w, c, branches + p);
      int j = 0;
#define CLOUDSC2_WRITE(n) static_cast<S*>(out[j++])[p] = static_cast<S>(tl.n);
      CLOUDSC2_AD_WEIGHTS(CLOUDSC2_WRITE)
#undef CLOUDSC2_WRITE
#define CLOUDSC2_WRITE(n) static_cast<S*>(out[j++])[p] = static_cast<S>(g.n);
      CLOUDSC2_AD_DIRS(CLOUDSC2_WRITE)
#undef CLOUDSC2_WRITE
    }
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_signature() { return cloudsc2::ad_signature(); }

// Same arguments as cloudsc2_ad_launch (adjoint.cu) with host pointers and
// no stream, through the pipelined reverse scan the card runs (its ring of
// cloudsc2_ad_ring_depth slots, the copies modelled as landing at their
// wait); returns 0 on success.
int cloudsc2_ad_host(int is_double, int evap, int lregcl, int div, int compact, const void* const* in,
                     void* const* out, const void* consts, int nlev, int ncols) {
  if (nlev < 1 || ncols < 1 || !cloudsc2::forms_valid(is_double, div, compact)) return 1;
  const HostRunner<false> r{in, out, consts, nlev, ncols};
  return cloudsc2::ad_dispatch(r, is_double, evap, lregcl, div);
}

// The same through the direct reverse scan (level_scan_host of ADBody:
// each level's loads, then its arithmetic, then its stores), the
// reference of the pipelined scan in the CPU tests.
int cloudsc2_ad_direct_host(int is_double, int evap, int lregcl, int div, int compact, const void* const* in,
                            void* const* out, const void* consts, int nlev, int ncols) {
  if (nlev < 1 || ncols < 1 || !cloudsc2::forms_valid(is_double, div, compact)) return 1;
  const HostRunner<true> r{in, out, consts, nlev, ncols};
  return cloudsc2::ad_dispatch(r, is_double, evap, lregcl, div);
}

// The ring's depth for float (is_double 0) or double (1), the card's.
int cloudsc2_ad_ring_depth(int is_double) {
  return is_double ? cloudsc2::ADRing<double>::DEPTH : cloudsc2::ADRing<float>::DEPTH;
}

#define CLOUDSC2_STR(n) #n ","
// The pointwise level entry's argument lists, in the order of its arrays.
const char* cloudsc2_ad_level_signature() {
  return "x:" CLOUDSC2_LEVEL_X(CLOUDSC2_STR)
         ";col:" CLOUDSC2_LEVEL_COL(CLOUDSC2_STR)
         ";traj:" CLOUDSC2_LEVEL_TRAJ(CLOUDSC2_STR)
         ";dirs:" CLOUDSC2_AD_DIRS(CLOUDSC2_STR)
         ";weights:" CLOUDSC2_AD_WEIGHTS(CLOUDSC2_STR)
         ";branches:" CLOUDSC2_AD_BRANCHES(CLOUDSC2_STR);
}
#undef CLOUDSC2_STR

// At each of npoints points, tl_level at the given perturbations and
// ad_level at the given weights.  precision: 0 float, 1 double, 2 long
// double arithmetic on double arrays and constants (the reference of either
// type: with a non-exact div, of float); div, compact: a form the library
// holds, as for cloudsc2_ad_host (div exact in double).  in: host arrays of
// npoints values in the order x, col, traj, dirs (the perturbation of each
// direction), weights (the cotangent of each output); consts: TLConst's
// values; out: the TL level's outputs in the order of weights, then the AD
// level's cotangents in the order of dirs; branches: npoints masks of the
// branches ad_level took (bit i: the i-th name of ";branches:").
int cloudsc2_ad_level_host(int precision, int evap, int lregcl, int div, int compact,
                           const void* const* in, void* const* out, unsigned* branches,
                           const void* consts, int npoints) {
  if (npoints < 1 || precision < 0 || precision > 2 ||
      !cloudsc2::forms_valid(precision == 1, div, compact))
    return 1;
  return cloudsc2::dispatch_type_div(precision == 1, div, 1, [&](auto, auto d) {
    constexpr int D = decltype(d)::value;
    if (precision == 0) {
      return cloudsc2::ad_dispatch_t<LevelRunner<float>, float, D>(
          LevelRunner<float>{in, out, branches, consts, npoints}, evap, lregcl);
    }
    const LevelRunner<double> r{in, out, branches, consts, npoints};
    return precision == 1 ? cloudsc2::ad_dispatch_t<LevelRunner<double>, double, D>(r, evap, lregcl)
                          : cloudsc2::ad_dispatch_t<LevelRunner<double>, long double, D>(r, evap, lregcl);
  });
}

}  // extern "C"
