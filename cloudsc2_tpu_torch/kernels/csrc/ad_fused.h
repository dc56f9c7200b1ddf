// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// The CLOUDSC2 adjoint in one pass over a column: the forward sweep (the NL
// level, nl_level.h) pushes the carry entering each level onto a stack, and
// the reverse sweep (the transposed TL level, ad_level.h) pops it, on the
// fused form of the level scan (levelscan.cuh, level_scan_fwdrev_column).
// The bodies of cloudsc2_ad_pallas_fused (cloudsc2_tpu/pallas/adjoint.py:432):
// its forward body nl_level (:487-495), its reverse body _make_rev_body
// (:320, shared with the two-kernel AD), its folds _reverse_problem (:260)
// and its assembly _assemble (:362) with the flux rows (:526-536).  Both
// sweeps divide under the one policy D (scalar_math.h) and, as the
// library's form says, with one form of the saturation adjustment.
//
// Each sweep is the two-kernel AD's own code: the NL kernel's pipelined
// body forward (NLPipeBody's prefetch / fold, nl_level, store), ADBody's
// load / step / end in reverse, so both forms give the same numbers.  The
// per-column prologue (tropopause, critical-RH coefficients, surface
// pressure) runs once, for both sweeps.
//
// Static switches are template bools: EVAP = LEVAPLS2 || LDRAIN1D, LREGCL,
// and RESIDENT: the forward sweep also pushes the level's ten folded inputs
// (FWD_INPUTS, pallas/adjoint.py:98), and the reverse sweep reads them back
// instead of the 16 raw fields (the resident option of
// pallas/levelscan.py:223-225,236-237).  The forward sweep is the NL under
// linearized physics (THERMO) whatever LPHYLIN the constants hold: that is
// the TL's own forward, and the TL and AD do not read LPHYLIN.
#pragma once

#include <string.h>

#include "ad_level.h"

namespace cloudsc2 {

// ------------------------------------------------------------ argument lists
// Mirrored in Python (kernels/adjoint.py AD_FUSED_INPUTS / AD_FUSED_OUTPUTS;
// the constants are NLConst's and TLConst's); ad_fused_signature() reports
// them for the wrapper.  (nlev, ncols) fields, except aph and the four flux
// seeds (nlev+1, ncols) and eta (nlev,); covptot_i is read only with EVAP
// and may be null otherwise.
#define CLOUDSC2_AD_FUSED_RAW(X)                                               \
  X(ap) X(aph) X(lu) X(lude) X(mfd) X(mfu) X(q) X(qi) X(ql) X(qsat) X(supsat)  \
  X(t) X(tnd_cml_q) X(tnd_cml_qi) X(tnd_cml_ql) X(tnd_cml_t)
#define CLOUDSC2_AD_FUSED_SEEDS(X)                                             \
  X(tnd_t_i) X(tnd_q_i) X(tnd_ql_i) X(tnd_qi_i) X(clc_i) X(covptot_i)          \
  X(fplsl_i) X(fplsn_i) X(fhpsl_i) X(fhpsn_i)
#define CLOUDSC2_AD_FUSED_INPUTS(X)                                            \
  CLOUDSC2_AD_FUSED_RAW(X) CLOUDSC2_AD_FUSED_SEEDS(X) X(eta)

// The NL step's outputs (the fluxes (nlev+1, ncols)), then the AD's.
#define CLOUDSC2_AD_FUSED_FWD_OUTPUTS(X)                                       \
  X(tnd_t) X(tnd_q) X(tnd_ql) X(tnd_qi) X(clc) X(covptot) X(fplsl) X(fplsn)    \
  X(fhpsl) X(fhpsn)
#define CLOUDSC2_AD_FUSED_OUTPUTS(X) CLOUDSC2_AD_FUSED_FWD_OUTPUTS(X) CLOUDSC2_AD_OUTPUTS(X)

// The folded level inputs the resident form keeps on the stack.
#define CLOUDSC2_AD_FUSED_RESIDENT(X)                                          \
  X(ap) X(dp) X(lu_next) X(lude) X(mf) X(q2) X(ql_fg) X(qi_fg) X(qsat) X(t_fg)

// The entries take both constant structs in one buffer, NLConst's then
// TLConst's, and after the outputs the stack's scratch, the output at
// AD_FUSED_SCRATCH.
#define CLOUDSC2_STR(n) #n ","
inline const char* ad_fused_signature() {
  return "consts:" CLOUDSC2_NL_CONSTS(CLOUDSC2_STR) CLOUDSC2_TL_CONSTS(CLOUDSC2_STR)
         ";inputs:" CLOUDSC2_AD_FUSED_INPUTS(CLOUDSC2_STR)
         ";outputs:" CLOUDSC2_AD_FUSED_OUTPUTS(CLOUDSC2_STR) "scratch,"
         ";resident:" CLOUDSC2_AD_FUSED_RESIDENT(CLOUDSC2_STR);
}
#undef CLOUDSC2_STR
#define CLOUDSC2_ONE(n) +1
constexpr int AD_FUSED_SCRATCH = 0 CLOUDSC2_AD_FUSED_OUTPUTS(CLOUDSC2_ONE);
#undef CLOUDSC2_ONE

// The TL struct of an entry's constant buffer, after the NL struct.
template <typename T>
inline const void* fused_tl_consts(const void* consts) {
  return static_cast<const char*>(consts) + sizeof(NLConst<T>);
}

// Stack slots per level: the trajectory (c_rfl, c_sfl, and c_cov with
// evaporation), then with RESIDENT the folded inputs.
template <bool EVAP, bool RESIDENT>
struct ADFusedSlots {
  static constexpr int TRAJ = EVAP ? 3 : 2;
  static constexpr int ALL = TRAJ + (RESIDENT ? 10 : 0);
};

// ------------------------------------------------------------ forward body ----
// The NL step of the two-kernel AD's forward kernel on the pipelined scan
// (NLPipeBody: its level inputs copied ahead into the ring), with the
// carry entering each level pushed onto the stack instead of written out.
template <typename T, bool EVAP, bool RESIDENT, int D>
struct ADFusedFwd {
  using NL = NLPipeBody<T, true, EVAP, false, false, false, D>;
  using Column = typename NL::Column;
  static constexpr int SLOTS = ADFusedSlots<EVAP, RESIDENT>::ALL;
  static constexpr int FIELDS = NL::FIELDS;
  NL nl;
  int nlev, ncols;

  CLOUDSC2_HD Column begin(int col) const { return nl.begin(col); }

  CLOUDSC2_HD const ScalmTable<T>& level_table() const { return nl.level_table(); }

  template <class Ring>
  CLOUDSC2_HD void prefetch(Ring& r, int slot, int col, int k) const {
    nl.prefetch(r, slot, col, k);
  }

  template <class Slot, class Stack>
  CLOUDSC2_HD void level(Column& s, const Slot& r, const Stack& stack, int col, int k) const {
    const NLLevelIn<T> x = nl.fold(s, r, k);
    stack(0, k) = s.carry.rfl;
    stack(1, k) = s.carry.sfl;
    if constexpr (EVAP) stack(2, k) = s.carry.covptot;
    if constexpr (RESIDENT) {
      int j = ADFusedSlots<EVAP, RESIDENT>::TRAJ;
#define CLOUDSC2_PUSH(n) stack(j++, k) = x.n;
      CLOUDSC2_AD_FUSED_RESIDENT(CLOUDSC2_PUSH)
#undef CLOUDSC2_PUSH
    }
    const NLLevelOut<T> o = nl_level<T, true, EVAP, D>(s.carry, x, s.col, nl.c);
    nl.store(s, o, col, k);
  }
};

// ------------------------------------------------------------ reverse body ----
// The two-kernel AD's reverse body (ADBody), reading the trajectory, and
// with RESIDENT the folded inputs, from the stack.
template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
struct ADFusedRev {
  using AD = ADBody<T, EVAP, LREGCL, D>;
  using Column = typename AD::Column;
  AD ad;

  template <class FwdColumn>
  CLOUDSC2_HD Column begin(const FwdColumn& s) const {
    return ad.begin(s.col);
  }

  template <class Stack>
  CLOUDSC2_HD void level(Column& s, const Stack& stack, int col, int k) const {
    TLLevelIn<T> x = {};
    if constexpr (RESIDENT) {
      int j = ADFusedSlots<EVAP, RESIDENT>::TRAJ;
#define CLOUDSC2_POP(n) x.n = stack(j++, k);
      CLOUDSC2_AD_FUSED_RESIDENT(CLOUDSC2_POP)
#undef CLOUDSC2_POP
      x.eta = ad.f.eta[k];
      x.scalm = ad.f.scalm[k];
    } else {
      x = ad.load(col, k);
    }
    NLCarry<T> traj{stack(0, k), stack(1, k), T(0)};
    if constexpr (EVAP) traj.covptot = stack(2, k);
    ad.step(s, x, traj, col, k);
  }

  CLOUDSC2_HD void end(Column& s, int col) const { ad.end(s, col); }
};

template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D = DIV_EXACT>
struct ADFused {
  ADFusedFwd<T, EVAP, RESIDENT, D> fwd;
  ADFusedRev<T, EVAP, LREGCL, RESIDENT, D> rev;
};

// Fill both bodies from the wrapper's pointer lists (orders as in the
// X-lists); the trajectory pointers of the two-kernel bodies stay null.
template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D = DIV_EXACT>
inline ADFused<T, EVAP, LREGCL, RESIDENT, D> make_ad_fused(const void* const* in, void* const* out,
                                                           const void* nl_consts,
                                                           const void* tl_consts, int nlev,
                                                           int ncols) {
  ADFused<T, EVAP, LREGCL, RESIDENT, D> b;
  NLFields<T>& nf = b.fwd.nl.f;
  ADFields<T>& af = b.rev.ad.f;
  memset(&nf, 0, sizeof(nf));
  memset(&af, 0, sizeof(af));
  int i = 0;
#define CLOUDSC2_BOTH(n) nf.n = af.n = static_cast<const T*>(in[i++]);
#define CLOUDSC2_AD_ONLY(n) af.n = static_cast<const T*>(in[i++]);
  CLOUDSC2_AD_FUSED_RAW(CLOUDSC2_BOTH)
  CLOUDSC2_AD_FUSED_SEEDS(CLOUDSC2_AD_ONLY)
  CLOUDSC2_BOTH(eta)
#undef CLOUDSC2_BOTH
#undef CLOUDSC2_AD_ONLY
  i = 0;
#define CLOUDSC2_NL_OUT(n) nf.n = static_cast<T*>(out[i++]);
#define CLOUDSC2_AD_OUT(n) af.n = static_cast<T*>(out[i++]);
  CLOUDSC2_AD_FUSED_FWD_OUTPUTS(CLOUDSC2_NL_OUT)
  CLOUDSC2_AD_OUTPUTS(CLOUDSC2_AD_OUT)
#undef CLOUDSC2_NL_OUT
#undef CLOUDSC2_AD_OUT
  memcpy(&b.fwd.nl.c, nl_consts, sizeof(NLConst<T>));
  memcpy(&b.rev.ad.c, tl_consts, sizeof(TLConst<T>));
  nf.scalm = {nf.eta, b.fwd.nl.c.zscal, b.fwd.nl.c.zeps1};
  af.scalm = {af.eta, b.rev.ad.c.zscal, b.rev.ad.c.zeps1};
  b.fwd.nl.nlev = b.fwd.nlev = b.rev.ad.nlev = nlev;
  b.fwd.nl.ncols = b.fwd.ncols = b.rev.ad.ncols = ncols;
  return b;
}

// Call L.template run<T, EVAP, LREGCL, RESIDENT, D>() for the runtime
// switches: the 8 switch triples for each type and divide policy the
// library holds (scalar_math.h "library forms"; check forms_valid first).
template <class L, typename T, int D, bool EVAP>
inline int ad_fused_dispatch_lregcl(const L& launcher, int lregcl, int resident) {
  if (lregcl)
    return resident ? launcher.template run<T, EVAP, true, true, D>()
                    : launcher.template run<T, EVAP, true, false, D>();
  return resident ? launcher.template run<T, EVAP, false, true, D>()
                  : launcher.template run<T, EVAP, false, false, D>();
}

template <class L>
inline int ad_fused_dispatch(const L& launcher, int is_double, int evap, int lregcl, int resident,
                             int div) {
  return dispatch_type_div(is_double, div, -1, [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int D = decltype(d)::value;
    return evap ? ad_fused_dispatch_lregcl<L, T, D, true>(launcher, lregcl, resident)
                : ad_fused_dispatch_lregcl<L, T, D, false>(launcher, lregcl, resident);
  });
}

}  // namespace cloudsc2
