// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Host build of the fused AD kernel's bodies (ad_fused.h through the fused
// form of levelscan.cuh, on the kernel's scratch layout and index function,
// every column's forward sweep before any reverse sweep, the forward
// sweep's ring modelled as the NL kernel's host build models it), compiled
// with g++ -ffp-contract=off.  The CPU tests hold it bitwise against the
// host build of the two-kernel AD and against the JAX package, so the
// kernel's own arithmetic and stack discipline are checked on a machine
// without a card.  It is never used on the main path.
#include "ad_fused.h"

namespace {

struct HostRunner {
  const void* const* in;
  void* const* out;
  void* scratch;
  const void* nl_consts;
  const void* tl_consts;
  int nlev, ncols;

  template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
  int run() const {
    const auto b = cloudsc2::make_ad_fused<T, EVAP, LREGCL, RESIDENT, D>(in, out, nl_consts, tl_consts,
                                                                         nlev, ncols);
    using Ring = cloudsc2::NLRing<T>;
    cloudsc2::level_scan_fwdrev_host<Ring::DEPTH, Ring::SHARED>(b.fwd, b.rev, static_cast<T*>(scratch));
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_fused_signature() { return cloudsc2::ad_fused_signature(); }

// Same arguments as cloudsc2_ad_fused_launch (ad_fused.cu) with host
// pointers and no stream.
int cloudsc2_ad_fused_host(int is_double, int evap, int lregcl, int resident, int div, int compact,
                           const void* const* in, void* const* out, void* scratch, const void* nl_consts,
                           const void* tl_consts, int nlev, int ncols) {
  if (nlev < 1 || ncols < 1 || scratch == nullptr || !cloudsc2::forms_valid(is_double, div, compact)) return 1;
  const HostRunner r{in, out, scratch, nl_consts, tl_consts, nlev, ncols};
  return cloudsc2::ad_fused_dispatch(r, is_double, evap, lregcl, resident, div);
}

}  // extern "C"
