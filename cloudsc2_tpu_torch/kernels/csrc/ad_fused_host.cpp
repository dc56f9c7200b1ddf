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
#include <math.h>

#include "ad_fused.h"

namespace {

struct HostRunner {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;

  template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
  int run() const {
    const auto b = cloudsc2::make_ad_fused<T, EVAP, LREGCL, RESIDENT, D>(
        in, out, consts, cloudsc2::fused_tl_consts<T>(consts), nlev, ncols);
    // NaN before the sweeps, so that a value read before it is written shows
    T* const scratch = static_cast<T*>(out[cloudsc2::AD_FUSED_SCRATCH]);
    const size_t values = static_cast<size_t>(cloudsc2::ADFusedSlots<EVAP, RESIDENT>::ALL) * nlev * ncols;
    for (size_t i = 0; i < values; ++i) scratch[i] = static_cast<T>(NAN);
    using Ring = cloudsc2::NLRing<T>;
    cloudsc2::level_scan_fwdrev_host<Ring::DEPTH, Ring::SHARED>(b.fwd, b.rev, scratch);
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_fused_signature() { return cloudsc2::ad_fused_signature(); }

// Same arguments as cloudsc2_ad_fused_launch (ad_fused.cu) with host
// pointers and no stream; the scratch is filled with NaN first.
int cloudsc2_ad_fused_host(int is_double, int evap, int lregcl, int resident, int div, int compact,
                           const void* const* in, void* const* out, const void* consts, int nlev, int ncols) {
  if (nlev < 1 || ncols < 1 || out[cloudsc2::AD_FUSED_SCRATCH] == nullptr ||
      !cloudsc2::forms_valid(is_double, div, compact))
    return 1;
  const HostRunner r{in, out, consts, nlev, ncols};
  return cloudsc2::ad_fused_dispatch(r, is_double, evap, lregcl, resident, div);
}

}  // extern "C"
