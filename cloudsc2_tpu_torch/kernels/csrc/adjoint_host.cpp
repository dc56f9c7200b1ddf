// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Host build of the AD reverse kernel's body (ad_level.h through the
// reverse form of levelscan.cuh), compiled with g++ -ffp-contract=off.  The
// CPU tests run it, after the host NL body with its trajectory, against the
// plain AD, so the kernel's own arithmetic is checked on a machine without
// a card.  It is never used on the main path.
#include "ad_level.h"

namespace {

struct HostRunner {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;

  template <typename T, bool EVAP, bool LREGCL>
  int run() const {
    using Body = cloudsc2::ADBody<T, EVAP, LREGCL>;
    cloudsc2::level_scan_host<Body, true>(
        cloudsc2::make_ad_body<T, EVAP, LREGCL>(in, out, consts, nlev, ncols));
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_signature() { return cloudsc2::ad_signature(); }

// Same arguments as cloudsc2_ad_launch (adjoint.cu) with host pointers and
// no stream.
int cloudsc2_ad_host(int is_double, int evap, int lregcl, const void* const* in,
                     void* const* out, const void* consts, int nlev, int ncols) {
  if (nlev < 1 || ncols < 1) return 1;
  const HostRunner r{in, out, consts, nlev, ncols};
  return cloudsc2::ad_dispatch(r, is_double, evap, lregcl);
}

}  // extern "C"
