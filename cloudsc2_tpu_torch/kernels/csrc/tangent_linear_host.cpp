// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Host build of the TL kernel's body (tl_level.h through levelscan.cuh),
// compiled with g++ -ffp-contract=off.  The CPU tests run it against the
// plain torch version, so the kernel's own arithmetic is checked on a
// machine without a card.  It is never used on the main path.
#include "tl_level.h"

namespace {

struct HostRunner {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;

  template <typename T, bool EVAP, bool LREGCL, bool TANGENT_ONLY, int D>
  int run() const {
    cloudsc2::level_scan_host(
        cloudsc2::make_tl_body<T, EVAP, LREGCL, TANGENT_ONLY, D>(in, out, consts, nlev, ncols));
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_tl_signature() { return cloudsc2::tl_signature(); }

// Same arguments as cloudsc2_tl_launch (tangent_linear.cu) with host
// pointers and no stream.
int cloudsc2_tl_host(int is_double, int evap, int lregcl, int tangent_only, int div, int compact,
                     const void* const* in, void* const* out, const void* consts, int nlev,
                     int ncols) {
  if (nlev < 1 || ncols < 1 || !cloudsc2::forms_valid(is_double, div, compact)) return 1;
  const HostRunner r{in, out, consts, nlev, ncols};
  return cloudsc2::tl_dispatch(r, is_double, evap, lregcl, tangent_only, div);
}

}  // extern "C"
