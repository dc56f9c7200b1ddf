// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Host build of the NL kernel's body (nl_level.h through levelscan.cuh),
// compiled with g++ -ffp-contract=off.  The CPU tests run it against the
// plain torch version, so the kernel's own arithmetic is checked on a
// machine without a card.  It is never used on the main path.
#include "nl_level.h"

namespace {

struct HostRunner {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;

  template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY>
  int run() const {
    cloudsc2::level_scan_host(
        cloudsc2::make_nl_body<T, THERMO, EVAP, TRAJ, TRAJ_ONLY>(in, out, consts, nlev, ncols));
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_nl_signature() { return cloudsc2::nl_signature(); }

// Same arguments as cloudsc2_nl_launch (nonlinear.cu) with host pointers
// and no stream.
int cloudsc2_nl_host(int is_double, int thermo, int evap, int traj, const void* const* in,
                     void* const* out, const void* consts, int nlev, int ncols) {
  if (nlev < 1 || ncols < 1 || traj < 0 || traj > 2) return 1;
  const HostRunner r{in, out, consts, nlev, ncols};
  return cloudsc2::nl_dispatch(r, is_double, thermo, evap, traj);
}

}  // extern "C"
