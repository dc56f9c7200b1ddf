// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Host build of the NL kernel's body (nl_level.h through the pipelined scan
// of levelscan.cuh, and through its direct scan for reference),
// every divide policy (the approximate reciprocal as Pallas interpret mode
// models it, scalar_math.h rcp_approx), compiled with g++
// -ffp-contract=off.  The CPU tests run it against the plain torch version
// and against cloudsc2_nl_pallas in interpret mode, so the kernel's own
// arithmetic is checked on a machine without a card.  It is never used on
// the main path.
#include "nl_level.h"

extern "C" {

const char* cloudsc2_nl_signature() { return cloudsc2::nl_signature(); }

// Same arguments as cloudsc2_nl_launch (nonlinear.cu) with host pointers
// and no stream, through the pipelined scan the card runs (its ring of
// cloudsc2_nl_ring_depth slots; the shared-memory ring's copies modelled
// as landing at their wait); returns 0 on success.
int cloudsc2_nl_host(int is_double, int thermo, int evap, int traj, int fuse, int div, int compact,
                     const void* const* in, void* const* out, const void* consts, int nlev, int ncols) {
  if (!cloudsc2::nl_switches_valid(nlev, ncols, is_double, traj, div, compact)) return 1;
  const cloudsc2::NLHostRunner<false> r{in, out, consts, nlev, ncols};
  return cloudsc2::nl_dispatch(r, is_double, thermo, evap, traj, fuse, div);
}

// The same through the direct scan (level_scan_host of NLBody: each
// level's loads, then its arithmetic, then its stores), the reference of
// the pipelined scan in the CPU tests.
int cloudsc2_nl_direct_host(int is_double, int thermo, int evap, int traj, int fuse, int div, int compact,
                            const void* const* in, void* const* out, const void* consts, int nlev,
                            int ncols) {
  if (!cloudsc2::nl_switches_valid(nlev, ncols, is_double, traj, div, compact)) return 1;
  const cloudsc2::NLHostRunner<true> r{in, out, consts, nlev, ncols};
  return cloudsc2::nl_dispatch(r, is_double, thermo, evap, traj, fuse, div);
}

// The ring's depth for float (is_double 0) or double (1), the card's.
int cloudsc2_nl_ring_depth(int is_double) {
  return is_double ? cloudsc2::NLRing<double>::DEPTH : cloudsc2::NLRing<float>::DEPTH;
}

// The blocks an SM that the card's float launch sizes its shared-memory
// carveout for (nl_level.h nl_carveout_blocks), for the CPU tests of the
// rule; -1 where an argument is out of range.
int cloudsc2_nl_carveout_blocks(int register_blocks, int shared_bytes, int in_flight_bytes, int grid_blocks,
                                int sms) {
  if (register_blocks < 1 || shared_bytes < 0 || in_flight_bytes < 0 || grid_blocks < 1 || sms < 1) return -1;
  return cloudsc2::nl_carveout_blocks(register_blocks, static_cast<size_t>(shared_bytes),
                                      static_cast<size_t>(in_flight_bytes), grid_blocks, sms);
}

// As cloudsc2_rcp_probe (nonlinear.cu) on host pointers; returns 0 on
// success.
int cloudsc2_rcp_probe_host(int div, const float* x, float* r, int n) {
  if (n < 1 || div < cloudsc2::DIV_EXACT || div > cloudsc2::DIV_APPROX) return 1;
  for (int i = 0; i < n; ++i)
    r[i] = div == cloudsc2::DIV_FAITHFUL ? cloudsc2::rcp<cloudsc2::DIV_FAITHFUL>(x[i])
         : div == cloudsc2::DIV_APPROX   ? cloudsc2::rcp<cloudsc2::DIV_APPROX>(x[i])
                                         : cloudsc2::rcp<cloudsc2::DIV_EXACT>(x[i]);
  return 0;
}

// As cloudsc2_scalm_probe (nonlinear.cu) on host pointers; returns 0 on
// success.
int cloudsc2_scalm_probe_host(int is_double, const void* eta, void* scalm, int n, const void* consts) {
  if (n < 1) return 1;
  if (is_double) {
    const double* z = static_cast<const double*>(consts);
    const cloudsc2::ScalmTable<double> table{static_cast<const double*>(eta), z[0], z[1]};
    for (int i = 0; i < n; ++i) static_cast<double*>(scalm)[i] = table.derive(i);
  } else {
    const float* z = static_cast<const float*>(consts);
    const cloudsc2::ScalmTable<float> table{static_cast<const float*>(eta), z[0], z[1]};
    for (int i = 0; i < n; ++i) static_cast<float*>(scalm)[i] = table.derive(i);
  }
  return 0;
}

}  // extern "C"
