// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// CLOUDSC2 nonlinear step on Hopper (sm_90a): the port of the Pallas kernel
// cloudsc2_nl_pallas (cloudsc2_tpu/pallas/nonlinear.py:76) and of its
// level-scan harness level_scan_pallas (cloudsc2_tpu/pallas/levelscan.py:402).
//
// What it computes: one whole NL step for every column, including what the
// JAX wrapper does around its kernel in XLA (first-guess combines, dp, mf,
// lu_next, the tropopause search, the critical-RH coefficients) and the
// assembly of the fluxes (zero top interface, fhps* = -L * fpls*).  Only eta
// and scalm, two (nlev,) vectors, come from torch.
//
// With traj (the adjoint's forward sweep) it also writes the carry entering
// each level: c_rfl, c_sfl, and c_cov when evaporation is compiled in; with
// traj = 2 (traj_only, the forward sweep of a gradient-only adjoint) it
// writes that trajectory and nothing else.
//
// What bounds it: bytes.  Per column-level it reads the 16 input fields once
// plus t and tnd_cml_t a second time for the tropopause pass (18 reads), and
// writes 10 fields (12-13 with traj): 28 values, 112 B in f32 (224 B in f64;
// the function needs 26, each input read once), against
// roughly 300 flops (about a dozen exp, eight divides), under 3 flop/B.  An
// H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores) balances at
// about 20 flop/B, so the memory stream is the limit.
//
// What the design does about it: one thread per column keeps the carry
// (rfl, sfl, covptot) and every intermediate in registers, so nothing but
// the inputs and outputs touches device memory; fields are (nlev, ncols)
// with columns contiguous, so each warp's loads and stores at a level are
// coalesced 128 B lines; the second tropopause read of t/tnd_cml_t is the
// only redundant traffic.  The recurrence serializes levels within a
// thread, so occupancy comes from columns: 65,536 columns give 512 blocks
// of 128 threads, about four per SM.
//
// Built with --fmad=false so that the result matches the plain torch
// version (which never fuses a*b+c); never with fast math.
#include <cuda_runtime.h>

#include "nl_level.h"

namespace {

struct Launcher {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;
  cudaStream_t stream;

  template <typename T, bool THERMO, bool EVAP, bool TRAJ, bool TRAJ_ONLY>
  int run() const {
    const auto body =
        cloudsc2::make_nl_body<T, THERMO, EVAP, TRAJ, TRAJ_ONLY>(in, out, consts, nlev, ncols);
    const int threads = 128;
    const int blocks = (ncols + threads - 1) / threads;
    cloudsc2::level_scan_kernel<<<blocks, threads, 0, stream>>>(body);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_nl_signature() { return cloudsc2::nl_signature(); }

// Launch one NL step on `stream`.  traj: 0 none, 1 the trajectory too, 2
// the trajectory only.  in/out: device pointers in the order of
// CLOUDSC2_NL_INPUTS/OUTPUTS (the outputs not written may be null);
// consts: host pointer to NLConst<T>.  Returns the cudaError_t of the
// launch (0 on success).
int cloudsc2_nl_launch(int is_double, int thermo, int evap, int traj, const void* const* in,
                       void* const* out, const void* consts, int nlev, int ncols,
                       void* stream) {
  if (nlev < 1 || ncols < 1 || traj < 0 || traj > 2) return static_cast<int>(cudaErrorInvalidValue);
  const Launcher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::nl_dispatch(l, is_double, thermo, evap, traj);
}

}  // extern "C"
