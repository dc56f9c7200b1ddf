// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// CLOUDSC2 nonlinear step on Hopper (sm_90a): the port of the Pallas kernel
// cloudsc2_nl_pallas (cloudsc2_tpu/pallas/nonlinear.py:76) and of its
// level-scan harness level_scan_pallas (cloudsc2_tpu/pallas/levelscan.py:402).
// A library holds one form of the saturation adjustment (CUADJ_COMPACT,
// scalar_math.h "library forms"), and in it the exact divide in float and
// double and the FAST_DIV faithful and approx policies
// (cloudsc2_tpu/physics/fastmath.py:34-78) in float:
// every divide the JAX body routes through fastmath.rcp / div becomes the
// hardware approximate reciprocal, PTX rcp.approx.ftz.f32, with one Newton
// step in faithful (scalar_math.h says how and why).  The JAX kernel divides
// non-f32 operands exactly, so a double step takes the exact policy only.
//
// What it computes: one whole NL step for every column, including what the
// JAX wrapper does around its kernel in XLA (first-guess combines, dp, mf,
// lu_next, the tropopause search, the critical-RH coefficients) and the
// assembly of the fluxes (zero top interface, fhps* = -L * fpls*).  Only eta
// and scalm, two (nlev,) vectors, come from torch.
//
// With fuse (fuse_saturation, pallas/nonlinear.py:105-110) it diagnoses qsat
// from ap and t at each point instead of reading it, and writes it: the
// Saturation component and the NL step in one launch.  With traj (the
// adjoint's forward sweep) it also writes the carry entering each level:
// c_rfl, c_sfl, and c_cov when evaporation is compiled in; with traj = 2
// (traj_only, the forward sweep of a gradient-only adjoint) it writes that
// trajectory and nothing else.
//
// What bounds it: bytes.  Per column-level it reads the 16 input fields once
// plus t and tnd_cml_t a second time for the tropopause pass (18 reads), and
// writes 10 fields (12-13 with traj): 28 values, 112 B in f32 (224 B in f64;
// the function needs 26, each input read once), against
// roughly 300 flops (about a dozen exp, eight divides), under 3 flop/B.  An
// H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores) balances at
// about 20 flop/B, so the memory stream is the limit.  Fused, it reads qsat
// no more and writes it: the same 26 values, and the Saturation
// component's own passes over memory (about 20 elementwise launches) are
// gone.  The divide policy changes the cost of about 25 divides a
// column-level, not a byte.
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

extern "C" {

const char* cloudsc2_nl_signature() { return cloudsc2::nl_signature(); }

// Launch one NL step on `stream`.  Switches in the order of
// CLOUDSC2_NL_SWITCHES (nl_level.h); div is 0 (exact), 1 (faithful) or 2
// (approx), and 0 when is_double; compact must be the library's form
// (CLOUDSC2_COMPACT, scalar_math.h).  in/out: device pointers in the order of
// CLOUDSC2_NL_INPUTS/OUTPUTS (those not read or written may be null);
// consts: host pointer to NLConst<T>.  Returns the cudaError_t of the launch
// (0 on success).
int cloudsc2_nl_launch(int is_double, int thermo, int evap, int traj, int fuse, int div, int compact,
                       const void* const* in, void* const* out, const void* consts, int nlev,
                       int ncols, void* stream) {
  if (!cloudsc2::nl_switches_valid(nlev, ncols, is_double, traj, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const cloudsc2::NLLauncher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::nl_dispatch(l, is_double, thermo, evap, traj, fuse, div);
}

// rcp<div>(x[i]) into r[i] for i < n, on `stream`: the divide policies'
// reciprocal on its own, for the checks of chip_smoke.py and the card
// tests (never on the main path).  Returns the launch's cudaError_t.
int cloudsc2_rcp_probe(int div, const float* x, float* r, int n, void* stream) {
  if (n < 1 || div < cloudsc2::DIV_EXACT || div > cloudsc2::DIV_APPROX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (div == cloudsc2::DIV_FAITHFUL)
    cloudsc2::rcp_probe_kernel<cloudsc2::DIV_FAITHFUL><<<blocks, threads, 0, s>>>(x, r, n);
  else if (div == cloudsc2::DIV_APPROX)
    cloudsc2::rcp_probe_kernel<cloudsc2::DIV_APPROX><<<blocks, threads, 0, s>>>(x, r, n);
  else
    cloudsc2::rcp_probe_kernel<cloudsc2::DIV_EXACT><<<blocks, threads, 0, s>>>(x, r, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
