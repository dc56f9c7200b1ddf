// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// CLOUDSC2 adjoint step on Hopper (sm_90a), reverse kernel: the port of the
// Pallas kernel cloudsc2_ad_pallas (cloudsc2_tpu/pallas/adjoint.py:125) on
// the reverse form of the level-scan harness (levelscan.cuh, REVERSE; the
// port of level_scan_pallas(reverse=True), pallas/levelscan.py:402).
//
// What it computes: as the Pallas AD, two kernels.  The forward sweep is
// the NL kernel with its trajectory (nonlinear.cu, traj): the NL outputs
// and the carry entering each level.  This kernel is the reverse sweep:
// one thread per column runs the levels bottom-up with the carry cotangents
// in registers, and at each level applies the transpose of the TL level
// around the stored carry (ad_level.h: tl_level transposed by hand, one
// primal pass and one adjoint pass, as the Pallas kernel's jax.vjp of
// tl_level sweeps once).  It also does what the JAX wrapper does around its
// kernel in XLA: the folds of the raw fields (dp, q2, the first guesses,
// mf, lu_next, the tropopause and critical-RH coefficients), the fold of
// the flux seeds (s_fpls = fpls_i[k+1] - L * fhps_i[k+1]), and the assembly
// of the 16 input cotangents (aph_i from cot_dp and the column sum of the
// surface cotangent, lu_i shifted one level, mfu_i = mfd_i, q_i = supsat_i,
// cml_*_i = dt * cot_*_fg).
//
// What bounds it: bytes.  Per column-level it must read the 16 raw fields,
// 9 seeds (10 with evaporation) and 2 trajectory values (3), and write 16:
// 43 values, 1.55 GB in f32 at 65,536 x 137, an HBM floor of 0.46 ms at
// 3.35 TB/s (0.92 ms in f64).  This code reads t and tnd_cml_t a second
// time, for the tropopause pass (45 values).  The function's arithmetic,
// one NL level and one transposed TL level, is some 1,060 flops per
// column-level (0.14 ms at 67 TFLOP/s in f32, 0.28 ms at 34 in f64); the
// hand transpose does about 700 (860 with evaporation), recomputing the
// level's forward values itself, below the byte floor.
//
// What the design does about it: everything but the inputs and outputs
// stays in registers, one reverse sweep per level, loads and stores
// coalesced (columns contiguous).  Its cost is registers: the primal values
// the adjoint reads are live through it, 128 a thread in f32 (4 blocks of
// 128 per SM) and 244-246 in f64 (2 blocks), no spill without evaporation.
// On an H100 at 65,536 x 137 it runs at about 0.6 of the byte floor
// (PERF.md); fewer registers, or the next level's loads issued before this
// level's arithmetic, are what is left.
//
// A library holds one form of the saturation adjustment and a set of
// divide policies (scalar_math.h "library forms"): the default library the
// compact form and the exact divide; the others are built apart, so that
// the default instantiations keep their registers.
//
// Built with --fmad=false, as the NL and TL kernels; never with fast math.
#include <cuda_runtime.h>

#include "ad_level.h"

namespace {

struct Launcher {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;
  cudaStream_t stream;

  template <typename T, bool EVAP, bool LREGCL, int D>
  int run() const {
    using Body = cloudsc2::ADBody<T, EVAP, LREGCL, D>;
    const Body body = cloudsc2::make_ad_body<T, EVAP, LREGCL, D>(in, out, consts, nlev, ncols);
    const int threads = 128;
    const int blocks = (ncols + threads - 1) / threads;
    cloudsc2::level_scan_kernel<Body, true><<<blocks, threads, 0, stream>>>(body);
    return static_cast<int>(cudaGetLastError());
  }
};

// What the card makes of one instantiation: registers a thread, local
// (spill) bytes a thread.
struct Attributes {
  int* out;

  template <typename T, bool EVAP, bool LREGCL, int D>
  int run() const {
    const auto fn = &cloudsc2::level_scan_kernel<cloudsc2::ADBody<T, EVAP, LREGCL, D>, true>;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_signature() { return cloudsc2::ad_signature(); }

// Launch the reverse sweep of one AD step on `stream`.  div (a DivMode)
// and compact (CUADJ_COMPACT): a form the library holds (scalar_math.h
// "library forms").  in/out: device pointers in the order of
// CLOUDSC2_AD_INPUTS/OUTPUTS (c_cov and covptot_i may be null without
// evap); consts: host pointer to TLConst<T>.  Returns the cudaError_t of
// the launch (0 on success).
int cloudsc2_ad_launch(int is_double, int evap, int lregcl, int div, int compact,
                       const void* const* in, void* const* out, const void* consts, int nlev,
                       int ncols, void* stream) {
  if (nlev < 1 || ncols < 1 || !cloudsc2::forms_valid(is_double, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launcher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::ad_dispatch(l, is_double, evap, lregcl, div);
}

// Fill out[0..1] for the instantiation: registers a thread and local bytes
// a thread (cudaFuncGetAttributes).  Returns a cudaError_t.
int cloudsc2_ad_attributes(int is_double, int evap, int lregcl, int div, int compact, int* out) {
  if (!cloudsc2::forms_valid(is_double, div, compact)) return static_cast<int>(cudaErrorInvalidValue);
  const Attributes a{out};
  return cloudsc2::ad_dispatch(a, is_double, evap, lregcl, div);
}

}  // extern "C"
