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
// around the stored carry (ad_level.h: 12 or 14 Jacobian columns of
// tl_level).  It also does what the JAX wrapper does around its kernel in
// XLA: the folds of the raw fields (dp, q2, the first guesses, mf, lu_next,
// the tropopause and critical-RH coefficients), the fold of the flux seeds
// (s_fpls = fpls_i[k+1] - L * fhps_i[k+1]), and the assembly of the 16
// input cotangents (aph_i from cot_dp and the column sum of the surface
// cotangent, lu_i shifted one level, mfu_i = mfd_i, q_i = supsat_i, cml_*_i
// = dt * cot_*_fg).
//
// What bounds it: bytes.  Per column-level it must read the 16 raw fields,
// 9 seeds (10 with evaporation) and 2 trajectory values (3), and write 16:
// 43 values, 1.55 GB in f32 at 65,536 x 137, an HBM floor of 0.46 ms at
// 3.35 TB/s (0.92 ms in f64).  This code reads t and tnd_cml_t a second
// time, for the tropopause pass (45 values).  The reverse level needs about one NL level and one transposed
// TL level of arithmetic, some 1,060 flops per column-level: 0.14 ms at
// 67 TFLOP/s in f32 (0.28 ms at 34 in f64), below the byte floor.  This
// design does more: it runs the TL level 12-14 times per level, each some
// 700 flops with about 15 exp, a tanh, two pow and 30 divides, roughly
// 10,000 flops per column-level, far above the card's balance point of
// about 20 flop/B, so its own operations, not the bound, set its time.
//
// What the design does about it: correctness first.  The Jacobian-column
// transpose reuses the bitwise-checked tl_level instead of hand-transposed
// code; the direction loop is kept rolled (#pragma unroll 1) so the level
// body is compiled once and the registers stay those of one TL level plus
// the 14 accumulators.  Everything but the inputs and outputs stays in
// registers, loads and stores are coalesced (columns contiguous).  The fast
// form, a hand transpose of tl_level.h that costs about one TL level per
// level, is queued.
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

  template <typename T, bool EVAP, bool LREGCL>
  int run() const {
    using Body = cloudsc2::ADBody<T, EVAP, LREGCL>;
    const Body body = cloudsc2::make_ad_body<T, EVAP, LREGCL>(in, out, consts, nlev, ncols);
    const int threads = 128;
    const int blocks = (ncols + threads - 1) / threads;
    cloudsc2::level_scan_kernel<Body, true><<<blocks, threads, 0, stream>>>(body);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_signature() { return cloudsc2::ad_signature(); }

// Launch the reverse sweep of one AD step on `stream`.  in/out: device
// pointers in the order of CLOUDSC2_AD_INPUTS/OUTPUTS (c_cov and covptot_i
// may be null without evap); consts: host pointer to TLConst<T>.  Returns
// the cudaError_t of the launch (0 on success).
int cloudsc2_ad_launch(int is_double, int evap, int lregcl, const void* const* in,
                       void* const* out, const void* consts, int nlev, int ncols,
                       void* stream) {
  if (nlev < 1 || ncols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Launcher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::ad_dispatch(l, is_double, evap, lregcl);
}

}  // extern "C"
