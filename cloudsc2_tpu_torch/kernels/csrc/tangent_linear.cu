// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// CLOUDSC2 tangent-linear step on Hopper (sm_90a): the port of the Pallas
// kernel cloudsc2_tl_pallas (cloudsc2_tpu/pallas/tangent_linear.py:69) on
// the level-scan harness (levelscan.cuh).
//
// What it computes: one whole TL step for every column -- the forward
// recompute and the perturbation of every intermediate -- including what
// the JAX wrapper does around its kernel in XLA: the seven first-guess
// combines for values and perturbations, dp/dp_i, mf/mf_i, lu_next/lu_next_i
// (zero at the bottom), aph_s/aph_s_i, the tropopause search on t_fg, the
// critical-RH coefficients, the zero top interface of the four fluxes,
// fhps* = -L fpls* for values and perturbations, and zero covptot/covptot_i
// when evaporation is compiled out, and scalm from eta, which each block
// derives once into shared memory (levelscan.cuh "level table", nl_level.h
// ScalmTable).  Only eta, one (nlev,) vector, comes from torch.  With tangent_only it writes only the *_i
// outputs (the forward recompute still runs: it feeds the linearization).
//
// What bounds it: bytes, and registers.  Per column-level it reads the 16
// fields and their 16 perturbations once (aph and aph_i have nlev+1 rows)
// plus t and tnd_cml_t a second time for the tropopause pass: 34 reads.
// It writes 20 outputs (8 tendencies, then clc, covptot, fplsl, fplsn,
// fhpsl, fhpsn, each with its _i), 10 with tangent_only.  That is 54
// values, 216 B per column-level in f32 and 432 B in f64; the function
// needs 52 (each input read once): 1.87 GB in f32 at 65,536 x 137, an HBM
// floor of 0.56 ms at 3.35 TB/s (1.12 ms in f64).
// The arithmetic, about 700 flops with some 15 exp, a tanh, two pow and
// 30 divides, stays below the card's balance point of about 20 flop/B.
// The TL carries six values and keeps about twice the NL body's live
// intermediates, so registers are the risk: ptxas's registers and spills
// for each instantiation are printed by chip_smoke.py's build phase.
//
// What the design does about it: as the NL kernel, one thread per column
// keeps the carry and every intermediate in registers, so only the inputs
// and outputs touch device memory; fields are (nlev, ncols) with columns
// contiguous, so each warp's loads and stores at a level are coalesced;
// the second tropopause read is the only redundant traffic.  Making it
// fast (fewer live values, occupancy) is later work.
//
// A library holds one form of the saturation adjustment and a set of
// divide policies (scalar_math.h "library forms"): the default library the
// compact form and the exact divide, built apart from the FAST_DIV and the
// CUADJ_COMPACT=False forms so that its bodies do not change.
//
// Built with --fmad=false so that the result matches the plain torch
// version (which never fuses a*b+c); never with fast math.
#include <cuda_runtime.h>

#include "tl_level.h"

namespace {

struct Launcher {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;
  cudaStream_t stream;

  template <typename T, bool EVAP, bool LREGCL, bool TANGENT_ONLY, int D>
  int run() const {
    using Body = cloudsc2::TLBody<T, EVAP, LREGCL, TANGENT_ONLY, D>;
    const Body body = cloudsc2::make_tl_body<T, EVAP, LREGCL, TANGENT_ONLY, D>(in, out, consts, nlev, ncols);
    const int threads = 128;
    const int blocks = (ncols + threads - 1) / threads;
    const size_t shared = cloudsc2::level_table_bytes<T>(nlev);  // the level table
    const cudaError_t err = cloudsc2::allow_dynamic_shared(&cloudsc2::level_scan_kernel<Body>, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    cloudsc2::level_scan_kernel<Body><<<blocks, threads, shared, stream>>>(body);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_tl_signature() { return cloudsc2::tl_signature(); }

// Launch one TL step on `stream`.  div is 0 (exact), 1 (faithful) or 2
// (approx), and compact CUADJ_COMPACT: a form the library holds
// (scalar_math.h "library forms").  in/out: device pointers in the order of
// CLOUDSC2_TL_INPUTS/OUTPUTS (the first ten outputs may be null with
// tangent_only); consts: host pointer to TLConst<T>.  Returns the
// cudaError_t of the launch (0 on success).
int cloudsc2_tl_launch(int is_double, int evap, int lregcl, int tangent_only, int div, int compact,
                       const void* const* in, void* const* out, const void* consts, int nlev,
                       int ncols, void* stream) {
  if (nlev < 1 || ncols < 1 || !cloudsc2::forms_valid(is_double, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launcher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::tl_dispatch(l, is_double, evap, lregcl, tangent_only, div);
}

}  // extern "C"
