// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// CLOUDSC2 adjoint step on Hopper (sm_90a) in one kernel: the port of the
// Pallas kernel cloudsc2_ad_pallas_fused (cloudsc2_tpu/pallas/adjoint.py:432)
// on the fused form of the level-scan harness (levelscan.cuh,
// level_scan_fwdrev_kernel; the port of level_scan_fwdrev_pallas,
// pallas/levelscan.py:87).
//
// What it computes: what the two-kernel AD (nonlinear.cu with its
// trajectory, then adjoint.cu) computes, the NL step's 10 outputs and the
// 16 input cotangents, in one launch.  One thread owns one column: it runs
// the NL levels top down, pushing the carry entering each level onto a
// stack in shared memory, then the transposed TL levels (ad_level.h) bottom
// up, popping it.  The trajectory never goes to device memory.  With
// resident the forward sweep also pushes the ten folded level inputs and
// the reverse sweep reads them back instead of the 16 raw fields.
//
// What bounds it: the function's bytes.  It must read the 16 input fields
// and 9 seeds (10 with evaporation) and write 10 NL outputs and 16
// cotangents: 51 values per column-level, 1.83 GB in f32 at 65,536 x 137,
// 0.55 ms at 3.35 TB/s (1.09 ms in f64), against about 1,420 flops of one
// NL level and one transposed TL level (0.19 ms at 67 TFLOP/s f32).  This
// design moves more: the tropopause pass reads t and tnd_cml_t twice, and
// the rolled form reads the 16 raw fields again in the reverse sweep (69-70
// values; resident 53-54).  Its reverse level is adjoint.cu's, the hand
// transpose of ad_level.h (about 700 flops, 860 with evaporation).
//
// What the design does about it, and what it costs: the stack is the
// price.  It takes 2-3 values per level per thread (12-13 resident): at 137
// levels 1,096-1,644 B a thread in f32 (6,576-7,124 resident), twice that
// in f64.  An SM holds 233,472 B of shared memory, 1,024 B of it reserved
// for each resident block, and a block at most 232,448 B, so the wrapper
// launches, of 128, 64, 32 and 16 threads, the block that keeps the most
// threads resident on an SM: kernels/adjoint.py fused_plan counts what the
// stacks allow and raises if not even 16 threads fit, fused_occupancy asks
// the card (cloudsc2_ad_fused_occupancy below), registers included.
// At 137 levels with the default switches that is 3 blocks of 64 threads
// in f32 (192 a SM) and 3 of 32 in f64 (96); with evaporation one block of
// 128 and of 64, resident one of 32 and of 16.  The kernel's time follows
// its threads per SM: each thread waits on its own chain of loads and
// divides, and at these counts few warps hide each other's latency.  The
// stack is indexed [slot][level][thread], so at a level a warp touches
// consecutive words.
//
// A library holds one form of the saturation adjustment and a set of
// divide policies (scalar_math.h "library forms"), as adjoint.cu.
//
// Built with --fmad=false, as the other kernels; never with fast math.
#include <cuda_runtime.h>

#include "ad_fused.h"

namespace {

// The largest block the wrapper launches (kernels/adjoint.py FUSED_BLOCKS),
// and the kernel's launch bounds: one instantiation serves every block
// size.  The stacks hold at most 192 threads on an SM at 137 levels, where
// even 255 registers a thread (48,960) leave the register file unbound, so
// the bounds ask for no minimum of blocks.
constexpr int kMaxThreads = 128;
// Dynamic shared memory a block may opt in to on sm_90.
constexpr size_t kMaxSharedBytes = 232448;

template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
struct Kernel {
  using B = cloudsc2::ADFused<T, EVAP, LREGCL, RESIDENT, D>;
  using Fwd = decltype(B::fwd);
  using Rev = decltype(B::rev);
  using Fn = void (*)(const Fwd, const Rev);
  static Fn fn() { return &cloudsc2::level_scan_fwdrev_kernel<Fwd, Rev, T, kMaxThreads>; }

  static size_t stack_bytes(int nlev, int block) {
    return static_cast<size_t>(Fwd::SLOTS) * static_cast<size_t>(nlev) *
           static_cast<size_t>(block) * sizeof(T);
  }

  // Opt the kernel in to `bytes` of dynamic shared memory, and to the
  // largest shared-memory carveout, so that an SM holds as many blocks as
  // their stacks allow.
  static cudaError_t prepare(int nlev, int block, size_t* bytes) {
    if (block < 1 || block > kMaxThreads) return cudaErrorInvalidValue;
    *bytes = stack_bytes(nlev, block);
    if (*bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*bytes));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(fn(), cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }
};

struct Launcher {
  const void* const* in;
  void* const* out;
  const void* nl_consts;
  const void* tl_consts;
  int nlev, ncols, block;
  cudaStream_t stream;

  template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
  int run() const {
    using K = Kernel<T, EVAP, LREGCL, RESIDENT, D>;
    size_t bytes = 0;
    const cudaError_t err = K::prepare(nlev, block, &bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto b = cloudsc2::make_ad_fused<T, EVAP, LREGCL, RESIDENT, D>(in, out, nl_consts, tl_consts,
                                                                         nlev, ncols);
    const int blocks = (ncols + block - 1) / block;
    cloudsc2::level_scan_fwdrev_kernel<typename K::Fwd, typename K::Rev, T, kMaxThreads>
        <<<blocks, block, bytes, stream>>>(b.fwd, b.rev);
    return static_cast<int>(cudaGetLastError());
  }
};

// What the card makes of one instantiation at a block size: blocks per SM,
// registers a thread, local (spill) bytes a thread, shared bytes a block.
struct Query {
  int nlev, block;
  int* out;

  template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
  int run() const {
    using K = Kernel<T, EVAP, LREGCL, RESIDENT, D>;
    size_t bytes = 0;
    cudaError_t err = K::prepare(nlev, block, &bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K::fn(), block, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, K::fn());
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = per_sm;
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = static_cast<int>(bytes);
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_fused_signature() { return cloudsc2::ad_fused_signature(); }

// Launch one fused AD step on `stream` with `block` threads a block.  div
// (a DivMode) and compact (CUADJ_COMPACT): a form the library holds
// (scalar_math.h "library forms").  in/out: device pointers in the order of CLOUDSC2_AD_FUSED_INPUTS/OUTPUTS
// (covptot_i may be null without evap); nl_consts, tl_consts: host pointers
// to NLConst<T> and TLConst<T>.  Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue when the stack does not fit the block).
int cloudsc2_ad_fused_launch(int is_double, int evap, int lregcl, int resident, int div, int compact,
                             int block, const void* const* in, void* const* out,
                             const void* nl_consts, const void* tl_consts, int nlev, int ncols,
                             void* stream) {
  if (nlev < 1 || ncols < 1 || !cloudsc2::forms_valid(is_double, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launcher l{in, out, nl_consts, tl_consts, nlev, ncols, block,
                   static_cast<cudaStream_t>(stream)};
  return cloudsc2::ad_fused_dispatch(l, is_double, evap, lregcl, resident, div);
}

// Fill out[0..3] for the instantiation and block size: blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread, local
// bytes a thread, dynamic shared bytes a block.  Returns a cudaError_t.
int cloudsc2_ad_fused_occupancy(int is_double, int evap, int lregcl, int resident, int div,
                                int compact, int block, int nlev, int* out) {
  if (nlev < 1 || !cloudsc2::forms_valid(is_double, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const Query q{nlev, block, out};
  return cloudsc2::ad_fused_dispatch(q, is_double, evap, lregcl, resident, div);
}

}  // extern "C"
