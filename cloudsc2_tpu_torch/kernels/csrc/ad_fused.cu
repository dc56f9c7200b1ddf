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
// the NL levels top down on the NL kernel's pipelined scan, pushing the
// carry entering each level onto a stack, then the transposed TL levels
// (ad_level.h) bottom up, popping it.
// With resident the forward sweep also pushes the ten folded level inputs
// and the reverse sweep reads them back instead of the 16 raw fields.
//
// What bounds it: the function's bytes.  It must read the 16 input fields
// and 9 seeds (10 with evaporation) and write 10 NL outputs and 16
// cotangents: 51 values per column-level, 1.83 GB in f32 at 65,536 x 137,
// 0.55 ms at 3.35 TB/s (1.09 ms in f64), against about 1,420 flops of one
// NL level and one transposed TL level (0.19 ms at 67 TFLOP/s f32).  This
// design moves more: the tropopause pass reads t and tnd_cml_t twice, the
// rolled form reads the 16 raw fields again in the reverse sweep, and the
// stack costs each of its values a write and a read: rolled 73-76 values
// a column-level, resident 77-80 (it pushes 10 folded values instead of
// re-reading 16 raw ones).  Its reverse level is adjoint.cu's, the hand
// transpose of ad_level.h (about 700 flops, 860 with evaporation).
//
// What the design does about it: each thread waits on its own chain of
// loads and divides, so the kernel needs many warps an SM to hide them.
// The stack (2-3 values a level, 12-13 resident) lives in a scratch in
// device memory, the entry's last output, fresh for each call (levelscan.cuh
// ScratchStack, [slot][level][column]), not in shared memory: there it
// held an SM to 192 / 96 threads (f32 / f64; resident 32 / 16), and now
// the registers set the count.  Blocks of 128 threads; the launch bounds
// hold the default switches to 128 registers in f32 (4 blocks, 512
// threads an SM, so 65,536 columns run in one wave) and to 255 in f64 (2
// blocks); kernels/adjoint.py fused_plan counts the blocks an SM holds at
// the card's registers, and fused_occupancy holds the card to it.  The
// forward sweep runs the NL kernel's pipelined scan with its ring
// (nl_level.h NLRing: f32 three slots in shared memory, 24 KB a block,
// which leaves the blocks to the registers; f64 two in registers), so the
// next levels' loads are in flight while a level runs.  Chosen on an H100
// over a stack kept partly in shared memory (the top levels that the
// registers' blocks leave room for) and over the direct forward scan, by
// an A/B of the three with drivers/kernel_ab_torch.py (PERF.md section 6).
//
// A library holds one form of the saturation adjustment and a set of
// divide policies (scalar_math.h "library forms"), as adjoint.cu.
//
// Built with --fmad=false, as the other kernels; never with fast math.
#include <cuda_runtime.h>

#include "ad_fused.h"

namespace {

// Threads a block (kernels/adjoint.py FUSED_BLOCK).
constexpr int kBlock = 128;

// Blocks of kBlock an SM that the launch bounds ask for: 4 in float (128
// registers) and 2 in double (255) hold the default switches' registers
// without a spill; with evaporation or a non-exact divide the float
// bodies take up to 163 registers, and 3 blocks (168) leave them as they are.
template <typename T, bool EVAP, int D>
constexpr int min_blocks() {
  return sizeof(T) == 8 ? 2 : (!EVAP && D == cloudsc2::DIV_EXACT) ? 4 : 3;
}

template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
struct Kernel {
  using B = cloudsc2::ADFused<T, EVAP, LREGCL, RESIDENT, D>;
  using Fwd = decltype(B::fwd);
  using Rev = decltype(B::rev);
  using Ring = cloudsc2::NLRing<T>;
  static constexpr int MIN_BLOCKS = min_blocks<T, EVAP, D>();
  // the forward sweep's ring in shared memory, where the type keeps it there
  static constexpr size_t RING_BYTES = Ring::SHARED ? size_t(Ring::DEPTH) * Fwd::FIELDS * kBlock * sizeof(T) : 0;
  // dynamic shared memory a block at nlev levels: the level table, then the ring
  static size_t shared_bytes(int nlev) { return cloudsc2::level_table_bytes<T>(nlev) + RING_BYTES; }
  using Fn = void (*)(const Fwd, const Rev, T*);
  static Fn fn() {
    return &cloudsc2::level_scan_fwdrev_kernel<Fwd, Rev, T, Ring::DEPTH, Ring::SHARED, kBlock, MIN_BLOCKS>;
  }
};

struct Launcher {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;
  cudaStream_t stream;

  template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
  int run() const {
    using K = Kernel<T, EVAP, LREGCL, RESIDENT, D>;
    const cudaError_t err = cloudsc2::allow_dynamic_shared(K::fn(), K::shared_bytes(nlev));
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto b = cloudsc2::make_ad_fused<T, EVAP, LREGCL, RESIDENT, D>(
        in, out, consts, cloudsc2::fused_tl_consts<T>(consts), nlev, ncols);
    T* const scratch = static_cast<T*>(out[cloudsc2::AD_FUSED_SCRATCH]);
    const int blocks = (ncols + kBlock - 1) / kBlock;
    cloudsc2::level_scan_fwdrev_kernel<typename K::Fwd, typename K::Rev, T, K::Ring::DEPTH, K::Ring::SHARED, kBlock,
                                       K::MIN_BLOCKS>
        <<<blocks, kBlock, K::shared_bytes(nlev), stream>>>(b.fwd, b.rev, scratch);
    return static_cast<int>(cudaGetLastError());
  }
};

// What the card makes of one instantiation at nlev levels: blocks of
// kBlock per SM, registers a thread, local (spill) bytes a thread, shared
// bytes a block.
struct Query {
  int* out;
  int nlev;

  template <typename T, bool EVAP, bool LREGCL, bool RESIDENT, int D>
  int run() const {
    using K = Kernel<T, EVAP, LREGCL, RESIDENT, D>;
    cudaError_t err = cloudsc2::allow_dynamic_shared(K::fn(), K::shared_bytes(nlev));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K::fn(), kBlock, K::shared_bytes(nlev));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, K::fn());
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = per_sm;
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = static_cast<int>(K::shared_bytes(nlev) + attr.sharedSizeBytes);
    return 0;
  }
};

}  // namespace

extern "C" {

const char* cloudsc2_ad_fused_signature() { return cloudsc2::ad_fused_signature(); }

// Launch one fused AD step on `stream`.  div (a DivMode) and compact
// (CUADJ_COMPACT): a form the library holds (scalar_math.h "library
// forms").  in/out: device pointers in the order of
// CLOUDSC2_AD_FUSED_INPUTS/OUTPUTS (covptot_i may be null without evap),
// the outputs followed by the scratch, out[AD_FUSED_SCRATCH]: a device
// buffer of ADFusedSlots<EVAP, RESIDENT>::ALL x nlev x ncols values of the
// type, no other call's; consts: a host pointer to NLConst<T> followed by
// TLConst<T>.  Returns the cudaError_t of the launch (0 on success).
int cloudsc2_ad_fused_launch(int is_double, int evap, int lregcl, int resident, int div, int compact,
                             const void* const* in, void* const* out, const void* consts, int nlev, int ncols,
                             void* stream) {
  if (nlev < 1 || ncols < 1 || out[cloudsc2::AD_FUSED_SCRATCH] == nullptr ||
      !cloudsc2::forms_valid(is_double, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launcher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::ad_fused_dispatch(l, is_double, evap, lregcl, resident, div);
}

// Fill out[0..3] for the instantiation at nlev levels: blocks of 128 per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread, local
// bytes a thread, shared bytes a block.  Returns a cudaError_t.
int cloudsc2_ad_fused_occupancy(int is_double, int evap, int lregcl, int resident, int div, int compact, int nlev,
                                int* out) {
  if (nlev < 1 || !cloudsc2::forms_valid(is_double, div, compact)) return static_cast<int>(cudaErrorInvalidValue);
  const Query q{out, nlev};
  return cloudsc2::ad_fused_dispatch(q, is_double, evap, lregcl, resident, div);
}

}  // extern "C"
