// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// CLOUDSC2 adjoint step on Hopper (sm_90a), reverse kernel: the port of the
// Pallas kernel cloudsc2_ad_pallas (cloudsc2_tpu/pallas/adjoint.py:125) on
// the pipelined level-scan harness run bottom-up (levelscan.cuh,
// level_scan_pipelined_column<DEPTH, true>; the port of
// level_scan_pallas(reverse=True), pallas/levelscan.py:402).
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
// mf, lu_next, the tropopause and critical-RH coefficients, scalm from eta,
// which each block derives once into shared memory before its ring:
// levelscan.cuh "level table"), the fold of
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
// coalesced (columns contiguous).  The direct scan (a level's loads, its
// arithmetic, its stores) had nothing in flight while a level computed;
// here each thread copies the 27 values of the level above (29 with
// evaporation) by cp.async into a ring in shared memory before it computes
// the current one (ad_level.h ADPipeBody, ADRing: two slots,
// [slot][field][thread], 27,648 B a block in f32 and 55,296 B in f64, which
// needs cudaFuncAttributeMaxDynamicSharedMemorySize).  Each thread reads
// only what it copied, so the ring needs no barrier.  aph at a level's
// bottom interface is carried from the level below, and the tropopause
// pass issues its loads eight levels at a time.  The slot is folded as
// the direct scan folds its loads, so the outputs are bitwise the same.
// Its other cost is registers: the primal values the adjoint reads are
// live through the level.  In f32 the launch bounds ask for 4 blocks of
// 128 an SM (128 registers; 65,536 columns need 4 to run in one wave):
// 124 registers without evaporation, 128 under faithful / approx, 128 and
// 108 B of spills with evaporation, where the body would take 159-167 and
// run 3 blocks.  In f64 nothing is asked: 250 registers, 2 blocks (a bound
// of 3 blocks spilled 408 B and ran 1.76x slower); 255 and 160 B of local
// memory with evaporation.  On an NVIDIA H100 80GB HBM3 at 700.00 W, at
// 65,536 x 137, against the direct scan in one call
// (drivers/kernel_ab_torch.py, PERF.md section 6): f32 0.71-0.72 -> 0.68
// ms (0.68 of the byte floor), with evaporation 1.70-1.73 -> 1.16, faithful
// 0.87-0.88 -> 0.67-0.68, approx 0.84-0.86 -> 0.65-0.67; f64 1.46-1.49 ->
// 1.34-1.36, but with evaporation 2.76-2.77 -> 2.98-2.99.  The direct
// scan under the same f32 bound of 4 blocks ran exact 0.72-0.74, with
// evaporation 1.20-1.21, faithful 0.61-0.63 and approx 0.61-0.62: the ring
// gains where the level's divides are long and loses where they are short
// (faithful, approx).  Since
// the loads run ahead of the stores of the levels before them, the wrapper
// refuses outputs that overlap an input.
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

// Threads a block (kernels/adjoint.py REVERSE_BLOCK).
constexpr int kBlock = 128;
// Shared memory of one SM (228 KB), and what the card reserves of it for
// each resident block.
constexpr size_t kSmShared = 233472;
constexpr size_t kBlockReserved = 1024;
// Devices whose attributes prepare() keeps (any further one sets them at
// every launch).
constexpr int kMaxDevices = 64;

// Blocks of kBlock an SM that the launch bounds ask for, by type, chosen
// by an A/B on an H100 (PERF.md section 6): 4 in float, which caps every
// float body at 128 registers, and 1 in double, which asks for nothing (the
// registers the body takes set the blocks).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 1;

template <typename T, bool EVAP, bool LREGCL, int D>
struct Kernel {
  using Body = cloudsc2::ADPipeBody<T, EVAP, LREGCL, D>;
  static constexpr int DEPTH = cloudsc2::ADRing<T>::DEPTH;
  static constexpr int MIN_BLOCKS = kMinBlocks<T>;
  // dynamic shared memory a block at nlev levels: the level table, then the
  // ring, [slot][field][thread]
  static size_t shared_bytes(int nlev) {
    return cloudsc2::level_table_bytes<T>(nlev) + size_t(DEPTH) * Body::FIELDS * kBlock * sizeof(T);
  }
  static auto fn() {
    return &cloudsc2::level_scan_pipelined_kernel<Body, T, DEPTH, true, true, kBlock, MIN_BLOCKS>;
  }
  // Allow the bytes at nlev levels (above 48 KB in double), and ask for the
  // shared-memory carveout that the blocks the registers allow need, so
  // that the ring and the table never hold an SM to fewer.
  static cudaError_t set_attributes(int nlev) {
    cudaError_t err = cudaFuncSetAttribute(fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(shared_bytes(nlev)));
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn(), kBlock, 0);
    if (err != cudaSuccess) return err;
    const size_t want = static_cast<size_t>(blocks) * (shared_bytes(nlev) + kBlockReserved);
    const int percent = static_cast<int>((want * 100 + kSmShared - 1) / kSmShared);
    return cudaFuncSetAttribute(fn(), cudaFuncAttributePreferredSharedMemoryCarveout, percent > 100 ? 100 : percent);
  }
  // set_attributes once per device (a function's attributes are the
  // device's) and depth: the depth they were set for is kept, and another
  // depth sets them again.
  static cudaError_t prepare(int nlev) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return set_attributes(nlev);
    static int done[kMaxDevices];  // the depth set; 0: not yet set
    if (__atomic_load_n(&done[dev], __ATOMIC_ACQUIRE) != nlev) {
      err = set_attributes(nlev);
      if (err == cudaSuccess) __atomic_store_n(&done[dev], nlev, __ATOMIC_RELEASE);
    }
    return err;
  }
};

struct Launcher {
  const void* const* in;
  void* const* out;
  const void* consts;
  int nlev, ncols;
  cudaStream_t stream;

  template <typename T, bool EVAP, bool LREGCL, int D>
  int run() const {
    using K = Kernel<T, EVAP, LREGCL, D>;
    const cudaError_t err = K::prepare(nlev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto body = cloudsc2::make_ad_body<T, EVAP, LREGCL, D>(in, out, consts, nlev, ncols);
    const int blocks = (ncols + kBlock - 1) / kBlock;
    cloudsc2::level_scan_pipelined_kernel<typename K::Body, T, K::DEPTH, true, true, kBlock, K::MIN_BLOCKS>
        <<<blocks, kBlock, K::shared_bytes(nlev), stream>>>(typename K::Body{body});
    return static_cast<int>(cudaGetLastError());
  }
};

// What the card makes of one instantiation at kBlock threads a block and
// nlev levels: blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after prepare), registers a thread, local (spill) bytes a thread, dynamic
// shared bytes a block, ring depth.
struct Query {
  int* out;
  int nlev;

  template <typename T, bool EVAP, bool LREGCL, int D>
  int run() const {
    using K = Kernel<T, EVAP, LREGCL, D>;
    cudaError_t err = K::prepare(nlev);
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
    out[3] = static_cast<int>(K::shared_bytes(nlev));
    out[4] = K::DEPTH;
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
// evap), no output overlapping an input; consts: host pointer to
// TLConst<T>.  Returns the cudaError_t of the launch or of the attributes
// it sets first (0 on success).
int cloudsc2_ad_launch(int is_double, int evap, int lregcl, int div, int compact,
                       const void* const* in, void* const* out, const void* consts, int nlev,
                       int ncols, void* stream) {
  if (nlev < 1 || ncols < 1 || !cloudsc2::forms_valid(is_double, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launcher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::ad_dispatch(l, is_double, evap, lregcl, div);
}

// Fill out[0..4] for the instantiation at nlev levels: blocks of 128 per SM,
// registers a thread, local bytes a thread, dynamic shared bytes a block,
// ring depth (Query).  Returns a cudaError_t.
int cloudsc2_ad_occupancy(int is_double, int evap, int lregcl, int div, int compact, int nlev, int* out) {
  if (nlev < 1 || !cloudsc2::forms_valid(is_double, div, compact)) return static_cast<int>(cudaErrorInvalidValue);
  const Query q{out, nlev};
  return cloudsc2::ad_dispatch(q, is_double, evap, lregcl, div);
}

}  // extern "C"
