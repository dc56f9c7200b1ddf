// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// The two probes on Hopper (sm_90a), over the bodies of microbench.h:
//
// reader, the port of the Pallas kernel make_reader
// (benchmarks/microbench_hbm.py:45, pallas_call at :81): S float32 streams
// summed per column.  What bounds it: bytes, (S * nlev * ncols + ncols) * 4
// at the HBM rate (3.35 TB/s on an H100 SXM), against one add per value
// read.  On the TPU the level axis was a sequential grid dimension that
// carried the sum in VMEM scratch, in blocks of 16 levels; here the design
// is the physics kernels' (levelscan.cuh): one thread per column, 128 a
// block, the sum in a register, the levels in a loop with the S loads of a
// level unrolled (S is a template value), so each thread has S independent
// loads in flight, and at one level a warp reads 128 B lines of each
// stream.  Its GB/s is what such a kernel can draw from the card at S
// streams, the yardstick for the physics kernels' byte bounds.  It reads
// only the nlev real levels: the JAX kernel's last block of 16 levels runs
// past an array of 137 (rows 137-143 are outside it).
//
// chain, the port of make_chain (benchmarks/microbench_div.py:56,
// pallas_call at :65): one variant of x -> 1.25 / (x + 1) applied n times
// to each element, one thread per element, in registers.  What bounds it:
// operations once n is large (2 to 9 a step, the reciprocals on the SM's
// special-function unit rather than its 128 FP32 lanes); its bytes, one
// read and one write an element, at small n.  The divide goes through
// scalar_math.h, so it prices the port's own divide policies.
//
// Built with kernels/build.py's NVCC_FLAGS: --fmad=false keeps the Newton
// steps three rounded operations and '/' the IEEE division the physics
// kernels run; never with fast math.
#include <cuda_runtime.h>

#include "microbench.h"

namespace cloudsc2 {

template <bool TILE, int S>
__global__ void __launch_bounds__(128)
    reader_kernel(const ReaderStreams s, int nlev, int ncols, float seq, float* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncols) return;  // ragged last block
  out[c] = reader_column<TILE, S>(s, nlev, ncols, seq, c);
}

// With `sm` set, thread 0 of each block records the SM it ran on (%smid),
// so that a reading which assumes a placement can check it.
template <int V>
__global__ void __launch_bounds__(128) chain_kernel(const float* x, float* y, int n_elem, int n, int* sm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (sm != nullptr && threadIdx.x == 0) {
    int id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    sm[blockIdx.x] = id;
  }
  if (i < n_elem) y[i] = chain_element<V>(x[i], n);
}

}  // namespace cloudsc2

extern "C" {

const char* cloudsc2_microbench_signature() { return cloudsc2::microbench_signature(); }

// out[c] = seq + the sum of streams[0..nstreams)[:, c] over nlev levels, on
// `stream`.  tile: 0 global layout (nlev, ncols), 1 tile layout (nj, nlev,
// 4096).  streams: host array of device pointers.  Returns the launch's
// cudaError_t (0 on success).
int cloudsc2_reader_launch(int tile, const float* const* streams, int nstreams, int nlev, int ncols,
                           float seq, float* out, void* stream) {
  if (!cloudsc2::reader_args_valid(tile, nstreams, nlev, ncols))
    return static_cast<int>(cudaErrorInvalidValue);
  cloudsc2::ReaderStreams s{};
  for (int q = 0; q < nstreams; ++q) s.p[q] = streams[q];
  const int threads = 128;
  const int blocks = (ncols + threads - 1) / threads;
  const auto st = static_cast<cudaStream_t>(stream);
  return cloudsc2::dispatch_streams(nstreams, static_cast<int>(cudaErrorInvalidValue), [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    if (tile)
      cloudsc2::reader_kernel<true, S><<<blocks, threads, 0, st>>>(s, nlev, ncols, seq, out);
    else
      cloudsc2::reader_kernel<false, S><<<blocks, threads, 0, st>>>(s, nlev, ncols, seq, out);
    return static_cast<int>(cudaGetLastError());
  });
}

// y[i] = variant^n(x[i]) for i < n_elem, `threads` a block (32..128), on
// `stream`; where `sm` is not null, sm[b] = the SM that ran block b (one
// int per block).  Returns the launch's cudaError_t.
int cloudsc2_chain_launch(int variant, const float* x, float* y, int n_elem, int n, int threads, int* sm,
                          void* stream) {
  if (n_elem < 1 || n < 0 || threads < 32 || threads > 128 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_elem + threads - 1) / threads;
  const auto st = static_cast<cudaStream_t>(stream);
  return cloudsc2::dispatch_chain(variant, static_cast<int>(cudaErrorInvalidValue), [&](auto tag) {
    cloudsc2::chain_kernel<decltype(tag)::value><<<blocks, threads, 0, st>>>(x, y, n_elem, n, sm);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
