// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Level-scan harness for column physics: the Hopper counterpart of
// level_scan_pallas (cloudsc2_tpu/pallas/levelscan.py:402), top-down form.
//
// On the TPU the level sweep is a sequential grid axis whose carry lives in
// VMEM scratch between grid steps.  Here one thread owns one column: the
// carry stays in registers and the levels are a loop inside the thread, so
// nothing is carried between blocks.  Fields are (nlev, ncols) with columns
// contiguous, so at each level the threads of a warp read and write
// neighbouring addresses.
//
// A Body provides
//   typename Body::Column                   per-column state, carry included
//   Column begin(int col) const             prologue; the carry starts at 0
//   void level(Column&, int col, int k) const
//   int nlev, ncols;
// The same template runs on the host (g++) for the CPU tests.
#pragma once

#ifdef __CUDACC__
#define CLOUDSC2_HD __host__ __device__ __forceinline__
#else
#define CLOUDSC2_HD inline
#endif

namespace cloudsc2 {

template <class Body>
CLOUDSC2_HD void level_scan_column(const Body& body, int col) {
  typename Body::Column s = body.begin(col);
  for (int k = 0; k < body.nlev; ++k) body.level(s, col, k);
}

#ifdef __CUDACC__
template <class Body>
__global__ void __launch_bounds__(128) level_scan_kernel(const Body body) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= body.ncols) return;  // ragged last block
  level_scan_column(body, col);
}
#endif

// Host counterpart: the columns in a loop.
template <class Body>
inline void level_scan_host(const Body& body) {
  for (int col = 0; col < body.ncols; ++col) level_scan_column(body, col);
}

}  // namespace cloudsc2
