// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Level-scan harness for column physics: the Hopper counterpart of
// level_scan_pallas (cloudsc2_tpu/pallas/levelscan.py:402), top-down form
// and, with REVERSE, the bottom-up form of its reverse=True (:457-460).
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
//   void end(Column&, int col) const        epilogue (REVERSE only)
//   int nlev, ncols;
// Top down, the levels run 0 .. nlev-1 with the carry zeroed at the top;
// with REVERSE they run nlev-1 .. 0 with the carry zeroed at the bottom,
// then end() writes what needs the whole sweep (a column sum, the top row).
// The same template runs on the host (g++) for the CPU tests.
#pragma once

#ifdef __CUDACC__
#define CLOUDSC2_HD __host__ __device__ __forceinline__
#else
#define CLOUDSC2_HD inline
#endif

namespace cloudsc2 {

template <class Body, bool REVERSE = false>
CLOUDSC2_HD void level_scan_column(const Body& body, int col) {
  typename Body::Column s = body.begin(col);
  if constexpr (REVERSE) {
    for (int k = body.nlev - 1; k >= 0; --k) body.level(s, col, k);
    body.end(s, col);
  } else {
    for (int k = 0; k < body.nlev; ++k) body.level(s, col, k);
  }
}

#ifdef __CUDACC__
template <class Body, bool REVERSE = false>
__global__ void __launch_bounds__(128) level_scan_kernel(const Body body) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= body.ncols) return;  // ragged last block
  level_scan_column<Body, REVERSE>(body, col);
}
#endif

// Host counterpart: the columns in a loop.
template <class Body, bool REVERSE = false>
inline void level_scan_host(const Body& body) {
  for (int col = 0; col < body.ncols; ++col) level_scan_column<Body, REVERSE>(body, col);
}

}  // namespace cloudsc2
