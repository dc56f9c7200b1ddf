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

#include <vector>

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

// ----------------------------------------------------- forward + reverse ----
// The fused form: the counterpart of level_scan_fwdrev_pallas
// (cloudsc2_tpu/pallas/levelscan.py:87), both sweeps of an adjoint in one
// launch.  On the TPU the grid's level axis runs its blocks up and then
// down, and the carry entering each level waits in a VMEM stack between
// the two (:217-251).  Here one thread runs both sweeps over its column,
// and the stack is a per-thread array of `slots` values per level.
//
// A FwdBody provides
//   typename FwdBody::Column                    per-column state, carry included
//   Column begin(int col) const                 prologue of both sweeps
//   void level(Column&, Stack&, int col, int k) const
//       one level, top down; it pushes onto stack(slot, k) the carry
//       entering the level (and what else the reverse level k reads back)
//   static constexpr int SLOTS;                 values pushed per level
//   int nlev, ncols;
// A RevBody provides
//   typename RevBody::Column                    per-column state, cotangent carry included
//   Column begin(const FwdBody::Column&) const  from the forward prologue's values
//   void level(Column&, const Stack&, int col, int k) const
//       one level, bottom up; it pops what the forward level k pushed
//   void end(Column&, int col) const            epilogue
// A Stack provides T& operator()(int slot, int k) const.
template <class FwdBody, class RevBody, class Stack>
CLOUDSC2_HD void level_scan_fwdrev_column(const FwdBody& fwd, const RevBody& rev,
                                          const Stack& stack, int col) {
  typename FwdBody::Column s = fwd.begin(col);
  for (int k = 0; k < fwd.nlev; ++k) fwd.level(s, stack, col, k);
  typename RevBody::Column r = rev.begin(s);
  for (int k = fwd.nlev - 1; k >= 0; --k) rev.level(r, stack, col, k);
  rev.end(r, col);
}

#ifdef __CUDACC__
// The stack in dynamic shared memory, FwdBody::SLOTS * nlev * blockDim.x
// values, indexed [slot][k][thread]: at one level the threads of a warp
// touch consecutive words.
template <typename T>
struct SharedStack {
  T* base;
  int nlev;
  __device__ __forceinline__ T& operator()(int slot, int k) const {
    return base[(static_cast<unsigned>(slot) * nlev + k) * blockDim.x + threadIdx.x];
  }
};

// MAX_THREADS bounds the block for the compiler only: the launch picks any
// block size up to it, and the stack's stride is blockDim.x.
template <class FwdBody, class RevBody, typename T, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS) level_scan_fwdrev_kernel(const FwdBody fwd,
                                                                        const RevBody rev) {
  extern __shared__ __align__(16) unsigned char cloudsc2_stack[];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= fwd.ncols) return;  // ragged last block; no thread reads another's stack
  const SharedStack<T> stack{reinterpret_cast<T*>(cloudsc2_stack), fwd.nlev};
  level_scan_fwdrev_column(fwd, rev, stack, col);
}
#endif

// Host counterpart: one column's stack, stride 1, reused column by column.
template <typename T>
struct ColumnStack {
  T* base;
  int nlev;
  T& operator()(int slot, int k) const { return base[static_cast<size_t>(slot) * nlev + k]; }
};

template <class FwdBody, class RevBody, typename T>
inline void level_scan_fwdrev_host(const FwdBody& fwd, const RevBody& rev) {
  std::vector<T> buf(static_cast<size_t>(FwdBody::SLOTS) * fwd.nlev);
  const ColumnStack<T> stack{buf.data(), fwd.nlev};
  for (int col = 0; col < fwd.ncols; ++col) level_scan_fwdrev_column(fwd, rev, stack, col);
}

}  // namespace cloudsc2
