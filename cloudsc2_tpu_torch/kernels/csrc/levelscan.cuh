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
//   const Table& level_table() const        its level table (below)
//   int nlev, ncols;
// Top down, the levels run 0 .. nlev-1 with the carry zeroed at the top;
// with REVERSE they run nlev-1 .. 0 with the carry zeroed at the bottom,
// then end() writes what needs the whole sweep (a column sum, the top row).
// The same template runs on the host (g++) for the CPU tests.
#pragma once

#include <math.h>

#include <vector>

#ifdef __CUDACC__
#define CLOUDSC2_HD __host__ __device__ __forceinline__
#else
#define CLOUDSC2_HD inline
#endif

namespace cloudsc2 {

// ----------------------------------------------------------- level table ----
// A value that depends on the level alone, which every thread would
// otherwise derive again at each level of its column.  A Table provides
//   T derive(int k) const                   level k's value, from the
//                                           (nlev,) inputs it reads itself
// On the card each block derives the nlev values once, before any of its
// threads runs a column or returns past the last one
// (level_table_prologue): the threads take the levels in turn into the
// first nlev values of the block's dynamic shared memory, then meet at one
// barrier; the ring of the pipelined scan, where the kernel keeps one in
// shared memory, follows them.  A body reads level k's value back with
// level_table_at: from shared memory on the card, derived where it is read
// in the host build.
template <typename T>
constexpr size_t level_table_bytes(int nlev) {
  return static_cast<size_t>(nlev) * sizeof(T);
}

#ifdef __CUDACC__
// The block's dynamic shared memory: the level table, then the ring.
__device__ __forceinline__ unsigned char* dynamic_shared() {
  extern __shared__ __align__(16) unsigned char cloudsc2_dynamic_shared[];
  return cloudsc2_dynamic_shared;
}

template <class Table>
__device__ __forceinline__ void level_table_prologue(const Table& table, int nlev) {
  using T = decltype(table.derive(0));
  T* values = reinterpret_cast<T*>(dynamic_shared());
  for (int k = threadIdx.x; k < nlev; k += blockDim.x) values[k] = table.derive(k);
  __syncthreads();
}

// Allow `bytes` of dynamic shared memory a block where that is above the
// 48 KB a kernel takes without asking.
template <class Fn>
inline cudaError_t allow_dynamic_shared(Fn fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}
#endif

template <class Table>
CLOUDSC2_HD auto level_table_at(const Table& table, int k) -> decltype(table.derive(k)) {
#ifdef __CUDA_ARCH__
  return reinterpret_cast<const decltype(table.derive(k))*>(dynamic_shared())[k];
#else
  return table.derive(k);
#endif
}

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
// The direct top-down kernel (the TL kernel's); the card runs the
// bottom-up form only pipelined (below).
template <class Body>
__global__ void __launch_bounds__(128) level_scan_kernel(const Body body) {
  level_table_prologue(body.level_table(), body.nlev);
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= body.ncols) return;  // ragged last block
  level_scan_column<Body>(body, col);
}
#endif

// Host counterpart: the columns in a loop.
template <class Body, bool REVERSE = false>
inline void level_scan_host(const Body& body) {
  for (int col = 0; col < body.ncols; ++col) level_scan_column<Body, REVERSE>(body, col);
}

// ------------------------------------------------------------- pipelined ----
// The pipelined form of the scan: each level's inputs are copied ahead
// into a per-thread ring of DEPTH slots, so that while a thread computes
// one level the copies of the next DEPTH-1 levels are in flight.  In the
// direct form above a level's loads wait for the arithmetic of the level
// before and nothing is in flight while it runs; here the copies overlap
// it.  A slot holds a level's raw input values; the body folds them as it
// would have folded its loads.
//
// A PipeBody provides
//   typename PipeBody::Column                   per-column state, carry included
//   static constexpr int FIELDS;                raw values a level, a slot's fields
//   Column begin(int col) const                 prologue; the carry starts at 0
//   template <class Ring>
//   void prefetch(Ring&, int slot, int col, int k) const
//       issues level k's copies into the slot: ring.copy(slot, field, src)
//   template <class Slot>
//   void level(Column&, const Slot&, int col, int k) const
//       level k, its inputs read back as slot(field)
//   void end(Column&, int col) const            epilogue (REVERSE only)
//   const Table& level_table() const            its level table (above)
//   int nlev, ncols;
// A Ring provides copy(slot, field, const T* src), commit() (closes the
// copies issued since the last commit into a group), wait<N>() (returns
// when at most the N most recent groups are still pending), advance()
// (called as each level's step begins) and slot(s).
//
// Top down the levels run 0 .. nlev-1; with REVERSE they run nlev-1 .. 0,
// then end().  Step j runs the j-th level in that order, and its copies
// are group j; past the last level each step commits an empty group, so
// group j is always the DEPTH-th most recent when step j waits for it.  A
// level's slot is refilled (with the level DEPTH steps on) only in the
// step after it was read, by the thread that read it.  The first DEPTH-1
// levels in sweep order (the top ones, or with REVERSE the bottom ones)
// are issued before the prologue, which then runs under them.  The body's
// loads are issued ahead of the stores of the levels before them: the
// caller guarantees that no output overlaps an input.
template <int DEPTH, bool REVERSE = false, class Body, class Ring>
CLOUDSC2_HD typename Body::Column level_scan_pipelined_column(const Body& body, Ring& ring, int col) {
  static_assert(DEPTH >= 1, "a ring needs a slot");
  for (int j = 0; j < DEPTH - 1; ++j) {
    if (j < body.nlev) body.prefetch(ring, j, col, REVERSE ? body.nlev - 1 - j : j);
    ring.commit();
  }
  typename Body::Column s = body.begin(col);
  int slot = 0;  // j % DEPTH
  for (int j = 0; j < body.nlev; ++j) {
    ring.advance();
    // the level DEPTH-1 steps on into the slot that step j-1 read
    if (j + DEPTH - 1 < body.nlev)
      body.prefetch(ring, slot == 0 ? DEPTH - 1 : slot - 1, col, REVERSE ? body.nlev - DEPTH - j : j + DEPTH - 1);
    ring.commit();
    ring.template wait<DEPTH - 1>();
    body.level(s, ring.slot(slot), col, REVERSE ? body.nlev - 1 - j : j);
    slot = slot + 1 == DEPTH ? 0 : slot + 1;
  }
  if constexpr (REVERSE) body.end(s, col);
  return s;
}

// A ring of two slots in registers: a plain load of each value of the
// level ahead into `next` while the level in `cur` runs, and the hardware's
// scoreboard waits for a value at its first use, so commit and wait are
// empty; advance moves the level ahead into `cur` (the slot indices of a
// two-slot ring are implied).
template <typename T, int FIELDS>
struct RegisterPair {
  struct Slot {
    T v[FIELDS];
    CLOUDSC2_HD T operator()(int field) const { return v[field]; }
  };
  Slot cur, next;

  CLOUDSC2_HD void copy(int, int field, const T* src) { next.v[field] = *src; }
  CLOUDSC2_HD void commit() const {}
  template <int N>
  CLOUDSC2_HD void wait() const {}
  CLOUDSC2_HD void advance() { cur = next; }
  CLOUDSC2_HD const Slot& slot(int) const { return cur; }
};

#ifdef __CUDACC__
// The ring in dynamic shared memory after the level table, DEPTH * FIELDS
// * blockDim.x values indexed [slot][field][thread]: at one field the
// threads of a warp touch
// consecutive words, so no bank conflicts.  copy is cp.async (4 B in
// float, 8 B in double, through L1: .ca), one commit group a level.  A
// thread waits only for its own copies and reads only what it copied, so
// the ring needs no __syncthreads and no mbarrier, and the threads of a
// ragged last block may return early.
template <typename T, int FIELDS>
struct SharedRing {
  T* base;  // this thread's word of slot 0, field 0
  int stride;  // blockDim.x

  struct Slot {
    const T* p;
    int stride;
    __device__ __forceinline__ T operator()(int field) const { return p[field * stride]; }
  };

  __device__ __forceinline__ void copy(int slot, int field, const T* src) const {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(base + (slot * FIELDS + field) * stride));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(sizeof(T))
                 : "memory");
  }
  __device__ __forceinline__ void commit() const { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
  __device__ __forceinline__ void advance() const {}
  template <int N>
  __device__ __forceinline__ void wait() const {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  }
  __device__ __forceinline__ Slot slot(int s) const { return {base + s * FIELDS * stride, stride}; }
};

// One column of the pipelined scan on the card: with SHARED the ring in
// dynamic shared memory (SharedRing), else two slots in registers
// (RegisterPair).
template <int DEPTH, bool SHARED, bool REVERSE, typename T, class Body>
__device__ __forceinline__ typename Body::Column level_scan_pipelined_device_column(const Body& body, int col) {
  if constexpr (SHARED) {
    SharedRing<T, Body::FIELDS> ring{reinterpret_cast<T*>(dynamic_shared()) + body.nlev + threadIdx.x,
                                     static_cast<int>(blockDim.x)};
    return level_scan_pipelined_column<DEPTH, REVERSE>(body, ring, col);
  } else {
    static_assert(DEPTH == 2, "a ring in registers has two slots");
    RegisterPair<T, Body::FIELDS> ring;
    return level_scan_pipelined_column<DEPTH, REVERSE>(body, ring, col);
  }
}

// The kernel, either direction: BLOCK threads a block and MIN_BLOCKS of
// them an SM, which caps the registers a thread at what that many blocks
// leave (1: no cap but the card's 255).
template <class Body, typename T, int DEPTH, bool SHARED, bool REVERSE, int BLOCK, int MIN_BLOCKS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) level_scan_pipelined_kernel(const Body body) {
  level_table_prologue(body.level_table(), body.nlev);
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= body.ncols) return;  // ragged last block
  level_scan_pipelined_device_column<DEPTH, SHARED, REVERSE, T>(body, col);
}
#endif

// Host model of SharedRing: one column's ring, stride 1, with the card's
// asynchrony modelled: a copy reads its source when issued and lands in
// the ring only when a wait retires its group, so a slot read before its
// wait, or refilled before it was read, gives the wrong values (the ring
// starts as NaN).
template <typename T, int FIELDS>
struct HostRing {
  struct Pending {
    int at, group;
    T value;
  };
  T* base;
  std::vector<Pending>* pending;
  int* open;  // the group the next copy joins

  struct Slot {
    const T* p;
    T operator()(int field) const { return p[field]; }
  };

  void copy(int slot, int field, const T* src) const {
    pending->push_back({slot * FIELDS + field, *open, *src});
  }
  void commit() const { ++*open; }
  void advance() const {}
  template <int N>
  void wait() const {
    std::vector<Pending> keep;
    for (const Pending& p : *pending) {
      if (p.group < *open - N)
        base[p.at] = p.value;
      else
        keep.push_back(p);
    }
    pending->swap(keep);
  }
  Slot slot(int s) const { return {base + s * FIELDS}; }
};

// One column of the host scan: with SHARED the shared-memory ring as
// HostRing models it, else the card's RegisterPair itself; either starts
// as NaN.
template <int DEPTH, bool SHARED, typename T, bool REVERSE = false, class Body>
inline typename Body::Column level_scan_pipelined_host_column(const Body& body, int col) {
  if constexpr (SHARED) {
    std::vector<T> buf(static_cast<size_t>(DEPTH) * Body::FIELDS, T(NAN));
    std::vector<typename HostRing<T, Body::FIELDS>::Pending> pending;
    int open = 0;
    HostRing<T, Body::FIELDS> ring{buf.data(), &pending, &open};
    return level_scan_pipelined_column<DEPTH, REVERSE>(body, ring, col);
  } else {
    static_assert(DEPTH == 2, "a ring in registers has two slots");
    RegisterPair<T, Body::FIELDS> ring;
    for (int f = 0; f < Body::FIELDS; ++f) ring.cur.v[f] = ring.next.v[f] = T(NAN);
    return level_scan_pipelined_column<DEPTH, REVERSE>(body, ring, col);
  }
}

// The host scan, a column at a time.
template <int DEPTH, bool SHARED, class Body, typename T, bool REVERSE = false>
inline void level_scan_pipelined_host(const Body& body) {
  for (int col = 0; col < body.ncols; ++col) level_scan_pipelined_host_column<DEPTH, SHARED, T, REVERSE>(body, col);
}

// ----------------------------------------------------- forward + reverse ----
// The fused form: the counterpart of level_scan_fwdrev_pallas
// (cloudsc2_tpu/pallas/levelscan.py:87), both sweeps of an adjoint in one
// launch.  On the TPU the grid's level axis runs its blocks up and then
// down, and the carry entering each level waits in a VMEM stack between
// the two (:217-251).  Here one thread runs both sweeps over its column:
// the forward sweep on the pipelined scan above (its level inputs in
// flight into the ring while a level runs), the reverse sweep level by
// level.  The stack is a scratch in device memory that the wrapper
// allocates, SLOTS values per level and column (ScratchStack).  In shared
// memory, where VMEM would have it, a column's stack of 137 levels took
// 1-7 KB and held an SM to 16-192 threads; in device memory each value
// costs a write and a read, and the registers set the threads an SM holds.
//
// A FwdBody is a PipeBody (above) whose level also takes the stack:
//   typename FwdBody::Column                    per-column state, carry included
//   static constexpr int FIELDS, SLOTS;         a ring slot's fields; values pushed per level
//   Column begin(int col) const                 prologue of both sweeps
//   void prefetch(Ring&, int slot, int col, int k) const
//   void level(Column&, const Slot&, const Stack&, int col, int k) const
//       one level, top down, its inputs from the slot; it pushes onto
//       stack(slot, k) the carry entering the level (and what else the
//       reverse level k reads back)
//   const Table& level_table() const            the level table of both sweeps
//   int nlev, ncols;
// A RevBody provides
//   typename RevBody::Column                    per-column state, cotangent carry included
//   Column begin(const FwdBody::Column&) const  from the forward prologue's values
//   void level(Column&, const Stack&, int col, int k) const
//       one level, bottom up; it pops what the forward level k pushed
//   void end(Column&, int col) const            epilogue
// A Stack provides T& operator()(int slot, int k) const.

// One column's stack in the scratch of SLOTS x nlev x ncols values, indexed
// [slot][k][col]: at one level the threads of a warp touch consecutive
// words.  The reverse sweep pops the bottom levels first, the ones the
// forward sweep pushed last, so its first reads find the freshest writes.
template <typename T>
struct ScratchStack {
  T* base;  // the column's word of slot 0, level 0
  int nlev;
  int ncols;
  CLOUDSC2_HD T& operator()(int slot, int k) const {
    return base[(static_cast<size_t>(slot) * static_cast<size_t>(nlev) + static_cast<size_t>(k)) *
                static_cast<size_t>(ncols)];
  }
};

// A FwdBody with its column's stack: the PipeBody that the pipelined scan
// runs.
template <class FwdBody, class Stack>
struct StackedFwd {
  using Column = typename FwdBody::Column;
  static constexpr int FIELDS = FwdBody::FIELDS;
  const FwdBody& fwd;
  Stack stack;
  int nlev, ncols;

  CLOUDSC2_HD Column begin(int col) const { return fwd.begin(col); }
  template <class Ring>
  CLOUDSC2_HD void prefetch(Ring& r, int slot, int col, int k) const {
    fwd.prefetch(r, slot, col, k);
  }
  template <class Slot>
  CLOUDSC2_HD void level(Column& s, const Slot& r, int col, int k) const {
    fwd.level(s, r, stack, col, k);
  }
};

template <class FwdBody, class Stack>
CLOUDSC2_HD StackedFwd<FwdBody, Stack> stacked(const FwdBody& fwd, const Stack& stack) {
  return {fwd, stack, fwd.nlev, fwd.ncols};
}

template <class RevBody, class FwdColumn, class Stack>
CLOUDSC2_HD void level_scan_rev_sweep(const RevBody& rev, const FwdColumn& s, const Stack& stack, int col,
                                      int nlev) {
  typename RevBody::Column r = rev.begin(s);
  for (int k = nlev - 1; k >= 0; --k) rev.level(r, stack, col, k);
  rev.end(r, col);
}

#ifdef __CUDACC__
// The forward sweep's ring as level_scan_pipelined_device_column keeps it
// (DEPTH slots, SHARED: in dynamic shared memory, else two in registers);
// BLOCK threads a block, MIN_BLOCKS of them an SM, which caps the
// registers a thread at what that many blocks leave (the wrapper's plan,
// kernels/adjoint.py fused_plan, counts the blocks the card then holds).
// The forward sweep's loads run ahead of its stores: the caller
// guarantees that no output overlaps an input.
template <class FwdBody, class RevBody, typename T, int DEPTH, bool SHARED, int BLOCK, int MIN_BLOCKS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) level_scan_fwdrev_kernel(const FwdBody fwd,
                                                                              const RevBody rev, T* scratch) {
  level_table_prologue(fwd.level_table(), fwd.nlev);  // the reverse sweep reads the same table
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= fwd.ncols) return;  // ragged last block; no thread reads another's stack or ring
  const ScratchStack<T> stack{scratch + col, fwd.nlev, fwd.ncols};
  const typename FwdBody::Column s =
      level_scan_pipelined_device_column<DEPTH, SHARED, false, T>(stacked(fwd, stack), col);
  level_scan_rev_sweep(rev, s, stack, col, fwd.nlev);
}
#endif

// Host counterpart, on the same scratch and the same index function, the
// ring modelled as level_scan_pipelined_host does: every column's forward
// sweep before any column's reverse sweep, as a grid in one wave runs
// them, so that a stack that aliased two columns would give the wrong
// numbers here too.
template <int DEPTH, bool SHARED, class FwdBody, class RevBody, typename T>
inline void level_scan_fwdrev_host(const FwdBody& fwd, const RevBody& rev, T* scratch) {
  std::vector<typename FwdBody::Column> cols;
  cols.reserve(static_cast<size_t>(fwd.ncols));
  for (int col = 0; col < fwd.ncols; ++col) {
    const ScratchStack<T> stack{scratch + col, fwd.nlev, fwd.ncols};
    cols.push_back(level_scan_pipelined_host_column<DEPTH, SHARED, T>(stacked(fwd, stack), col));
  }
  for (int col = 0; col < fwd.ncols; ++col)
    level_scan_rev_sweep(rev, cols[static_cast<size_t>(col)], ScratchStack<T>{scratch + col, fwd.nlev, fwd.ncols},
                         col, fwd.nlev);
}

}  // namespace cloudsc2
