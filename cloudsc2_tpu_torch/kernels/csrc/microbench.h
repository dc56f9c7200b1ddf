// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Bodies of the two probes (microbench.cu on the card, microbench_host.cpp
// for the CPU tests): the counterparts of the Pallas kernels make_reader
// (benchmarks/microbench_hbm.py:45) and make_chain
// (benchmarks/microbench_div.py:56).  Both are float32 only, as the JAX
// scripts are.
//
// reader: out[c] = seq + sum over levels k, then streams s, of in_s[k, c],
// one column per thread, in exactly that order (level by level, stream by
// stream), so that a plain version summing in the same order is bitwise
// equal.  Layouts:
//   global  each stream (nlev, ncols), columns contiguous: the physics
//           kernels' own layout, and the memory order of JAX's (NLEV, 8, w);
//   tile    each stream (nj, nlev, TILE), column c = j * TILE + i: the
//           counterpart of JAX's tile-contiguous (nj, NLEV, 8, WB).
// The column loop, the level loop and the S loads a level are the access
// pattern of the physics kernels (levelscan.cuh), so the reading is the
// yardstick for them.
//
// chain: one variant of x -> 1.25 / (x + 1) applied n times to one element,
// through the divide policies of scalar_math.h, so the probe prices the
// port's own divide code:
//   div    fdiv<DIV_EXACT>: one IEEE division
//   rcp    1.25 * (1 / (x + 1)): the correctly rounded reciprocal, then a product
//   rcpx   1.25 * rcp<DIV_APPROX>(x + 1): rcp.approx.ftz.f32 on the card
//   rcpx1  1.25 * rcp<DIV_FAITHFUL>(x + 1): approx and one Newton step
//   rcpx2  approx and two Newton steps r * (2 - b * r)
// On the host the approximate reciprocal is Pallas interpret mode's
// 1/bf16(x) (scalar_math.h rcp_approx).
#pragma once

#include "scalar_math.h"

namespace cloudsc2 {

constexpr int kReaderMaxStreams = 32;
constexpr int kReaderTile = 4096;

// The streams' base pointers, passed to the kernel by value.
struct ReaderStreams {
  const float* p[kReaderMaxStreams];
};

// One column's sum over the first S streams; TILE picks the layout.
template <bool TILE, int S>
CLOUDSC2_HD float reader_column(const ReaderStreams& s, int nlev, int ncols, float seq, int c) {
  size_t base, stride;
  if constexpr (TILE) {
    base = static_cast<size_t>(c / kReaderTile) * nlev * kReaderTile + c % kReaderTile;
    stride = kReaderTile;
  } else {
    base = c;
    stride = ncols;
  }
  float acc = seq;
  for (int k = 0; k < nlev; ++k) {
    const size_t off = base + static_cast<size_t>(k) * stride;
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int q = 0; q < S; ++q) acc = acc + s.p[q][off];
  }
  return acc;
}

enum ChainVariant { CHAIN_DIV = 0, CHAIN_RCP = 1, CHAIN_RCPX = 2, CHAIN_RCPX1 = 3, CHAIN_RCPX2 = 4 };

// The variants in the order of CHAIN_*, as the wrapper names them.
inline const char* microbench_signature() {
  return "variants:div,rcp,rcpx,rcpx1,rcpx2;max_streams:32;tile:4096";
}

template <int V>
CLOUDSC2_HD float chain_step(float x) {
  const float b = x + 1.0f;
  if constexpr (V == CHAIN_DIV) {
    return fdiv<DIV_EXACT>(1.25f, b);
  } else if constexpr (V == CHAIN_RCP) {
    return 1.25f * rcp<DIV_EXACT>(b);
  } else if constexpr (V == CHAIN_RCPX) {
    return 1.25f * rcp<DIV_APPROX>(b);
  } else if constexpr (V == CHAIN_RCPX1) {
    return 1.25f * rcp<DIV_FAITHFUL>(b);
  } else {
    float r = rcp_approx(b);
    r = r * (2.0f - b * r);
    r = r * (2.0f - b * r);
    return 1.25f * r;
  }
}

// n steps: a runtime count in an inner loop of 16 unrolled steps (the JAX
// kernel unrolls its chain in Python; a rolled loop's add, compare and
// branch would be timed as part of the cheap variants), then the rest.
template <int V>
CLOUDSC2_HD float chain_element(float x, int n) {
  int k = 0;
  for (; k + 16 <= n; k += 16) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int u = 0; u < 16; ++u) x = chain_step<V>(x);
  }
  for (; k < n; ++k) x = chain_step<V>(x);
  return x;
}

// An int as a type, for the dispatchers' callers.
template <int N>
struct IntTag {
  static constexpr int value = N;
};

// f(IntTag<v>()) for the variant v (0..4); `refused` otherwise.
template <class F>
inline int dispatch_chain(int v, int refused, const F& f) {
  switch (v) {
    case CHAIN_DIV: return f(IntTag<CHAIN_DIV>());
    case CHAIN_RCP: return f(IntTag<CHAIN_RCP>());
    case CHAIN_RCPX: return f(IntTag<CHAIN_RCPX>());
    case CHAIN_RCPX1: return f(IntTag<CHAIN_RCPX1>());
    case CHAIN_RCPX2: return f(IntTag<CHAIN_RCPX2>());
    default: return refused;
  }
}

// f(IntTag<s>()) for 1 <= s <= kReaderMaxStreams; `refused` otherwise.
template <int S = 1, class F>
inline int dispatch_streams(int s, int refused, const F& f) {
  if (s == S) return f(IntTag<S>());
  if constexpr (S < kReaderMaxStreams) {
    return dispatch_streams<S + 1>(s, refused, f);
  } else {
    return refused;
  }
}

// Whether the reader takes these arguments (the wrapper checks that the
// arrays hold them: for tile, nj = ceil(ncols / TILE) tiles).
inline bool reader_args_valid(int tile, int nstreams, int nlev, int ncols) {
  return (tile == 0 || tile == 1) && nstreams >= 1 && nstreams <= kReaderMaxStreams && nlev >= 1 &&
         ncols >= 1;
}

}  // namespace cloudsc2
