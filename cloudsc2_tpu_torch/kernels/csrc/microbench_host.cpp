// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Host build of the two probes' bodies (microbench.h), compiled with g++
// -ffp-contract=off: the reader's column sum in the kernel's order, and the
// chain with the approximate reciprocal as Pallas interpret mode models it
// (scalar_math.h rcp_approx).  The CPU tests hold them against the plain
// versions; never used on a timed path.
#include "microbench.h"

extern "C" {

const char* cloudsc2_microbench_signature() { return cloudsc2::microbench_signature(); }

// As cloudsc2_reader_launch (microbench.cu) on host pointers; returns 0 on
// success.
int cloudsc2_reader_host(int tile, const float* const* streams, int nstreams, int nlev, int ncols,
                         float seq, float* out) {
  if (!cloudsc2::reader_args_valid(tile, nstreams, nlev, ncols)) return 1;
  cloudsc2::ReaderStreams s{};
  for (int q = 0; q < nstreams; ++q) s.p[q] = streams[q];
  return cloudsc2::dispatch_streams(nstreams, 1, [&](auto sc) {
    constexpr int S = decltype(sc)::value;
    for (int c = 0; c < ncols; ++c)
      out[c] = tile ? cloudsc2::reader_column<true, S>(s, nlev, ncols, seq, c)
                    : cloudsc2::reader_column<false, S>(s, nlev, ncols, seq, c);
    return 0;
  });
}

// As cloudsc2_chain_launch (microbench.cu) on host pointers, without the
// block size; returns 0 on success.
int cloudsc2_chain_host(int variant, const float* x, float* y, int n_elem, int n) {
  if (n_elem < 1 || n < 0) return 1;
  return cloudsc2::dispatch_chain(variant, 1, [&](auto tag) {
    for (int i = 0; i < n_elem; ++i) y[i] = cloudsc2::chain_element<decltype(tag)::value>(x[i], n);
    return 0;
  });
}

}  // extern "C"
