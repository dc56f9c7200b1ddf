// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// CLOUDSC2 nonlinear step on Hopper (sm_90a): the port of the Pallas kernel
// cloudsc2_nl_pallas (cloudsc2_tpu/pallas/nonlinear.py:76) and of its
// level-scan harness level_scan_pallas (cloudsc2_tpu/pallas/levelscan.py:402).
// A library holds one form of the saturation adjustment (CUADJ_COMPACT,
// scalar_math.h "library forms"), and in it the exact divide in float and
// double and the FAST_DIV faithful and approx policies
// (cloudsc2_tpu/physics/fastmath.py:34-78) in float:
// every divide the JAX body routes through fastmath.rcp / div becomes the
// hardware approximate reciprocal, PTX rcp.approx.ftz.f32, with one Newton
// step in faithful (scalar_math.h says how and why).  The JAX kernel divides
// non-f32 operands exactly, so a double step takes the exact policy only.
//
// What it computes: one whole NL step for every column, including what the
// JAX wrapper does around its kernel in XLA (first-guess combines, dp, mf,
// lu_next, the tropopause search, the critical-RH coefficients) and the
// assembly of the fluxes (zero top interface, fhps* = -L * fpls*), and scalm
// from eta: each block derives the nlev values of scalm once, into shared
// memory before its ring, and every level reads its value back from there
// (levelscan.cuh "level table", nl_level.h ScalmTable; the TL and AD
// kernels do the same).  Only eta, one (nlev,) vector, comes from torch.
//
// With fuse (fuse_saturation, pallas/nonlinear.py:105-110) it diagnoses qsat
// from ap and t at each point instead of reading it, and writes it: the
// Saturation component and the NL step in one launch.  With traj (the
// adjoint's forward sweep) it also writes the carry entering each level:
// c_rfl, c_sfl, and c_cov when evaporation is compiled in; with traj = 2
// (traj_only, the forward sweep of a gradient-only adjoint) it writes that
// trajectory and nothing else.
//
// What bounds it.  Per column-level the function moves 26 values (its 16
// inputs read once, 10 outputs written; fused, qsat is written, not read);
// the kernel reads t and tnd_cml_t a second time for the tropopause pass:
// 28 values, 112 B in f32, 1.006 GB at 65,536 x 137, against roughly 300
// flops, a dozen exp and about 25 divides.  On an H100 80GB HBM3 (700 W)
// those bytes take 0.33 ms at the 3085 GB/s the reader probe draws at the
// kernel's 15 input streams, and torch.add (2 reads to 1 write) draws
// 2970-3046 GB/s; the divides alone take 0.117 ms at the exact divide's
// throughput.
// The direct scan (levelscan.cuh level_scan_kernel: a level's loads, then
// its arithmetic, then its stores) kept nothing in flight while a level
// computed, and took about the sum of the two: 0.55-0.57 ms f32 fused,
// 0.98-1.00 ms f64, with the faithful divide saving 0.11-0.13 ms, about
// what the divides cost.  More warps could not hide it at that size: 65,536
// columns make 512 blocks of 128, 3.88 an SM, however few registers (47)
// the kernel takes.
//
// What the design does about it: the pipelined scan (levelscan.cuh
// level_scan_pipelined_column, nl_level.h NLPipeBody).  One thread per
// column keeps the carry (rfl, sfl, covptot) and every intermediate in
// registers, and fields are (nlev, ncols) with columns contiguous, so a
// warp's loads and stores at a level are 128 B lines, as before; but each
// thread now issues the raw inputs of the levels ahead into a ring of
// slots before it computes the current level, so those loads are in
// flight under its arithmetic.  In float the ring is three slots in
// shared memory, [slot][field][thread] (24 KB a block of 128, no bank
// conflicts), filled by cp.async (4 B a copy, one commit group a level,
// cp.async.wait_group<2> before a slot is read): each thread copies only
// its own column's values and reads only what it copied, so the ring needs
// no __syncthreads and no mbarrier, and a ragged last block's threads
// return early.  In double the ring is two slots in registers (plain
// loads; the scoreboard waits at first use), where a ring in shared memory
// was slower in the unfused and trajectory forms; the kernel is held to
// 128 registers so that four blocks of 128 fit an SM and 65,536 columns
// run in one wave.  aph at a level's top interface is carried from the
// level above, and the tropopause pass issues its loads eight levels at a
// time.  The body folds a slot's values as it would have folded its loads,
// in the same order, so the results are bitwise those of the direct scan.
// Since the loads run ahead of the stores of the levels before them, the
// wrapper refuses outputs that overlap an input.  Measured in turns against
// the direct scan on that card (drivers/kernel_ab_torch.py): f32 fused
// 0.57 -> 0.47 ms, 0.60 of its 0.2791 ms bound and 0.67 of torch.add's
// rate with the same bytes; f64 fused 1.00 -> 0.78; the faithful divide
// now saves 0.03 ms: the divides run mostly under the loads.  What is left
// is neither the byte stream nor the divides: faithful and approx stop at
// 0.41-0.45 ms.
//
// What was left was taken for each thread's serial chain of levels, which
// only more warps an SM can hide, and a grid larger than one wave has the
// blocks to bring them.  So the blocks of the float kernel an SM holds are
// set by the shared-memory carveout each launch asks for, sized by its
// grid (nl_level.h nl_carveout_blocks): four where the grid fits one wave
// of four (65,536 columns or fewer), else as many as the SM's memory holds
// with each block's ring in shared memory and the lines of its copies in
// flight in L1: six at 262,144 columns, where the registers allow eight.
// It gained little: the fused form 1.65 -> 1.61 ms at 262,144 x 137 (six
// blocks; eight 1.63), the sign that the chain was not the limit either:
// the level loop is 980 SASS instructions a warp, and a scheduler retires
// a warp-level every ~1,540 cycles (1.98 GHz) at 4 warps and every ~1,510
// at 8, issuing in about 64% of its cycles either way.
//
// Built with --fmad=false so that the result matches the plain torch
// version (which never fuses a*b+c); never with fast math.
#include <cuda_runtime.h>

#include "nl_level.h"

extern "C" {

const char* cloudsc2_nl_signature() { return cloudsc2::nl_signature(); }

// Launch one NL step on `stream`.  Switches in the order of
// CLOUDSC2_NL_SWITCHES (nl_level.h); div is 0 (exact), 1 (faithful) or 2
// (approx), and 0 when is_double; compact must be the library's form
// (CLOUDSC2_COMPACT, scalar_math.h).  in/out: device pointers in the order of
// CLOUDSC2_NL_INPUTS/OUTPUTS (those not read or written may be null);
// consts: host pointer to NLConst<T>.  Returns the cudaError_t of the launch
// (0 on success).
int cloudsc2_nl_launch(int is_double, int thermo, int evap, int traj, int fuse, int div, int compact,
                       const void* const* in, void* const* out, const void* consts, int nlev,
                       int ncols, void* stream) {
  if (!cloudsc2::nl_switches_valid(nlev, ncols, is_double, traj, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const cloudsc2::NLLauncher l{in, out, consts, nlev, ncols, static_cast<cudaStream_t>(stream)};
  return cloudsc2::nl_dispatch(l, is_double, thermo, evap, traj, fuse, div);
}

// Fill out[0..5] for the body of these switches (as cloudsc2_nl_launch's)
// at 128 threads a block, nlev levels and a launch of ncols columns: the
// blocks per SM that launch gets, registers a thread, local bytes a
// thread, dynamic shared bytes a block, ring depth, and the blocks its
// shared-memory carveout is sized for (0: none asked) (nl_level.h
// NLQuery).  Returns a cudaError_t.
int cloudsc2_nl_occupancy(int is_double, int thermo, int evap, int traj, int fuse, int div, int compact,
                          int nlev, int ncols, int* out) {
  if (!cloudsc2::nl_switches_valid(nlev, ncols, is_double, traj, div, compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const cloudsc2::NLQuery q{out, nlev, ncols};
  return cloudsc2::nl_dispatch(q, is_double, thermo, evap, traj, fuse, div);
}

// rcp<div>(x[i]) into r[i] for i < n, on `stream`: the divide policies'
// reciprocal on its own, for the checks of chip_smoke.py and the card
// tests (never on the main path).  Returns the launch's cudaError_t.
int cloudsc2_rcp_probe(int div, const float* x, float* r, int n, void* stream) {
  if (n < 1 || div < cloudsc2::DIV_EXACT || div > cloudsc2::DIV_APPROX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (div == cloudsc2::DIV_FAITHFUL)
    cloudsc2::rcp_probe_kernel<cloudsc2::DIV_FAITHFUL><<<blocks, threads, 0, s>>>(x, r, n);
  else if (div == cloudsc2::DIV_APPROX)
    cloudsc2::rcp_probe_kernel<cloudsc2::DIV_APPROX><<<blocks, threads, 0, s>>>(x, r, n);
  else
    cloudsc2::rcp_probe_kernel<cloudsc2::DIV_EXACT><<<blocks, threads, 0, s>>>(x, r, n);
  return static_cast<int>(cudaGetLastError());
}

// scalm of eta[i] into scalm[i] for i < n, on `stream`, by the derivation
// every kernel runs in its prologue (nl_level.h ScalmTable::derive), in
// float (is_double 0) or double (1); consts: host pointer to zscal and
// zeps1 in that type.  For the card tests' comparison with torch's
// scalm_profile (never on the main path).  Returns the launch's
// cudaError_t.
int cloudsc2_scalm_probe(int is_double, const void* eta, void* scalm, int n, const void* consts, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    const double* z = static_cast<const double*>(consts);
    cloudsc2::scalm_probe_kernel<double><<<blocks, threads, 0, s>>>(
        cloudsc2::ScalmTable<double>{static_cast<const double*>(eta), z[0], z[1]}, static_cast<double*>(scalm), n);
  } else {
    const float* z = static_cast<const float*>(consts);
    cloudsc2::scalm_probe_kernel<float><<<blocks, threads, 0, s>>>(
        cloudsc2::ScalmTable<float>{static_cast<const float*>(eta), z[0], z[1]}, static_cast<float*>(scalm), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
