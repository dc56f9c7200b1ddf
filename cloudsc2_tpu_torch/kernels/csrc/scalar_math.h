// Copyright 2026.
// Licensed under the Apache License, Version 2.0.
//
// Scalar math shared by the level bodies (nl_level.h, tl_level.h), and the
// rules that make a body the same sequence of roundings as its plain torch
// version and its JAX counterpart:
//   * T is float or double.  Every literal is written T(x) and every
//     constant arrives in T (the bodies' constant structs), so nothing is
//     promoted to double in T=float: JAX rounds each Python constant to the
//     array dtype first.  A product of literals, T(a * b), is folded in
//     double as Python folds it.
//   * Compound constants of the model's parameters (cons2 = 1/(RG*dt),
//     1/(lcrit*lcrit), ...) are folded on the host in double and rounded
//     once (state.kernel_constants, state.tl_kernel_constants), as JAX folds
//     them at trace time.
//   * No FMA contraction (built with --fmad=false / -ffp-contract=off) and
//     no fast math: the plain version runs each operation separately.
//   * lax.rsqrt becomes T(1)/sqrt(x); x**2 and x**3 become x*x and x*x*x
//     (PyTorch computes those powers as products too); other powers are
//     pow/powf, as torch.pow on CUDA.
//   * The guarded denominators of the JAX bodies stay, so both versions
//     divide the same numbers.
//   * Every divide that the JAX body routes through fastmath.rcp / div
//     (cloudsc2_tpu/physics/fastmath.py:51-78) is rcp<D> / fdiv<D> below,
//     D the divide policy of Constants.FAST_DIV; the others stay '/'.
#pragma once

#include <math.h>
#include <string.h>

#include "levelscan.cuh"

namespace cloudsc2 {

CLOUDSC2_HD float m_exp(float x) { return expf(x); }
CLOUDSC2_HD double m_exp(double x) { return exp(x); }
CLOUDSC2_HD float m_tanh(float x) { return tanhf(x); }
CLOUDSC2_HD double m_tanh(double x) { return tanh(x); }
CLOUDSC2_HD float m_sqrt(float x) { return sqrtf(x); }
CLOUDSC2_HD double m_sqrt(double x) { return sqrt(x); }
CLOUDSC2_HD float m_pow(float x, float y) { return powf(x, y); }
CLOUDSC2_HD double m_pow(double x, double y) { return pow(x, y); }
template <typename T> CLOUDSC2_HD T m_min(T a, T b) { return b < a ? b : a; }
template <typename T> CLOUDSC2_HD T m_max(T a, T b) { return b > a ? b : a; }

// ------------------------------------------------------------ divide policy
// Constants.FAST_DIV: exact, faithful, approx (fastmath.DIV_MODES).
//   DIV_EXACT     one IEEE division (T(1)/x, a/b).
//   DIV_APPROX    the approximate reciprocal.  On the card it is PTX
//                 rcp.approx.ftz.f32, the hardware's (MUFU.RCP, about 1
//                 ulp).  .ftz: MUFU.RCP flushes subnormals natively, and
//                 the form without it wraps the instruction in a scaling
//                 fix-up for subnormal inputs and results; every operand
//                 here is a normal number far from 2^126 (pressures,
//                 temperatures, heat capacities, fractions guarded away
//                 from 0), so both forms give the same numbers and the
//                 .ftz form is one instruction.  On the host it is what
//                 Pallas interpret mode computes for
//                 pl.reciprocal(approx=True) (jax/_src/pallas/primitives.py,
//                 _reciprocal_lowering_rule, as XLA on the CPU runs it): x
//                 rounded to bfloat16, then its float reciprocal.  That is
//                 the counterpart of interpret mode in the CPU tests, and
//                 the model of fastmath.rcp in the plain version.
//   DIV_FAITHFUL  the approximate reciprocal and one Newton step,
//                 r * (2 - x * r) in that order.  --fmad=false (build.py)
//                 keeps the step three rounded operations, as the plain
//                 version computes it, where nvcc would otherwise contract
//                 it into FMAs.
// Under a non-exact policy fdiv(a, b) is a * rcp(b): two roundings, as in
// JAX.  Only float takes a non-exact policy: double always divides exactly
// (fastmath: non-f32 operands fall back to exact division), and the
// kernels instantiate the non-exact policies for float only.
enum DivMode { DIV_EXACT = 0, DIV_FAITHFUL = 1, DIV_APPROX = 2 };

// float rounded to bfloat16 (to nearest, ties to even) and back, as
// PyTorch and XLA convert; operands are finite
inline float bf16_round(float x) {
  unsigned int u;
  memcpy(&u, &x, sizeof u);
  u += 0x7fffu + ((u >> 16) & 1u);
  u &= 0xffff0000u;
  memcpy(&x, &u, sizeof x);
  return x;
}

CLOUDSC2_HD float rcp_approx(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return 1.0f / bf16_round(x);
#endif
}

template <int D> CLOUDSC2_HD double rcp(double x) { return 1.0 / x; }
template <int D> CLOUDSC2_HD double fdiv(double a, double b) { return a / b; }

template <int D>
CLOUDSC2_HD float rcp(float x) {
  if constexpr (D == DIV_EXACT) {
    return 1.0f / x;
  } else {
    const float r = rcp_approx(x);
    if constexpr (D == DIV_FAITHFUL) return r * (2.0f - x * r);
    return r;
  }
}

template <int D>
CLOUDSC2_HD float fdiv(float a, float b) {
  if constexpr (D == DIV_EXACT) {
    return a / b;
  } else {
    return a * rcp<D>(b);
  }
}

}  // namespace cloudsc2
