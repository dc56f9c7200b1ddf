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
//     D the divide policy of Constants.FAST_DIV, or fdiv_scalar<D> where
//     the divisor is a per-level scalar; the others stay '/'.
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
// kernels instantiate the non-exact policies for float only.  The
// adjoint's reverse level divides its cotangents by the same forward
// values under the same policy: a TL term x_i * rcp(b) transposes to
// x_b * rcp(b).
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

// A divide by a per-level scalar (1 - scalm in the TL): fastmath.rcp keeps
// 1/x exact for an operand of fewer than two dimensions, which inside the
// Pallas kernels are the level's scalars, so under a non-exact policy the
// quotient is a * (1/b), an exact reciprocal and a product.
template <int D> CLOUDSC2_HD double fdiv_scalar(double a, double b) { return a / b; }

template <int D>
CLOUDSC2_HD float fdiv_scalar(float a, float b) {
  if constexpr (D == DIV_EXACT) {
    return a / b;
  } else {
    return a * (1.0f / b);
  }
}

// ------------------------------------------------------------ library forms
// The forms one build of a kernel source holds.  kernels/build.py passes
// them as -D flags, one library per form, so that a library of the default
// form compiles the same bodies whatever the others add:
//   CLOUDSC2_COMPACT  1: the compact saturation adjustment (CUADJ_COMPACT,
//                     the default); 0: the reference-shaped form;
//   CLOUDSC2_DIVS     the divide policies held for float, bit D for policy
//                     D; the exact bit also holds double, which divides
//                     exactly under every policy.
#ifndef CLOUDSC2_COMPACT
#define CLOUDSC2_COMPACT 1
#endif
#ifndef CLOUDSC2_DIVS
#define CLOUDSC2_DIVS 1
#endif
constexpr bool kCompact = CLOUDSC2_COMPACT != 0;

template <int D>
constexpr bool has_div() {
  return ((CLOUDSC2_DIVS) >> D) & 1;
}

// Whether the library holds the form of the switches (div: a DivMode;
// compact: CUADJ_COMPACT).
inline bool forms_valid(int is_double, int div, int compact) {
  if ((compact != 0) != kCompact || div < DIV_EXACT || div > DIV_APPROX) return false;
  if (is_double) return div == DIV_EXACT && has_div<DIV_EXACT>();
  return ((CLOUDSC2_DIVS) >> div) & 1;
}

// A divide policy as a type, for dispatch_type_div's callers.
template <int D>
struct DivTag {
  static constexpr int value = D;
};

// f(T(), DivTag<D>()) for the type and divide policy of the switches, over
// those the library holds (check forms_valid first; `refused` is returned
// for any other).
template <class F>
inline int dispatch_type_div(int is_double, int div, int refused, const F& f) {
  if (is_double) {
    if constexpr (has_div<DIV_EXACT>()) return f(double(), DivTag<DIV_EXACT>());
    return refused;
  }
  if constexpr (has_div<DIV_FAITHFUL>())
    if (div == DIV_FAITHFUL) return f(float(), DivTag<DIV_FAITHFUL>());
  if constexpr (has_div<DIV_APPROX>())
    if (div == DIV_APPROX) return f(float(), DivTag<DIV_APPROX>());
  if constexpr (has_div<DIV_EXACT>())
    if (div == DIV_EXACT) return f(float(), DivTag<DIV_EXACT>());
  return refused;
}

}  // namespace cloudsc2
