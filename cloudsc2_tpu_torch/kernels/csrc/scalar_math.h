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
#pragma once

#include <math.h>

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

}  // namespace cloudsc2
