# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The TL and AD under the FAST_DIV divide modes, on the CPU: the port's
plain versions (physics/tangent_linear.py, physics/adjoint.py) and the
kernels' bodies built for the host (kernels/csrc/tl_level.h, ad_level.h,
ad_fused.h; g++ -ffp-contract=off) against the Pallas kernels in interpret
mode with the same constants (``cloudsc2_tl_pallas``, ``cloudsc2_ad_pallas``,
``cloudsc2_ad_pallas_fused``; f32, 1024 x 20, wb=128), in the default and
levapls2 configurations.  Interpret mode's approximate reciprocal is x
rounded to bfloat16 and its float32 reciprocal, about 3.9e-3 relative
(``fastmath``); the port models it bit for bit.

Each field is held by two numbers: its largest abs difference over the
field's largest magnitude ("scaled"), and the median relative difference
over its points above 1e-6 of that magnitude ("median"; an exact divide
where interpret mode takes the approximate reciprocal puts it near 1e-3).
Tolerances, a few times the largest readings of either mode:

* TL, plain and host, every field: scaled 1e-4, median 1e-5 (measured:
  1.57e-5, clc_i, as the exact divide reads it, where XLA's compiled f32 TL
  re-associates; median 6.9e-7).
* AD, the host bodies (the two-kernel AD against ``cloudsc2_ad_pallas``,
  the fused kernel against ``cloudsc2_ad_pallas_fused``), all 26 fields:
  scaled 1e-3, median 1e-4 (measured: 2.54e-4, mfd_i, approx; median
  3.14e-5, lu_i, faithful; the exact divide reads 8.6e-5 and 2.2e-5 in
  lu_i).  Both sides re-linearize around the NL trajectory.
* AD, the plain AD's 16 cotangents: faithful as the host bodies; approx
  scaled 0.1, median 1e-3 (measured: 3.78e-2, mfd_i, levapls2; median
  2.45e-4, lu_i).  The plain AD re-linearizes around the TL's own forward,
  the Pallas AD around the NL kernel's trajectory; under a 3.9e-3 reciprocal
  the two forwards part where a threshold flips, so the plain AD is held
  to the Pallas AD only as far as that allows, and its forward outputs (the
  TL's) are not held to the Pallas AD's (the NL's) at all.
* float64 with FAST_DIV set: bitwise the exact path (non-f32 operands
  always divide exactly), plain and host.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from tests.torch_helpers import CONFIGS, as_jax, flat, jax_constants, port_ad_state, port_tl_state

torch.set_num_threads(1)

MODES = ("faithful", "approx")
CFGS = ("default", "levapls2")
#: (scaled, median) gates, by comparison (module docstring)
GATES = {
    "tl": (1e-4, 1e-5),
    "ad": (1e-3, 1e-4),
    "plain ad approx": (0.1, 1e-3),
}


@pytest.fixture(scope="module")
def synth32():
    _, state, dt = iox.synthesize_input(ncols=1024, nlev=20, seed=1, dtype=np.float32)
    return state, dt


@pytest.fixture(scope="module")
def interpret(synth32):
    """The Pallas kernels in interpret mode, by (kernel, configuration,
    mode), computed once each on first use."""
    cache = {}

    def get(kernel, cfg, mode):
        if (kernel, cfg, mode) not in cache:
            from cloudsc2_tpu.pallas.adjoint import cloudsc2_ad_pallas, cloudsc2_ad_pallas_fused
            from cloudsc2_tpu.pallas.tangent_linear import cloudsc2_tl_pallas

            state, dt = synth32
            c = CONFIGS[cfg]()
            jc = jax_constants(c.replace(FAST_DIV=mode))
            if kernel == "tl":
                out = cloudsc2_tl_pallas(as_jax(port_tl_state(state, np.float32, c)), dt, jc, interpret=True, wb=128)
            else:
                s = as_jax(port_ad_state(state, np.float32, c, dt))
                if kernel == "ad":
                    out = cloudsc2_ad_pallas(s, dt, jc, interpret=True, wb=128)
                else:
                    out = cloudsc2_ad_pallas_fused(s, dt, jc, interpret=True, wb=128, unroll=1)
            cache[kernel, cfg, mode] = flat(out)
        return cache[kernel, cfg, mode]

    return get


def _assert_close(got, want, gates, label):
    """Every field of ``want`` within the (scaled, median) ``gates``."""
    scaled_gate, median_gate = gates
    assert set(want) <= set(got), label
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[k], np.float64) - w)
        top = np.abs(w).max()
        scaled = err.max() / max(top, 1e-30)
        big = np.abs(w) > 1e-6 * top
        median = float(np.median(err[big] / np.abs(w[big]))) if big.any() else 0.0
        assert np.isfinite(err).all() and scaled <= scaled_gate and median <= median_gate, (
            label, k, scaled, median)


@pytest.mark.parametrize("side", ["plain", "host"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cfg", CFGS)
def test_tl_fast_div_matches_pallas_interpret(synth32, interpret, cfg, mode, side):
    state, dt = synth32
    c = CONFIGS[cfg]()
    s = port_tl_state(state, np.float32, c)
    fn = tlk.cloudsc2_tl_host if side == "host" else cloudsc2_tl
    got = flat(fn(s, dt, c.replace(FAST_DIV=mode)))
    _assert_close(got, interpret("tl", cfg, mode), GATES["tl"], f"{side} TL {cfg} {mode}")


@pytest.mark.parametrize("side", ["plain", "host", "host fused"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cfg", CFGS)
def test_ad_fast_div_matches_pallas_interpret(synth32, interpret, cfg, mode, side):
    state, dt = synth32
    c = CONFIGS[cfg]()
    s = port_ad_state(state, np.float32, c, dt)
    cm = c.replace(FAST_DIV=mode)
    if side == "plain":
        got = flat(cloudsc2_ad(s, dt, cm))
        want = {k: v for k, v in interpret("ad", cfg, mode).items() if k.endswith("_i")}
        gates = GATES["plain ad approx"] if mode == "approx" else GATES["ad"]
    elif side == "host":
        got, want, gates = flat(adk.cloudsc2_ad_host(s, dt, cm)), interpret("ad", cfg, mode), GATES["ad"]
    else:
        got, want, gates = flat(adk.cloudsc2_ad_fused_host(s, dt, cm)), interpret("ad_fused", cfg, mode), GATES["ad"]
    assert len(want) == (16 if side == "plain" else 26)
    _assert_close(got, want, gates, f"{side} AD {cfg} {mode}")


@pytest.mark.parametrize("mode", MODES)
def test_host_ad_fast_div_gradient_only_forms(mode):
    """Under a divide mode the fused host body is bitwise the two-kernel
    host AD (the same level code), rolled and resident, and the
    ``cotangent_only`` form bitwise its cotangents."""
    c = CONFIGS["levapls2"]().replace(FAST_DIV=mode)
    _, state, dt = iox.synthesize_input(ncols=33, nlev=29, seed=2, dtype=np.float32)
    s = port_ad_state(state, np.float32, CONFIGS["levapls2"](), dt)
    want = flat(adk.cloudsc2_ad_host(s, dt, c))
    for resident in (False, True):
        got = flat(adk.cloudsc2_ad_fused_host(s, dt, c, resident=resident))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"resident={resident} {k}")
    only = flat(adk.cloudsc2_ad_host(s, dt, c, cotangent_only=True))
    assert sorted(only) == sorted(k for k in want if k.endswith("_i"))
    for k in only:
        np.testing.assert_array_equal(only[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_f64_fast_div_is_exact(mode):
    """float64 always divides exactly: with FAST_DIV set, the plain TL and
    AD and the host bodies (TL, two-kernel AD, fused AD) are bitwise the
    exact path."""
    c = CONFIGS["levapls2"]()
    cm = c.replace(FAST_DIV=mode)
    _, state, dt = iox.synthesize_input(ncols=16, nlev=29, seed=1)
    s = port_ad_state(state, np.float64, c, dt)
    st = port_tl_state(state, np.float64, c)
    for fn, x in ((cloudsc2_tl, st), (tlk.cloudsc2_tl_host, st), (cloudsc2_ad, s), (adk.cloudsc2_ad_host, s),
                  (adk.cloudsc2_ad_fused_host, s)):
        got, want = flat(fn(x, dt, cm)), flat(fn(x, dt, c))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{fn.__name__} {k}")
