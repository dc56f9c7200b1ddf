# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The NL step with saturation fused in (``fuse_saturation``) and under the
FAST_DIV divide modes, on the CPU: the port's plain version
(cloudsc2_tpu_torch.physics.nonlinear) and the kernel's body built for the
host (kernels/csrc/nl_level.h, g++ -ffp-contract=off) against the Pallas
kernel in interpret mode and against each other.

Tolerances:

* The fused form against ``cloudsc2_nl_pallas(..., fuse_saturation=True)``
  in interpret mode (f32, 1024 x 53, wb=128): the gate of
  tests/test_pallas.py:169-190, rtol 2e-5 with atol 1e-8 on the
  tendencies and 1e-6 on the diagnostics, fhps* with the flux-residue atol
  of ``cloudsc2_tpu_torch.utils.compare.nl_tolerances``, and qsat at rtol
  1e-6, atol 1e-10.
* The host body's fused launch against its unfused launch fed the qsat it
  diagnosed: bitwise (the same level code); its qsat against the plain
  ``saturation``: rtol 1e-12 (f64) / 1e-6 (f32), atol 0.  The host build's
  glibc exp and PyTorch's exp differ by an ulp, so the host's fused step is
  not bitwise the plain two-stage one; on the card, where both use the
  device's libm, chip_smoke.py holds the fused kernel bitwise to
  ``Saturation`` + the unfused kernel.
* The faithful and approx modes against the interpret kernel with the same
  constants (f32, 1024 x 53): per field, the largest abs difference over the
  field's largest magnitude at most 1e-4 (measured: 1.2e-5 faithful, 7.1e-5
  approx, plain and host alike), and the median relative difference over
  the nonzero points at most 1e-6 (measured: at most 2.2e-7; an exact
  divide where interpret mode takes the approximate reciprocal puts it near
  1e-3 in approx).  Interpret mode's approximate reciprocal is x rounded to
  bfloat16 and its float32 reciprocal, about 3.9e-3 relative
  (``fastmath``); the port models it bit for bit.
* f64 with FAST_DIV set: bitwise the exact path (non-f32 operands always
  divide exactly).
* The host build's reciprocal alone (``kernels.nonlinear.rcp_host``) under
  each mode: bitwise ``fastmath.rcp`` of the same float32 points.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.physics import fastmath
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.utils.compare import nl_tolerances
from tests.torch_helpers import (
    CONFIGS,
    ROBUST_CASES,
    assert_fields,
    assert_physical,
    flat,
    jax_constants,
    jax_state,
    port_state,
    robust_state,
)

torch.set_num_threads(1)

MODES = ("faithful", "approx")
#: the fast-div gates against the interpret kernel (module docstring)
FAST_SCALED, FAST_MEDIAN = 1e-4, 1e-6


def _without_qsat(s):
    return {k: v for k, v in s.items() if k != "qsat"}


def _convective(c):
    """``c`` with LPHYLIN off and a convective liquid-fraction ramp apart
    from foealfa's, so that saturation's kflag 1 (foeewmcu) and kflag 2
    (foeewm) branches give different numbers (by default the two ramps are
    equal)."""
    return c.replace(LPHYLIN=False, RTICECU=c.RTT - 38.0, RTWAT_RTICECU_R=1.0 / 38.0)


#: (label, constants, kflag): the three switch configurations, and
#: LPHYLIN=False with kflag 1 and 2; LDRAIN1D without LPHYLIN takes the
#: foeewmcu branch with kflag 1 (the branch follows LPHYLIN, not the
#: kernel's THERMO switch)
FUSED_CASES = [(name, make, 1) for name, make in CONFIGS.items()] + [
    ("lphylin=False kflag=1", lambda: _convective(CONFIGS["default"]()), 1),
    ("lphylin=False kflag=2", lambda: _convective(CONFIGS["default"]()), 2),
    ("ldrain1d lphylin=False kflag=1", lambda: _convective(CONFIGS["ldrain1d"]()), 1),
]


@pytest.fixture(scope="module")
def synth():
    return {dtype: iox.synthesize_input(ncols=64, nlev=137, seed=0, dtype=dtype)
            for dtype in (np.float64, np.float32)}


@pytest.fixture(scope="module")
def synth32_small():
    _, state, dt = iox.synthesize_input(ncols=1024, nlev=53, seed=0, dtype=np.float32)
    return state, dt


# ---- fastmath: the divide modes


def test_rcp_approx_is_pallas_interpret_bit_for_bit():
    """``rcp(x, "approx")`` is what ``pl.reciprocal(approx=True)`` gives in a
    Pallas kernel in interpret mode, bit for bit; ``faithful`` is its one
    Newton step, within an ulp of XLA's (which may contract it)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from cloudsc2_tpu.physics import fastmath as jfm

    x = np.random.default_rng(5).uniform(1e-3, 2e5, (8, 128)).astype(np.float32)
    for mode in MODES:
        def kernel(x_ref, o_ref, mode=mode):
            o_ref[...] = jfm.rcp(x_ref[...], mode)

        want = np.asarray(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                                         interpret=True)(x))
        got = fastmath.rcp(torch.from_numpy(x), mode).numpy()
        if mode == "approx":
            np.testing.assert_array_equal(got, want)
            assert np.abs(got * x - 1.0).max() > 1e-3  # the model is coarse, as interpret mode's
        else:
            np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
            assert np.abs(got.astype(np.float64) * x - 1.0).max() < 1e-4


def test_divide_modes_fall_back_to_exact():
    """Non-f32 operands divide exactly, ``rcp`` of a 0-d operand is 1/x,
    a non-exact ``div`` of a float32 is ``a * rcp(b)`` (two roundings), and
    an unknown mode raises."""
    x64 = torch.linspace(0.513, 3.071, 11, dtype=torch.float64)
    x32 = x64.float()
    for mode in MODES:
        assert torch.equal(fastmath.rcp(x64, mode), 1.0 / x64)
        assert torch.equal(fastmath.div(2.0, x64, mode), torch.div(torch.tensor(2.0, dtype=torch.float64), x64))
        zero_d = torch.tensor(3.0)
        assert torch.equal(fastmath.rcp(zero_d, mode), torch.reciprocal(zero_d))
        assert torch.equal(fastmath.div(x32, x32 + 1.0, mode), x32 * fastmath.rcp(x32 + 1.0, mode))
    assert not torch.equal(fastmath.rcp(x32, "approx"), fastmath.rcp(x32))
    with pytest.raises(ValueError, match="divide mode"):
        fastmath.rcp(x32, "fast")


# ---- the fused step


@pytest.mark.parametrize("label,make,kflag", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_fused_is_the_unfused_body_on_its_qsat(synth, label, make, kflag, dtype):
    """The host body's fused launch: bitwise the unfused launch fed the qsat
    it diagnosed, and that qsat the plain ``saturation``'s to rounding; the
    state's qsat is not read (absent here)."""
    _, state, dt = synth[dtype]
    c = make()
    s = _without_qsat(port_state(state, dtype, c))
    tends, diags = nlk.cloudsc2_nl_host(s, dt, c, fuse_saturation=True, kflag=kflag)
    qsat = diags.pop("qsat")
    want_t, want_d = nlk.cloudsc2_nl_host(dict(s, qsat=qsat), dt, c)
    for got, want in ((tends, want_t), (diags, want_d)):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), f"{label}: {k}"
    plain = saturation(s["ap"], s["t"], kflag=kflag, lphylin=c.LPHYLIN, c=c)
    torch.testing.assert_close(qsat, plain, rtol=1e-12 if dtype == np.float64 else 1e-6, atol=0)
    if label == "lphylin=False kflag=2":
        other = saturation(s["ap"], s["t"], kflag=1, lphylin=False, c=c)
        assert not torch.equal(other, plain)  # the two branches differ here


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_fused_is_saturation_then_the_step(synth, dtype):
    """The plain fused form is ``saturation`` then the step, bitwise, with
    qsat among the diagnostics; the trajectory is unchanged by fusion."""
    _, state, dt = synth[dtype]
    c = CONFIGS["levapls2"]()
    s = port_state(state, dtype, c)
    tends, diags, traj = cloudsc2_nl(_without_qsat(s), dt, c, with_trajectory=True, fuse_saturation=True)
    want_t, want_d, want_traj = cloudsc2_nl(s, dt, c, with_trajectory=True)
    assert torch.equal(diags.pop("qsat"), s["qsat"])
    for got, want in ((tends, want_t), (diags, want_d), (traj, want_traj)):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_fused_trajectory_forms(synth, dtype):
    """The fused body's ``with_trajectory``: the step's outputs bitwise
    those without it; ``traj_only``: the same trajectory and no qsat."""
    _, state, dt = synth[dtype]
    c = CONFIGS["ldrain1d"]()
    s = _without_qsat(port_state(state, dtype, c))
    plain = flat(nlk.cloudsc2_nl_host(s, dt, c, fuse_saturation=True))
    tends, diags, traj = nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True, fuse_saturation=True)
    got = flat((tends, diags))
    assert got.keys() == plain.keys() and "qsat" in got
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    only = nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True, traj_only=True, fuse_saturation=True)
    assert only[0] == {} and only[1] == {} and only[2].keys() == traj.keys()
    for k in traj:
        assert torch.equal(only[2][k], traj[k]), k


def test_unfused_step_needs_qsat(synth):
    """Without fusion a state that lacks qsat is an error; with it, the
    state's qsat is not needed."""
    _, state, dt = synth[np.float64]
    c = CONFIGS["default"]()
    s = _without_qsat(port_state(state, np.float64, c))
    with pytest.raises(KeyError, match="qsat"):
        nlk.cloudsc2_nl_host(s, dt, c)
    with pytest.raises(KeyError, match="qsat"):
        cloudsc2_nl(s, dt, c)
    assert "qsat" in nlk.cloudsc2_nl_host(s, dt, c, fuse_saturation=True)[1]


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_fused_f32_matches_pallas_interpret(synth32_small, cfg):
    """The plain fused form against ``cloudsc2_nl_pallas(...,
    fuse_saturation=True)`` in interpret mode (the module docstring's
    tolerances)."""
    from cloudsc2_tpu.pallas.nonlinear import cloudsc2_nl_pallas

    state, dt = synth32_small
    c = CONFIGS[cfg]()
    got = flat(cloudsc2_nl(_without_qsat(port_state(state, np.float32, c)), dt, c, fuse_saturation=True))
    want = flat(cloudsc2_nl_pallas(_without_qsat(jax_state(state, np.float32, c)), dt, jax_constants(c),
                                   interpret=True, wb=128, fuse_saturation=True))
    tol = dict(nl_tolerances((2e-5, 1e-8), (2e-5, 1e-6), c, np.float32), qsat=(1e-6, 1e-10))
    assert got.keys() == want.keys()
    assert_fields(got, want, tol, cfg)


# ---- the divide modes


@pytest.fixture(scope="module")
def interpret_fast(synth32_small):
    """The interpret kernel with FAST_DIV set, by (configuration, mode)."""
    from cloudsc2_tpu.pallas.nonlinear import cloudsc2_nl_pallas

    state, dt = synth32_small
    out = {}
    for cfg in ("default", "ldrain1d"):
        c = CONFIGS[cfg]()
        # the state's qsat diagnosed exactly, outside the kernel, for both sides
        js = jax_state(state, np.float32, c)
        for mode in MODES:
            out[cfg, mode] = flat(cloudsc2_nl_pallas(js, dt, jax_constants(c.replace(FAST_DIV=mode)),
                                                     interpret=True, wb=128))
    return out


@pytest.mark.parametrize("side", ["plain", "host"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cfg", ["default", "ldrain1d"])
def test_fast_div_matches_pallas_interpret(synth32_small, interpret_fast, cfg, mode, side):
    """The plain version and the host body under FAST_DIV against the
    interpret kernel with the same constants (the module docstring's
    gates), and physically valid."""
    state, dt = synth32_small
    c = CONFIGS[cfg]().replace(FAST_DIV=mode)
    s = port_state(state, np.float32, CONFIGS[cfg]())
    out = nlk.cloudsc2_nl_host(s, dt, c) if side == "host" else cloudsc2_nl(s, dt, c)
    # (with evaporation a flux that evaporates fully leaves a residue of either sign)
    assert_physical(out, strict_fluxes=cfg == "default")
    got, want = flat(out), interpret_fast[cfg, mode]
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(got[k].astype(np.float64) - w)
        scaled = err.max() / max(np.abs(w).max(), 1e-30)
        nz = w != 0
        median = float(np.median(err[nz] / np.abs(w[nz]))) if nz.any() else 0.0
        assert scaled <= FAST_SCALED and median <= FAST_MEDIAN, (k, scaled, median)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_f64_fast_div_is_exact(synth, mode, fused):
    """float64 always divides exactly: with FAST_DIV set, the plain version
    and the host body are bitwise the exact path."""
    _, state, dt = synth[np.float64]
    c = CONFIGS["levapls2"]()
    s = port_state(state, np.float64, c)
    if fused:
        s = _without_qsat(s)
    cm = c.replace(FAST_DIV=mode)
    for fn in (cloudsc2_nl, nlk.cloudsc2_nl_host):
        got = flat(fn(s, dt, cm, fuse_saturation=fused))
        want = flat(fn(s, dt, c, fuse_saturation=fused))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{fn.__name__} {k}")


@pytest.mark.parametrize("case", ROBUST_CASES)
@pytest.mark.parametrize("mode", ("exact",) + MODES)
def test_host_fused_fast_div_finite(case, mode):
    """The robustness states of tests/test_robustness.py through the fused
    host body under every divide mode (f32): finite, clc in [0, 1], fluxes
    >= 0 (the clamps of the JAX body hold under every divide strategy)."""
    c = CONFIGS["default"]().replace(FAST_DIV=mode)
    s, dt = robust_state(case, np.float32, c, ncols=64, nlev=53)
    assert_physical(nlk.cloudsc2_nl_host(_without_qsat(s), dt, c, fuse_saturation=True))


def test_clc_moves_by_the_cloud_edge_sqrt_of_a_qsat_ulp():
    """Why chip_smoke.py holds clc wider than the other fields under the
    divide modes: on the exact path (host body, f32), qsat one ulp up at
    every point moves clc = 1 - sqrt(ratio), where ratio is near 0, by far
    more than an ulp of its scale (measured: 1.6e-4 of it at 4096 x 137)."""
    c = CONFIGS["default"]()
    _, state, dt = iox.synthesize_input(ncols=2048, nlev=137, seed=1, dtype=np.float32)
    s = port_state(state, np.float32, c)
    clc = nlk.cloudsc2_nl_host(s, dt, c)[1]["clc"].double()
    up = torch.nextafter(s["qsat"], torch.full_like(s["qsat"], 1.0))
    moved = (nlk.cloudsc2_nl_host(dict(s, qsat=up), dt, c)[1]["clc"].double() - clc).abs().max()
    assert float(moved / clc.abs().max()) > 1e-5  # 80 ulps of the scale (measured 3.6e-5)


@pytest.mark.parametrize("mode", fastmath.DIV_MODES)
def test_host_rcp_is_the_plain_models_reciprocal(mode):
    """The host build's ``rcp<D>`` alone, at 4096 seeded float32 points of
    either sign over 1e-4 to 1e6 (pressures, temperatures, fractions), is
    bitwise the plain ``fastmath.rcp`` (given as 2-D, the operands it
    models); the non-exact modes differ from 1/x."""
    rng = np.random.default_rng(7)
    x = (10.0 ** rng.uniform(-4, 6, 4096) * rng.choice([-1.0, 1.0], 4096)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = nlk.rcp_host(xt, mode)
    want = fastmath.rcp(xt.reshape(64, 64), mode).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert torch.equal(got, 1.0 / xt) == (mode == "exact")
