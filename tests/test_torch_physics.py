# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Pointwise physics of the PyTorch port vs the JAX package, in f64.

The same numpy inputs (from ``iox.synthesize_input`` or a seeded
generator) go through each JAX function and its port.  Tolerance: rtol
1e-13, atol 0 (as tests/test_nonlinear.py holds the JAX saturation to the
oracle); the two agree to a few ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc2_tpu.physics import cuadjtqs as j_cuadj
from cloudsc2_tpu.physics import diagnostics as j_diag
from cloudsc2_tpu.physics import fcttre as j_fcttre
from cloudsc2_tpu.physics import nonlinear as j_nl
from cloudsc2_tpu.physics import saturation as j_sat
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics import cuadjtqs, diagnostics, fcttre, nonlinear, saturation
from tests.torch_helpers import jax_constants

torch.set_num_threads(1)

RTOL = 1e-13


@pytest.fixture(scope="module")
def synth():
    _, state, dt = iox.synthesize_input(ncols=100, nlev=137, seed=0)
    return state, dt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["foealfa", "foealfcu", "foeew_liquid", "foeew_ice", "foeewm", "foeewmcu"])
def test_fcttre_matches_jax(name):
    c = make_constants()
    rng = np.random.default_rng(5)
    t = np.concatenate([rng.uniform(180.0, 320.0, 4000), [c.RTICE, c.RTWAT, c.RTICECU, c.RTT]])
    _close(getattr(fcttre, name)(_t(t), c), getattr(j_fcttre, name)(jnp.asarray(t), jax_constants(c)))


@pytest.mark.parametrize("lphylin,kflag", [(True, 1), (False, 1), (False, 2)])
def test_saturation_matches_jax(synth, lphylin, kflag):
    state, _ = synth
    c = make_constants()
    got = saturation.saturation(_t(state["ap"]), _t(state["t"]), kflag=kflag, lphylin=lphylin, c=c)
    want = j_sat.saturation(jnp.asarray(state["ap"]), jnp.asarray(state["t"]), kflag=kflag, lphylin=lphylin,
                            c=jax_constants(c))
    _close(got, want)


def test_eta_levels_matches_jax(synth):
    state, _ = synth
    got = diagnostics.eta_levels(_t(state["ap"]), _t(state["aph"]))
    want = j_diag.eta_levels(jnp.asarray(state["ap"]), jnp.asarray(state["aph"]))
    assert got.shape == (137,)
    _close(got, want)


def test_cuadjtqs_nl_matches_jax():
    """Both phases and the ZQMAX clip: pressures down to 2 hPa, 180-320 K."""
    rng = np.random.default_rng(11)
    n = 4096
    ap = rng.uniform(2e2, 1.1e5, n)
    t = rng.uniform(180.0, 320.0, n)
    q = rng.uniform(0.0, 3e-2, n)
    c = make_constants()
    t_p, q_p = cuadjtqs.cuadjtqs_nl(_t(ap), _t(t), _t(q), c)
    t_j, q_j = j_cuadj.cuadjtqs_nl(jnp.asarray(ap), jnp.asarray(t), jnp.asarray(q), jax_constants(c))
    _close(t_p, t_j)
    _close(q_p, q_j, atol=1e-18)


def test_tropopause_and_critical_rh_match_jax(synth):
    """tropopause_eta (the last level of the window wins), the hoisted
    critical-RH coefficients, the profile itself and scalm."""
    state, dt = synth
    c = make_constants()
    eta = state["ap"][:, 0] / state["aph"][-1, 0]
    t_fg = state["t"] + dt * state["tnd_cml_t"]
    trp = nonlinear.tropopause_eta(_t(eta), _t(t_fg))
    trp_j = j_nl.tropopause_eta(jnp.asarray(eta), jnp.asarray(t_fg))
    np.testing.assert_array_equal(trp.numpy(), np.asarray(trp_j))
    assert (trp.numpy() != 0.1).any()  # the search finds a tropopause
    for got, want in zip(nonlinear.critical_rh_coeffs(trp), j_nl.critical_rh_coeffs(trp_j)):
        _close(got, want)
    for k in range(0, 137, 4):
        got = nonlinear.critical_rh(_t(eta[k]), trp)
        want = j_nl.critical_rh(jnp.asarray(eta[k]), trp_j)
        _close(got, want)
    _close(nonlinear.scalm_profile(_t(eta), c), j_nl.scalm_profile(jnp.asarray(eta), jax_constants(c)))
