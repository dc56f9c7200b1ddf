# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's plain AD scheme (cloudsc2_tpu_torch.physics.adjoint, the plain
version of the CUDA AD kernels) and its pieces vs the JAX package.

* f64 vs ``cloudsc2_tpu.physics.adjoint.cloudsc2_ad`` at 32 x 137 for the
  default, LEVAPLS2 and LDRAIN1D, LREGCL on and off: every field within
  1e-10 of its largest magnitude (measured: 6.5e-14; the two are the same
  vjp of the same TL, rounded by two libraries).
* its forward outputs equal the plain NL's (rtol 5e-12, atol 1e-16, as
  tests/test_adjoint.py:30-44); zero seeds give exactly zero cotangents.
* with LREGCL off it equals ``torch.func.vjp`` of the plain NL (2e-7 of
  each field's scale, as tests/test_adjoint.py:103-136), 8 x 137.
* random-cotangent duality against the independent scalar TL oracle
  ``cloudsc2_tpu.oracle.oracle_tangent_linear`` (LREGCL on):
  ``<M_oracle dx, y> == <dx, AD(y)>`` per column to 5e-9 of the largest
  (tests/test_adjoint.py:189), 10 x 137.
* ``cuadjtqs_ad`` vs ``torch.func.vjp`` of ``cuadjtqs_nl`` and vs the JAX
  ``cuadjtqs_ad`` (rtol 1e-9, as tests/test_adjoint.py:153-186).
* f32 vs ``cloudsc2_ad_pallas(interpret=True, wb=128)`` at 1024 x 53, the
  size of tests/test_pallas.py:51: every field within 2e-6 of its largest
  magnitude, those of ``PALLAS_F32_WIDE`` within their stated share.
* the Cloudsc2AD component gives the plain AD's outputs.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.components import Cloudsc2AD
from cloudsc2_tpu_torch.physics.adjoint import AD_COTANGENT_FIELDS, cloudsc2_ad
from cloudsc2_tpu_torch.physics.cuadjtqs import cuadjtqs_ad, cuadjtqs_nl
from cloudsc2_tpu_torch.physics.increment import INCREMENT_FIELDS, state_increment
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.validation.symmetry import DIAG_NAMES, FIELD_PAIRS, TEND_NAMES
from tests.torch_helpers import (
    CONFIGS,
    PALLAS_F32_WIDE,
    as_jax,
    assert_ad,
    flat,
    jax_constants,
    port_ad_state,
    port_state,
)

torch.set_num_threads(1)

LREGCL = {"lregcl": True, "nolregcl": False}


def _config(cfg, lregcl):
    return CONFIGS[cfg]().replace(LREGCL=LREGCL[lregcl])


@pytest.fixture(scope="module")
def synth():
    _, state, dt = iox.synthesize_input(ncols=32, nlev=137, seed=0)
    return state, dt


@pytest.fixture(scope="module")
def ad64(synth):
    """Per configuration: the AD state, the port's AD and the JAX AD on it
    (JAX traces its AD once per configuration, here)."""
    from cloudsc2_tpu.physics.adjoint import cloudsc2_ad as jad

    state, dt = synth
    out = {}
    for cfg in CONFIGS:
        for lregcl in LREGCL:
            c = _config(cfg, lregcl)
            s = port_ad_state(state, np.float64, c, dt)
            out[cfg, lregcl] = s, flat(cloudsc2_ad(s, dt, c)), flat(jad(as_jax(s), dt, jax_constants(c)))
    return out


@pytest.mark.parametrize("lregcl", list(LREGCL))
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_ad_matches_jax_f64(ad64, cfg, lregcl):
    _, got, want = ad64[cfg, lregcl]
    assert len(want) == 26
    assert_ad(got, want, np.float64, f"{cfg} {lregcl}")


def test_plain_ad_forward_matches_plain_nl(synth, ad64):
    state, dt = synth
    s, got, _ = ad64["default", "lregcl"]
    nl = flat(cloudsc2_nl(s, dt, CONFIGS["default"]()))
    for n in nl:
        np.testing.assert_allclose(got[n], nl[n], rtol=5e-12, atol=1e-16, err_msg=n)


def test_plain_ad_zero_seeds_give_zero_cotangents(synth, ad64):
    _, dt = synth
    s, _, _ = ad64["levapls2", "lregcl"]
    s = dict(s)
    for n in TEND_NAMES:
        s["tnd_" + n + "_i"] = torch.zeros_like(s["tnd_" + n + "_i"])
    for n in DIAG_NAMES:
        s[n + "_i"] = torch.zeros_like(s[n + "_i"])
    tends, diags = cloudsc2_ad(s, dt, _config("levapls2", "lregcl"))
    for n in TEND_NAMES:
        assert tends["cml_" + n + "_i"].abs().max().item() == 0.0, n
    for n in AD_COTANGENT_FIELDS:
        assert diags[n + "_i"].abs().max().item() == 0.0, n


def test_plain_ad_matches_vjp_of_plain_nl_without_regularization():
    """With LREGCL off the adjoint is ``torch.func.vjp`` of the NL scheme
    applied to the same seeds."""
    _, state, dt = iox.synthesize_input(ncols=8, nlev=137, seed=0)
    c = _config("default", "nolregcl")
    s = port_ad_state(state, np.float64, c, dt)
    tends_ad, diags_ad = cloudsc2_ad(s, dt, c)
    primals = tuple(s[n] for n in INCREMENT_FIELDS)

    def nl(*fields):
        return cloudsc2_nl({**s, **dict(zip(INCREMENT_FIELDS, fields))}, dt, c)

    (tends_nl, diags_nl), vjp_fn = torch.func.vjp(nl, *primals)
    seeds = ({n: s["tnd_" + n + "_i"] for n in tends_nl}, {n: s[n + "_i"] for n in diags_nl})
    cot = dict(zip(INCREMENT_FIELDS, vjp_fn(seeds)))
    got = {n: diags_ad[n + "_i"] for n in AD_COTANGENT_FIELDS}
    got.update({"tnd_cml_" + n: tends_ad["cml_" + n + "_i"] for n in TEND_NAMES})
    for n, g in got.items():
        b = cot[n].numpy()
        scale = np.abs(b).max() + 1e-300
        np.testing.assert_allclose(g.numpy() / scale, b / scale, rtol=2e-7, atol=2e-7, err_msg=n)


def test_plain_ad_transpose_against_oracle_random_cotangents():
    """<M_oracle dx, y> == <dx, AD(y)> per column for random output
    cotangents y, with M the independent scalar TL oracle (LREGCL on)."""
    from cloudsc2_tpu.oracle import oracle_tangent_linear

    _, state, dt = iox.synthesize_input(ncols=10, nlev=137, seed=0)
    c = _config("default", "lregcl")
    s = port_state(state, np.float64, c)
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    nlev, ncols = s["ap"].shape
    tends_o, diags_o = oracle_tangent_linear({k: v.numpy() for k, v in s.items()}, dt, jax_constants(c))
    rng = np.random.default_rng(7)
    y = {"tnd_" + n + "_i": rng.standard_normal((nlev, ncols)) for n in TEND_NAMES}
    y.update({n + "_i": rng.standard_normal((nlev + 1 if n.startswith("f") else nlev, ncols))
              for n in DIAG_NAMES})
    lhs = sum(np.sum(tends_o[n + "_i"] * y["tnd_" + n + "_i"], axis=0) for n in TEND_NAMES)
    lhs = lhs + sum(np.sum(diags_o[n + "_i"] * y[n + "_i"], axis=0) for n in DIAG_NAMES)
    tends_ad, diags_ad = cloudsc2_ad({**s, **{k: torch.from_numpy(v) for k, v in y.items()}}, dt, c)
    rhs = sum(np.sum(s["tnd_cml_" + n + "_i"].numpy() * tends_ad["cml_" + n + "_i"].numpy(), axis=0)
              for n in TEND_NAMES)
    rhs = rhs + sum(np.sum(s[n + "_i"].numpy() * diags_ad[n + "_i"].numpy(), axis=0) for n in FIELD_PAIRS)
    scale = np.maximum(np.abs(lhs), np.abs(rhs)).max()
    np.testing.assert_allclose(lhs / scale, rhs / scale, rtol=0, atol=5e-9)


def test_cuadjtqs_ad_matches_vjp_and_jax():
    """The hand-written saturation-adjustment adjoint is the transpose of
    the scheme: its cotangents match torch.func.vjp of cuadjtqs_nl, and
    the JAX cuadjtqs_ad's."""
    import jax.numpy as jnp

    from cloudsc2_tpu.physics.cuadjtqs import cuadjtqs_ad as jadj

    rng = np.random.default_rng(7)
    n = 256
    ap = rng.uniform(2e4, 1e5, n)
    t = rng.uniform(210.0, 310.0, n)
    q = rng.uniform(1e-6, 2e-2, n)
    ct_t = rng.standard_normal(n)
    ct_q = rng.standard_normal(n)
    c = CONFIGS["default"]()
    tt = [torch.from_numpy(a) for a in (ap, t, q, ct_t, ct_q)]
    (t2, q2), vjp = torch.func.vjp(lambda a, x, y: cuadjtqs_nl(a, x, y, c), *tt[:3])
    ap_ref, t_ref, q_ref = vjp((tt[3], tt[4]))
    ap_i, t2h, t_i, q2h, q_i = cuadjtqs_ad(tt[0], torch.zeros_like(tt[0]), tt[1], tt[3], tt[2], tt[4], c)
    np.testing.assert_allclose(t2h.numpy(), t2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(q2h.numpy(), q2.numpy(), rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(t_i.numpy(), t_ref.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(q_i.numpy(), q_ref.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ap_i.numpy(), ap_ref.numpy(), rtol=1e-9, atol=1e-16)
    want = jadj(*(jnp.asarray(a) for a in (ap, np.zeros(n), t, ct_t, q, ct_q)), jax_constants(c))
    for g, w in zip((ap_i, t2h, t_i, q2h, q_i), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-16)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_ad_f32_matches_pallas_interpret(cfg):
    from cloudsc2_tpu.pallas.adjoint import cloudsc2_ad_pallas

    _, state, dt = iox.synthesize_input(ncols=1024, nlev=53, seed=0, dtype=np.float32)
    c = CONFIGS[cfg]()
    s = port_ad_state(state, np.float32, c, dt)
    got = flat(cloudsc2_ad(s, dt, c))
    want = flat(cloudsc2_ad_pallas(as_jax(s), dt, jax_constants(c), interpret=True, wb=128))
    assert_ad(got, want, np.float32, cfg, wide=PALLAS_F32_WIDE)


def test_component_runs_the_plain_ad(synth, ad64):
    _, dt = synth
    s, want, _ = ad64["ldrain1d", "lregcl"]
    grid = iox.synthesize_input(ncols=32, nlev=137, seed=0)[0]
    ad = Cloudsc2AD(grid, _config("ldrain1d", "lregcl"), enable_checks=True)
    assert ad.name == "cloudsc2_ad"
    got = flat(ad(s, dt))
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    with pytest.raises(KeyError, match="clc_i"):
        ad({k: v for k, v in s.items() if k != "clc_i"}, dt)


def test_ad_component_without_lphylin_on_cpu_tensors_does_not_warn():
    """Cloudsc2AD with LPHYLIN=False on CPU tensors runs the plain AD, as
    with LPHYLIN=True, bitwise and without a warning (on CUDA tensors it
    runs the kernels, bitwise their LPHYLIN=True launch,
    tests/test_torch_cuda.py)."""
    import warnings

    from cloudsc2_tpu_torch.grid import Grid

    c = CONFIGS["default"]().replace(LPHYLIN=False)
    _, state, dt = iox.synthesize_input(ncols=8, nlev=29, seed=1)
    s = port_ad_state(state, np.float64, c, dt)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = flat(Cloudsc2AD(Grid(ncols=8, nlev=29), c)(s, dt))
    want = flat(cloudsc2_ad(s, dt, c))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
