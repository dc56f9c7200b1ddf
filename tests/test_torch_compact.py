# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""``CUADJ_COMPACT=False``, the reference-shaped saturation adjustment
(``cloudsc2_tpu/physics/cuadjtqs.py:75-81``, its TL form at ``:134-143``, its
adjoint at ``:226-256``), on the CPU.

Tolerances:

* The plain NL, TL and AD with ``CUADJ_COMPACT=False`` against the JAX
  scans (``cloudsc2_nl`` / ``cloudsc2_tl`` / ``cloudsc2_ad``) in f64, at the
  gates each is held to in its compact form: NL rtol 1e-10, atol 1e-13;
  TL rtol 1e-10 with an atol of 1e-12 of each field's largest magnitude;
  AD every field within 1e-10 of its largest magnitude (``ad_limit``).
* The kernels' bodies built for the host (NL, TL, two-kernel AD, fused AD)
  against the plain versions in that form, f64: NL and TL rtol 1e-12, atol
  1e-13 (tests/test_torch_kernel_host.py's gate), AD ``ad_limit``; the fused
  body bitwise the two-kernel one.
* The port's ``cuadjtqs_ad`` against ``torch.func.vjp`` of its
  ``cuadjtqs_nl`` in both forms (as tests/test_adjoint.py:153-186: rtol
  1e-12 on the forward values, 1e-9 on the cotangents) and against the JAX
  ``cuadjtqs_ad`` (rtol 1e-12); the compact form against the reference
  form (rtol 1e-12 on t, 1e-11 with atol 1e-18 on q, as
  tests/test_nonlinear.py:179-196); the port's TL form against the JAX
  ``cuadjtqs_tl`` (rtol and scaled atol 1e-13).
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu_torch.physics.cuadjtqs import cuadjtqs_ad, cuadjtqs_nl, cuadjtqs_tl
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from tests.torch_helpers import (
    CONFIGS,
    as_jax,
    assert_ad,
    assert_fields,
    assert_scaled,
    flat,
    jax_constants,
    port_ad_state,
    port_state,
    port_tl_state,
)

torch.set_num_threads(1)

CFGS = ("default", "levapls2")


def _ref(cfg):
    return CONFIGS[cfg]().replace(CUADJ_COMPACT=False)


@pytest.fixture(scope="module")
def synth64():
    _, state, dt = iox.synthesize_input(ncols=16, nlev=137, seed=1)
    return state, dt


@pytest.fixture(scope="module")
def scans(synth64):
    """Per configuration, in the reference form: the states and the JAX
    scans' NL, TL and AD on them (JAX traces each once, here)."""
    from cloudsc2_tpu.physics.adjoint import cloudsc2_ad as jad
    from cloudsc2_tpu.physics.nonlinear import cloudsc2_nl as jnl
    from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl as jtl

    state, dt = synth64
    out = {}
    for cfg in CFGS:
        c = _ref(cfg)
        jc = jax_constants(c)
        s = port_state(state, np.float64, c)
        st = port_tl_state(state, np.float64, c)
        sa = port_ad_state(state, np.float64, c, dt)
        out[cfg] = {
            "nl": (s, flat(jnl(as_jax(s), dt, jc))),
            "tl": (st, flat(jtl(as_jax(st), dt, jc))),
            "ad": (sa, flat(jad(as_jax(sa), dt, jc))),
        }
    return out


@pytest.mark.parametrize("cfg", CFGS)
def test_plain_nl_matches_jax_scan_f64(synth64, scans, cfg):
    _, dt = synth64
    s, want = scans[cfg]["nl"]
    got = flat(cloudsc2_nl(s, dt, _ref(cfg)))
    assert got.keys() == want.keys()
    assert_fields(got, want, {n: (1e-10, 1e-13) for n in want}, cfg)


@pytest.mark.parametrize("cfg", CFGS)
def test_plain_tl_matches_jax_scan_f64(synth64, scans, cfg):
    _, dt = synth64
    s, want = scans[cfg]["tl"]
    got = flat(cloudsc2_tl(s, dt, _ref(cfg)))
    assert got.keys() == want.keys() and len(want) == 20
    assert_scaled(got, want, 1e-10, 1e-12, cfg)


@pytest.mark.parametrize("cfg", CFGS)
def test_plain_ad_matches_jax_scan_f64(synth64, scans, cfg):
    _, dt = synth64
    s, want = scans[cfg]["ad"]
    got = flat(cloudsc2_ad(s, dt, _ref(cfg)))
    assert len(want) == 26
    assert_ad(got, want, np.float64, cfg)


@pytest.mark.parametrize("kernel", ["nl", "tl", "ad", "ad fused"])
@pytest.mark.parametrize("cfg", CFGS)
def test_host_bodies_match_plain_f64(synth64, scans, cfg, kernel):
    """The kernels' host bodies in the reference form against the plain
    versions in it; the fused AD bitwise the two-kernel AD."""
    _, dt = synth64
    c = _ref(cfg)
    if kernel in ("nl", "tl"):
        s = scans[cfg][kernel][0]
        host, plain = (nlk.cloudsc2_nl_host, cloudsc2_nl) if kernel == "nl" else (tlk.cloudsc2_tl_host, cloudsc2_tl)
        got, want = flat(host(s, dt, c)), flat(plain(s, dt, c))
        assert got.keys() == want.keys()
        assert_fields(got, want, {n: (1e-12, 1e-13) for n in want}, f"{kernel} {cfg}")
        return
    s = scans[cfg]["ad"][0]
    got = flat(adk.cloudsc2_ad_host(s, dt, c))
    assert_ad(got, flat(cloudsc2_ad(s, dt, c)), np.float64, cfg)
    if kernel == "ad fused":
        for resident in (False, True):
            fused = flat(adk.cloudsc2_ad_fused_host(s, dt, c, resident=resident))
            for k in got:
                np.testing.assert_array_equal(fused[k], got[k], err_msg=f"resident={resident} {k}")


def _points(seed, n=256):
    rng = np.random.default_rng(seed)
    ap = rng.uniform(2e4, 1e5, n)
    t = rng.uniform(210.0, 310.0, n)
    q = rng.uniform(1e-6, 2e-2, n)
    return ap, t, q, rng


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "reference"])
def test_cuadjtqs_ad_matches_vjp_and_jax(compact):
    """The port's cuadjtqs_ad (both forms) against torch.func.vjp of its
    cuadjtqs_nl and against the JAX cuadjtqs_ad (tests/test_adjoint.py:153-186)."""
    from cloudsc2_tpu.physics.cuadjtqs import cuadjtqs_ad as jadj

    ap, t, q, rng = _points(7)
    ct_t, ct_q = rng.standard_normal(ap.size), rng.standard_normal(ap.size)
    c = CONFIGS["default"]().replace(CUADJ_COMPACT=compact)
    tt = [torch.from_numpy(a) for a in (ap, t, q, ct_t, ct_q)]
    (t2, q2), vjp = torch.func.vjp(lambda a, x, y: cuadjtqs_nl(a, x, y, c), tt[0], tt[1], tt[2])
    ap_ref, t_ref, q_ref = vjp((tt[3], tt[4]))
    ap_i, t2h, t_i, q2h, q_i = cuadjtqs_ad(tt[0], torch.zeros_like(tt[0]), tt[1], tt[3], tt[2], tt[4], c)
    np.testing.assert_allclose(t2h.numpy(), t2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(q2h.numpy(), q2.numpy(), rtol=1e-12, atol=1e-18)
    for got, want, atol, name in ((t_i, t_ref, 1e-12, "t_i"), (q_i, q_ref, 1e-12, "q_i"),
                                  (ap_i, ap_ref, 1e-16, "ap_i")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=atol, err_msg=name)
    want = jadj(ap, np.zeros_like(ap), t, ct_t, q, ct_q, jax_constants(c))
    for got, w, name in zip((ap_i, t2h, t_i, q2h, q_i), want, ("ap_i", "t", "t_i", "q", "q_i")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-12, atol=1e-30, err_msg=name)


def test_cuadjtqs_compact_matches_reference_form():
    """CUADJ_COMPACT is exact algebra: the compact quotient agrees with the
    reference-shaped form to f64 rounding (tests/test_nonlinear.py:179-196),
    and the port's reference form is the JAX one's."""
    from cloudsc2_tpu.physics.cuadjtqs import cuadjtqs_nl as jnl

    rng = np.random.default_rng(11)
    n = 4096
    ap = rng.uniform(2e3, 1.1e5, n)
    t = rng.uniform(180.0, 320.0, n)
    q = rng.uniform(0.0, 3e-2, n)
    c = CONFIGS["default"]()
    tt = [torch.from_numpy(a) for a in (ap, t, q)]
    t_c, q_c = cuadjtqs_nl(*tt, c)
    t_r, q_r = cuadjtqs_nl(*tt, c.replace(CUADJ_COMPACT=False))
    np.testing.assert_allclose(t_c.numpy(), t_r.numpy(), rtol=1e-12)
    np.testing.assert_allclose(q_c.numpy(), q_r.numpy(), rtol=1e-11, atol=1e-18)
    j_t, j_q = jnl(ap, t, q, jax_constants(c.replace(CUADJ_COMPACT=False)))
    np.testing.assert_allclose(t_r.numpy(), np.asarray(j_t), rtol=1e-14)
    np.testing.assert_allclose(q_r.numpy(), np.asarray(j_q), rtol=1e-13, atol=1e-20)


def test_cuadjtqs_tl_reference_form_matches_jax():
    from cloudsc2_tpu.physics.cuadjtqs import cuadjtqs_tl as jtl

    ap, t, q, rng = _points(5, 512)
    pert = [0.01 * x * rng.uniform(-1, 1, ap.size) for x in (ap, t, q)]
    c = CONFIGS["default"]().replace(CUADJ_COMPACT=False)
    got = cuadjtqs_tl(*(torch.from_numpy(a) for a in (ap, pert[0], t, pert[1], q, pert[2])), c)
    want = jtl(*(np.asarray(a) for a in (ap, pert[0], t, pert[1], q, pert[2])), jax_constants(c))
    assert_scaled(
        {n: g.numpy() for n, g in zip(("t", "t_i", "q", "q_i"), got)},
        {n: np.asarray(w) for n, w in zip(("t", "t_i", "q", "q_i"), want)},
        1e-13, 1e-13,
    )
