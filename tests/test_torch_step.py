# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's step functions (cloudsc2_tpu_torch.parallel.step) against the
JAX package's (cloudsc2_tpu.parallel.step), on the CPU, where they run the
plain versions.

* ``forward_step``, fused and unfused, against JAX ``forward_step(impl=
  "scan")`` at 100 x 137: f64 at the golden double gate (rtol 1e-10, atol
  1e-16); f32 at the gate of the port's NL-vs-JAX f32 tests
  (tests/test_torch_nonlinear.py: rtol 2e-5, atol 1e-8 on tendencies and
  1e-6 on diagnostics, fhps* with the flux-residue atol of
  ``utils/compare.nl_tolerances``).  The fused step's ``qsat`` is the
  saturation of the state.  With ``eta`` passed in it is bitwise the step
  with ``eta`` derived.
* ``full_step`` against JAX ``full_step`` in f64 (8 x 137): per-column
  norms and NL tendencies at rtol 1e-10; its NL tendencies are bitwise its
  TL's forward tendencies, and within f64 rounding of the NL scheme's
  (tests/test_parallel.py:96).
"""
import jax
import numpy as np
import pytest
import torch

from cloudsc2_tpu.parallel.step import forward_step as jax_forward_step
from cloudsc2_tpu.parallel.step import full_step as jax_full_step
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.parallel.step import forward_step, full_step
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.utils.compare import DIAGNOSTICS, TENDENCIES, nl_tolerances
from tests.torch_helpers import CONFIGS, TORCH, assert_fields, flat, jax_constants

torch.set_num_threads(1)

GOLDEN_F64 = {n: (1e-10, 1e-16) for n in TENDENCIES + DIAGNOSTICS}


def _inputs(ncols, dtype):
    """The numpy state for JAX, and the same numbers as CPU tensors."""
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=137, seed=0, dtype=dtype)
    return state, state_from_numpy(state, torch.device("cpu"), TORCH[dtype]), dt


@pytest.fixture(scope="module")
def state100():
    return {dtype: _inputs(100, dtype) for dtype in (np.float64, np.float32)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_forward_step_matches_jax_scan(state100, dtype, fuse):
    import jax.numpy as jnp

    state_np, s, dt = state100[dtype]
    c = CONFIGS["default"]()
    tends, diags = forward_step(s, dt, c, fuse_saturation=fuse)
    want = flat(jax_forward_step({k: jnp.asarray(v) for k, v in state_np.items()}, dt, jax_constants(c),
                                 impl="scan"))
    tol = GOLDEN_F64 if dtype == np.float64 else nl_tolerances((2e-5, 1e-8), (2e-5, 1e-6), c, np.float32)
    got = flat((tends, diags))
    assert sorted(got) == sorted([*want, "qsat"])
    assert_fields({k: got[k] for k in want}, want, tol, f"fuse={fuse}")
    eta = eta_levels(s["ap"], s["aph"])
    qsat = saturation(s["ap"], s["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    np.testing.assert_array_equal(diags["qsat"].numpy(), qsat.numpy())
    # the step takes eta from the caller where given: bitwise the same step
    passed = flat(forward_step(dict(s, eta=eta), dt, c, fuse_saturation=fuse))
    for k, v in got.items():
        np.testing.assert_array_equal(passed[k], v, err_msg=k)


def test_forward_step_uses_the_given_eta(state100):
    """A caller's eta is not re-derived: another eta gives another step."""
    _, s, dt = state100[np.float64]
    c = CONFIGS["default"]()
    eta = eta_levels(s["ap"], s["aph"])
    base = forward_step(dict(s, eta=eta), dt, c)[0]["t"]
    other = forward_step(dict(s, eta=eta * 0.9), dt, c)[0]["t"]
    assert not torch.equal(base, other)


@pytest.fixture(scope="module")
def full8():
    state_np, s, dt = _inputs(8, np.float64)
    c = CONFIGS["default"]()
    got = full_step(s, dt, c)
    jstate = {k: jax.numpy.asarray(v) for k, v in state_np.items()}
    want = jax.jit(jax_full_step, static_argnums=(1, 2))(jstate, dt, jax_constants(c))
    return s, dt, c, got, want


def test_full_step_matches_jax_f64(full8):
    _, _, _, (tends, norm1, norm2), (jtends, jnorm1, jnorm2) = full8
    assert norm1.shape == norm2.shape == (8,) and norm1.dtype == torch.float64
    assert norm1.abs().max() > 0, "dead TL/AD pipeline: all norms zero"
    np.testing.assert_allclose(norm1.numpy(), np.asarray(jnorm1), rtol=1e-10, atol=0)
    np.testing.assert_allclose(norm2.numpy(), np.asarray(jnorm2), rtol=1e-10, atol=0)
    assert sorted(tends) == sorted(jtends)
    for n in tends:
        np.testing.assert_allclose(tends[n].numpy(), np.asarray(jtends[n]), rtol=1e-10, atol=1e-16, err_msg=n)
    # the adjoint identity per column, as the symmetry protocol gates it
    eps = np.finfo(np.float64).eps
    err = (norm1 - norm2).abs() / (eps * norm2.abs())
    assert err.max() < 1e4, err.max()


def test_full_step_reuses_tl_forward(full8):
    """``full_step``'s NL tendencies are bitwise the TL's forward tendencies
    on the same state (no NL step of their own), and agree with the NL
    scheme to f64 rounding relative to each field's scale."""
    s, dt, c, (tends, _, _), _ = full8
    x = dict(s, eta=eta_levels(s["ap"], s["aph"]))
    x["qsat"] = saturation(x["ap"], x["t"], kflag=1, lphylin=c.LPHYLIN, c=c)
    tl_tends = cloudsc2_tl(dict(x, **state_increment(x, 0.01, ignore_supsat=True)), dt, c)[0]
    nl_tends = cloudsc2_nl(x, dt, c)[0]
    for n in ("t", "q", "ql", "qi"):
        np.testing.assert_array_equal(tends[n].numpy(), tl_tends[n].numpy(), err_msg=n)
        scale = nl_tends[n].abs().max().item() + 1e-300
        np.testing.assert_allclose(tends[n].numpy() / scale, nl_tends[n].numpy() / scale, atol=1e-13, err_msg=n)
