# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's symmetry protocol (cloudsc2_tpu_torch.validation.symmetry)
and its driver (drivers/run_symmetry_test_torch.py) vs the JAX package.

* On 32 columns in f64, in the four configurations of
  tests/test_adjoint.py:46-100 (LREGCL on and off, LEVAPLS2, LDRAIN1D): the
  error is below 200 machine epsilons (the JAX exactness gate; the adjoint
  is the exact transpose of the TL), and the per-column norms equal the JAX
  ``SymmetryTest``'s to rtol 1e-10 (the same protocol on the same inputs,
  reduced by two libraries).
* The verdict (``validate``) is the JAX module's: the same error on crafted
  norms.
* The driver prints HOORAY on the CPU, in f64 and in f32, and refuses a
  CUDA device that is not there.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.validation.symmetry import SymmetryTest
from tests.torch_helpers import CONFIGS, as_jax, jax_constants

torch.set_num_threads(1)

SYMMETRY_CONFIGS = {
    "lregcl": lambda: CONFIGS["default"](),
    "nolregcl": lambda: CONFIGS["default"]().replace(LREGCL=False),
    "levapls2": lambda: CONFIGS["levapls2"](),
    "ldrain1d": lambda: CONFIGS["ldrain1d"](),
}


@pytest.fixture(scope="module")
def state32():
    _, state, dt = iox.synthesize_input(ncols=32, nlev=137, seed=0)
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    return s, dt


@pytest.mark.parametrize("cfg", list(SYMMETRY_CONFIGS))
def test_symmetry_exact_and_norms_match_jax_f64(state32, cfg):
    from cloudsc2_tpu.validation.symmetry import SymmetryTest as JaxSymmetryTest

    s, dt = state32
    c = SYMMETRY_CONFIGS[cfg]()
    st = SymmetryTest(constants=c)
    norm1, norm2 = st.run(s, dt)
    assert norm1.shape == norm2.shape == (32,) and norm1.dtype == np.float64
    assert np.abs(norm1).max() > 0, "dead TL pipeline: all norms zero"
    err = st.validate(norm1, norm2, verbose=False)
    assert err < 200.0, err
    ref1, ref2 = JaxSymmetryTest(constants=jax_constants(c)).run(as_jax(s), dt)
    np.testing.assert_allclose(norm1, ref1, rtol=1e-10, atol=0)
    np.testing.assert_allclose(norm2, ref2, rtol=1e-10, atol=0)


def test_validate_matches_jax(capsys):
    from cloudsc2_tpu.validation.symmetry import SymmetryTest as JaxSymmetryTest

    c = CONFIGS["default"]()
    rng = np.random.default_rng(3)
    for dtype in (np.float64, np.float32):
        n2 = rng.uniform(0.5, 2.0, 50).astype(dtype)
        n1 = (n2 * (1 + rng.uniform(-1e3, 1e3, 50) * np.finfo(dtype).eps)).astype(dtype)
        n2[3] = 0.0
        got = SymmetryTest(constants=c).validate(n1, n2)
        want = JaxSymmetryTest(constants=jax_constants(c)).validate(n1, n2)
        assert got == want
    out = capsys.readouterr().out
    assert out.count("HOORAY") + out.count("failed") == 4


@pytest.mark.parametrize("argv", [
    ["--precision", "double"],
    ["--precision", "single", "--num-cols", "16"],
])
def test_driver_prints_hooray_on_cpu(argv, capsys):
    from drivers.run_symmetry_test_torch import main

    rc = main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "HOORAY" in out


def test_driver_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from drivers.run_symmetry_test_torch import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--device", "cuda", "--num-cols", "8"])
