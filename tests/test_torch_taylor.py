# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's Taylor protocol (cloudsc2_tpu_torch.validation.taylor) and
its driver (drivers/run_taylor_test_torch.py) vs the JAX package.

* The verdict code (``column_penalties``, ``validate``) is the JAX
  module's restated: the same penalties, exactly, on the crafted sequences
  and the 200 random sequences of tests/test_tl.py:310-377.
* On 4 columns in f64 the port's norms equal the JAX ``TaylorTest(impl=
  "scan")`` norms for λ = 1e-1 … 1e-4 to rtol 1e-8 (at smaller λ the norm
  is the quotient of a cancelled difference, and an ulp of the NL outputs
  moves it by 1e-16/λ), and the two verdicts are equal.
* On 100 columns in f64 with ``per_column``: per column the same norms for
  λ = 1e-1 … 1e-4 (rtol 1e-8), both verdicts pass, and the same penalties
  in 99 of 100 columns (below λ = 1e-5 the norms are rounding noise; see
  the test).
* The driver prints HOORAY on the CPU in f64.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.validation.taylor import FLOORS, FLOORS_PER_COLUMN, TaylorTest
from tests.torch_helpers import as_jax, jax_constants

torch.set_num_threads(1)

#: the crafted sequences of tests/test_tl.py:317-330
CRAFTED = np.array([
    [1.3, 1.05, 1.008, 1.002, 1.00005, 1.002, 1.05, 1.2, 1.4, 1.9],
    [1.3, 1.2, 1.1, 1.05, 1.02, 1.01, 1.005, 1.002, 1.001, 1.0005],
    [9.0, 9.0, 9.0, 9.0, 1.3, 1.05, 1.01, 1.05, 1.3, 2.0],
    [9.0] * 10,
    [1.3, 1.05, 1.01, 1.05, 1.01, 1.005, 1.05, 1.2, 1.4, 1.9],
    [1.3, 1.05, 1.002, 1.00002, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
])


@pytest.fixture(scope="module")
def constants():
    return make_constants(lphylin=True, ldrain1d=False)


def _jax_taylor():
    from cloudsc2_tpu.validation import taylor as jt

    return jt


@pytest.mark.parametrize("strict", [True, False])
def test_column_penalties_match_jax(strict):
    jt = _jax_taylor()
    seqs = np.vstack([CRAFTED, np.random.default_rng(0).uniform(0.0, 2.5, size=(200, 10))])
    for mode in ("f64", "f32"):
        floor7, floor5 = FLOORS[mode]
        got = TaylorTest.column_penalties(seqs.T, floor7, floor5, strict=strict)
        want = jt.TaylorTest.column_penalties(seqs.T, floor7, floor5, strict=strict)
        np.testing.assert_array_equal(got, want)
    assert FLOORS == jt.FLOORS and FLOORS_PER_COLUMN == jt.FLOORS_PER_COLUMN


def test_validate_matches_jax(constants):
    """The scalar verdict on every sequence, under each floor calibration,
    and the per-column verdict on crafted batches."""
    jt = _jax_taylor()
    seqs = np.vstack([CRAFTED, np.random.default_rng(0).uniform(0.0, 2.5, size=(200, 10))])
    for floors in ("f64", "f32"):
        port = TaylorTest(constants=constants, floors=floors)
        ref = jt.TaylorTest(constants=jax_constants(constants), floors=floors)
        for seq in seqs:
            assert port.validate(seq, verbose=False) == ref.validate(seq, verbose=False), seq
    for floors in ("f64", "f32"):
        for mat in (np.repeat(CRAFTED[:1].T, 4, axis=1), CRAFTED.T, seqs[:50].T):
            kw = dict(per_column=True, floors=floors, min_strict_fraction=0.0)
            port = TaylorTest(constants=constants, **kw)
            ref = jt.TaylorTest(constants=jax_constants(constants), **kw)
            assert port.validate(mat, verbose=False) == ref.validate(mat, verbose=False)
            assert port.strict_fraction == ref.strict_fraction


@pytest.fixture(scope="module")
def synth4():
    grid, state, dt = iox.synthesize_input(ncols=100, nlev=137, seed=0)
    return grid, state, dt


def _port_state(state_np):
    s = state_from_numpy(state_np, torch.device("cpu"), torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    return s


def test_taylor_norms_match_jax_f64(synth4, constants):
    _, state, dt = synth4
    s = _port_state({k: v[:, :4] for k, v in state.items()})
    port = TaylorTest(constants=constants)
    got = port.run(s, dt)
    ref = _jax_taylor().TaylorTest(constants=jax_constants(constants), impl="scan")
    want = ref.run(as_jax(s), dt)
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-8, atol=0)
    assert port.validate(verbose=False) == ref.validate(verbose=False) <= 5


def test_per_column_penalties_match_jax_f64(synth4, constants):
    """Per column, the norms for λ = 1e-1 … 1e-4 equal the JAX ones to rtol
    1e-8 in every column, both verdicts pass, and the adapted machine's
    penalties are the same in 99 of the 100 columns.  Below λ = 1e-5,
    ``|1 - norm|`` is the rounding noise of a cancelled NL difference
    (1e-8 … 1e-4, measured), which XLA's compiled scan and the port round
    differently: there one column's tail moves its minimum past a bump
    above the +5 floor (penalty 10 vs 0; the verdict, the penalty of the
    98th percentile column, becomes 5 vs 0), and the strict machine, which
    scores every post-bottom wiggle, differs in 18 of 100 columns."""
    _, state, dt = synth4
    s = _port_state(state)
    port = TaylorTest(constants=constants, per_column=True)
    ref = _jax_taylor().TaylorTest(constants=jax_constants(constants), per_column=True, impl="scan")
    got, want = port.run(s, dt), ref.run(as_jax(s), dt)
    assert got.shape == want.shape == (10, 100)
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-8, atol=0)
    floor7, floor5 = FLOORS_PER_COLUMN["f64"]
    pen = TaylorTest.column_penalties(got, floor7, floor5)
    assert (pen == ref.column_penalties(want, floor7, floor5)).sum() >= 99
    assert port.validate(verbose=False) <= 5 and ref.validate(verbose=False) <= 5
    assert (pen <= 5).mean() >= port.pass_fraction and port.strict_fraction >= port.min_strict_fraction


@pytest.mark.parametrize("argv", [
    [],
    ["--num-cols", "8", "--tile-column"],
    ["--num-cols", "16", "--per-column"],
    ["--precision", "single", "--num-cols", "8", "--tile-column", "--floors", "auto"],
])
def test_driver_prints_hooray_on_cpu(argv, capsys):
    from drivers.run_taylor_test_torch import main

    rc = main(["--device", "cpu", *(["--precision", "double"] if "--precision" not in argv else []), *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "HOORAY" in out
