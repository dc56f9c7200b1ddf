# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's plain NL scheme (cloudsc2_tpu_torch.physics.nonlinear,
the plain version of the CUDA kernel) vs the JAX package and the oracle.

* f64 vs ``cloudsc2_tpu.physics.nonlinear.cloudsc2_nl`` (lax.scan) and vs
  the scalar oracle at 100 x 137 for the default, LEVAPLS2 and LDRAIN1D:
  rtol 1e-10, atol 1e-13, the tolerance tests/test_nonlinear.py holds the
  JAX scheme to against the oracle.
* f32 vs the Pallas kernel in interpret mode at 1024 x 53, wb=128, as
  tests/test_pallas.py runs it: rtol 2e-5, atol 1e-8 on the tendencies and
  1e-6 on the diagnostics.  fhps* = -L * fpls* are fpls* scaled by L ~
  2.5e6, so their atol is L times the flux residue of
  ``cloudsc2_tpu_torch.utils.compare.flux_residue`` (a fully evaporated
  flux leaves a few-ulp residue of either sign, which differs between
  PyTorch's and XLA's exp).
* ``with_trajectory`` (f32, 1024 x 53) vs the Pallas kernel's trajectory
  at the tolerances of the fluxes and covptot.
* invariants and the four robustness states of tests/test_robustness.py.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu.oracle import oracle_nonlinear
from cloudsc2_tpu.physics.nonlinear import cloudsc2_nl as jax_nl
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.utils.compare import DIAGNOSTICS, TENDENCIES, nl_tolerances
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

F64_TOL = {n: (1e-10, 1e-13) for n in TENDENCIES + DIAGNOSTICS}


@pytest.fixture(scope="module")
def synth64():
    _, state, dt = iox.synthesize_input(ncols=100, nlev=137, seed=0)
    return state, dt


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_nl_matches_jax_scan_f64(synth64, cfg):
    state, dt = synth64
    c = CONFIGS[cfg]()
    got = flat(cloudsc2_nl(port_state(state, np.float64, c), dt, c))
    want = flat(jax_nl(jax_state(state, np.float64, c), dt, jax_constants(c)))
    assert_fields(got, want, F64_TOL, cfg)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_nl_matches_oracle_f64(synth64, cfg):
    state, dt = synth64
    c = CONFIGS[cfg]()
    s = port_state(state, np.float64, c)
    got = flat(cloudsc2_nl(s, dt, c))
    want = oracle_nonlinear({k: v.numpy() for k, v in s.items()}, dt, jax_constants(c))
    assert_fields(got, {**want[0], **want[1]}, F64_TOL, cfg)


@pytest.fixture(scope="module")
def synth32_small():
    _, state, dt = iox.synthesize_input(ncols=1024, nlev=53, seed=0, dtype=np.float32)
    return state, dt


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_nl_f32_matches_pallas_interpret(synth32_small, cfg):
    from cloudsc2_tpu.pallas.nonlinear import cloudsc2_nl_pallas

    state, dt = synth32_small
    c = CONFIGS[cfg]()
    got = flat(cloudsc2_nl(port_state(state, np.float32, c), dt, c))
    want = flat(cloudsc2_nl_pallas(jax_state(state, np.float32, c), dt, jax_constants(c), interpret=True, wb=128))
    tol = nl_tolerances((2e-5, 1e-8), (2e-5, 1e-6), c, np.float32)
    assert_fields(got, want, tol, cfg)


@pytest.mark.parametrize("cfg", ["default", "levapls2"])
def test_plain_nl_f32_trajectory_matches_pallas_interpret(synth32_small, cfg):
    """``with_trajectory``: the carry entering each level, as the Pallas
    kernel's ``with_trajectory`` returns it (``c_cov`` only with
    evaporation), at the NL tolerances of the fluxes and of covptot; the
    step's outputs are those of the call without it, bitwise."""
    from cloudsc2_tpu.pallas.nonlinear import cloudsc2_nl_pallas

    state, dt = synth32_small
    c = CONFIGS[cfg]()
    s = port_state(state, np.float32, c)
    tends, diags, traj = cloudsc2_nl(s, dt, c, with_trajectory=True)
    plain = flat(cloudsc2_nl(s, dt, c))
    for k, v in flat((tends, diags)).items():
        np.testing.assert_array_equal(v, plain[k], err_msg=k)
    want = cloudsc2_nl_pallas(jax_state(state, np.float32, c), dt, jax_constants(c), interpret=True,
                              wb=128, with_trajectory=True)[2]
    assert sorted(traj) == sorted(want)
    tol = nl_tolerances((2e-5, 1e-8), (2e-5, 1e-6), c, np.float32)
    names = {"c_rfl": "fplsl", "c_sfl": "fplsn", "c_cov": "covptot"}
    assert_fields({k: v.numpy() for k, v in traj.items()}, {k: np.asarray(v) for k, v in want.items()},
                  {k: tol[names[k]] for k in want}, cfg)


def test_plain_nl_invariants(synth64):
    """clc in [0, 1], fluxes >= 0 and > 0 somewhere, no NaN; fhps* are the
    exact scalings of fpls*; covptot is 0 with evaporation off."""
    state, dt = synth64
    c = CONFIGS["default"]()
    out = cloudsc2_nl(port_state(state, np.float64, c), dt, c)
    assert_physical(out)
    f = flat(out)
    assert f["fplsl"].max() > 0 and f["fplsn"].max() > 0 and f["clc"].max() > 0
    np.testing.assert_array_equal(f["fhpsl"], -f["fplsl"] * c.RLVTT)
    np.testing.assert_array_equal(f["fhpsn"], -f["fplsn"] * c.RLSTT)
    assert (f["fplsl"][0] == 0).all() and (f["covptot"] == 0).all()
    assert f["t"].shape == (137, 100) and f["fplsl"].shape == (138, 100)


def test_plain_nl_columns_independent(synth64):
    """A column subset gives bitwise the same columns."""
    state, dt = synth64
    c = CONFIGS["default"]()
    s = port_state(state, np.float64, c)
    full = flat(cloudsc2_nl(s, dt, c))
    sub = {k: (v if v.dim() == 1 else v[:, 10:20].contiguous()) for k, v in s.items()}
    part = flat(cloudsc2_nl(sub, dt, c))
    for k in full:
        np.testing.assert_array_equal(full[k][:, 10:20], part[k], err_msg=k)


@pytest.mark.parametrize("case", ROBUST_CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_nl_finite(case, dtype):
    c = CONFIGS["default"]()
    s, dt = robust_state(case, dtype, c)
    assert_physical(cloudsc2_nl(s, dt, c))
