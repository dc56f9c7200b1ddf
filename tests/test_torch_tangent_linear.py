# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's plain TL scheme (cloudsc2_tpu_torch.physics.tangent_linear,
the plain version of the CUDA TL kernel) and its pieces vs the JAX package.

* increment / perturbed state: bitwise equal to JAX in f64; ``cuadjtqs_tl``
  to rtol 1e-13, atol 1e-13 x the output's largest magnitude (the same
  operations in the same order; PyTorch's and XLA's exp differ by an ulp).
* f64 vs ``cloudsc2_tpu.physics.tangent_linear.cloudsc2_tl`` (lax.scan) at
  100 x 137 for the default, LEVAPLS2 and LDRAIN1D, LREGCL on and off:
  rtol 1e-10, atol 1e-12 x the field's largest magnitude -- the oracle gates
  of tests/test_tl.py (rtol 1e-9), tighter, since here the two are the same
  algorithm.
* f64 vs the scalar oracle ``oracle_tangent_linear`` at the JAX gates (rtol
  1e-9, atol 1e-12 x max), on 20 columns x 137 and, for the evaporation
  branch, 8 x 30.
* f32 vs ``cloudsc2_tl_pallas(interpret=True, wb=128)`` at 1024 x 53, at
  the TL tolerances of tests/test_pallas.py (rtol 3e-5; atol 1e-7 on the
  tendencies, 1e-5 on the diagnostics; fhps* with the flux-residue atol of
  ``utils.compare.nl_tolerances``; the perturbations at least 1e-3 of
  their scale, see ``_tl_f32_tolerances``), also with ``tangent_only``;
  and vs the JAX scan run op by op, to 2e-6 of each field's scale.
* with LREGCL off, the TL equals ``torch.func.jvp`` of the plain NL at the
  tolerance of tests/test_tl.py:38-69 (2e-7 of 1% of the field's scale),
  8 x 30, evaporation off and on.
* the TL's forward outputs equal the plain NL's (rtol 5e-12, atol 1e-16, as
  tests/test_tl.py:22-35) and a zero increment gives zero perturbations.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu.oracle import oracle_tangent_linear
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.components import Cloudsc2TL, PerturbedState, StateIncrement
from cloudsc2_tpu_torch.physics.cuadjtqs import cuadjtqs_tl
from cloudsc2_tpu_torch.physics.increment import INCREMENT_FIELDS, perturbed_state, state_increment
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from cloudsc2_tpu_torch.utils.compare import flux_residue, nl_tolerances
from tests.torch_helpers import (
    CONFIGS,
    ROBUST_CASES,
    as_jax,
    assert_fields,
    assert_physical,
    assert_scaled,
    flat,
    jax_constants,
    port_state,
    port_tl_state,
    robust_state,
)

torch.set_num_threads(1)

LREGCL = {"lregcl": True, "nolregcl": False}


def _config(cfg, lregcl):
    return CONFIGS[cfg]().replace(LREGCL=LREGCL[lregcl])


@pytest.fixture(scope="module")
def synth64():
    _, state, dt = iox.synthesize_input(ncols=100, nlev=137, seed=0)
    return state, dt


@pytest.fixture(scope="module")
def tl64(synth64):
    """Per configuration: the port's TL state and the JAX TL scan's outputs
    on it (JAX traces its scan once per configuration, here)."""
    from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl as jtl

    state, dt = synth64
    out = {}
    for cfg in CONFIGS:
        for lregcl in LREGCL:
            c = _config(cfg, lregcl)
            s = port_tl_state(state, np.float64, c)
            out[cfg, lregcl] = s, flat(jtl(as_jax(s), dt, jax_constants(c)))
    return out


def test_increment_fields_and_functions_match_jax(synth64):
    from cloudsc2_tpu.physics import increment as jinc

    assert INCREMENT_FIELDS == jinc.INCREMENT_FIELDS
    state, _ = synth64
    c = CONFIGS["default"]()
    s = port_state(state, np.float64, c)
    js = as_jax(s)
    for ignore in (False, True):
        got = state_increment(s, 0.01, ignore_supsat=ignore)
        want = jinc.state_increment(js, 0.01, ignore_supsat=ignore)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    s.update(state_increment(s, 0.01))
    got = perturbed_state(s, 1e-3)
    want = jinc.perturbed_state(as_jax(s), 1e-3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_increment_components_match_functions(synth64):
    """StateIncrement / PerturbedState / Cloudsc2TL on CPU tensors give what
    the functions give (Cloudsc2TL: the plain version)."""
    state, dt = synth64
    c = CONFIGS["default"]()
    grid = iox.synthesize_input(ncols=100, nlev=137, seed=0)[0]
    s = port_state(state, np.float64, c)
    incr = StateIncrement(grid, c, 0.01, enable_checks=True)(s)
    for k, v in state_increment(s, 0.01).items():
        assert torch.equal(incr[k], v), k
    s.update(incr)
    pert = PerturbedState(grid, c, 1e-3, enable_checks=True)(s)
    for k in INCREMENT_FIELDS:
        assert torch.equal(pert[k], perturbed_state(s, 1e-3)[k]), k
    sub = {k: (v if v.dim() == 1 else v[:, :5].contiguous()) for k, v in s.items()}
    got = flat(Cloudsc2TL(grid, c)(sub, dt))
    want = flat(cloudsc2_tl(sub, dt, c))
    assert got.keys() == want.keys() and len(want) == 20
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cuadjtqs_tl_matches_jax():
    """The TL saturation adjustment on a spread of warm and cold, clipped
    and unclipped points: the JAX function's values in f64 to a few ulps."""
    from cloudsc2_tpu.physics.cuadjtqs import cuadjtqs_tl as jadj

    c = CONFIGS["default"]()
    rng = np.random.default_rng(5)
    n = 4000
    ap = rng.uniform(5e3, 1.05e5, n)
    t = rng.uniform(200.0, 310.0, n)
    q = rng.uniform(0.0, 0.03, n)
    pert = [0.01 * x * rng.uniform(-1, 1, n) for x in (ap, t, q)]
    got = cuadjtqs_tl(*(torch.from_numpy(a) for a in (ap, pert[0], t, pert[1], q, pert[2])), c)
    want = jadj(*(np.asarray(a) for a in (ap, pert[0], t, pert[1], q, pert[2])), jax_constants(c))
    assert_scaled(
        {n: g.numpy() for n, g in zip(("t", "t_i", "q", "q_i"), got)},
        {n: np.asarray(w) for n, w in zip(("t", "t_i", "q", "q_i"), want)},
        1e-13, 1e-13,
    )


@pytest.mark.parametrize("lregcl", list(LREGCL))
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_tl_matches_jax_scan_f64(synth64, tl64, cfg, lregcl):
    _, dt = synth64
    s, want = tl64[cfg, lregcl]
    got = flat(cloudsc2_tl(s, dt, _config(cfg, lregcl)))
    assert got.keys() == want.keys() and len(want) == 20
    assert_scaled(got, want, 1e-10, 1e-12, f"{cfg} {lregcl}")


@pytest.mark.parametrize("lregcl", list(LREGCL))
def test_plain_tl_matches_oracle(synth64, lregcl):
    state, dt = synth64
    c = _config("default", lregcl)
    sub = {k: v[:, :20] for k, v in state.items()}
    s = port_tl_state(sub, np.float64, c)
    tends_o, diags_o = oracle_tangent_linear({k: v.numpy() for k, v in s.items()}, dt, jax_constants(c))
    assert_scaled(flat(cloudsc2_tl(s, dt, c)), {**tends_o, **diags_o}, 1e-9, 1e-12, lregcl)


def test_plain_tl_matches_oracle_evaporation_branch():
    """LEVAPLS2 with LREGCL on: the oracle carries the exact derivatives at
    the two places where the JAX package departs from GT4Py (beta_i, b_i)."""
    _, state, dt = iox.synthesize_input(ncols=8, nlev=30, seed=0)
    c = _config("levapls2", "lregcl")
    s = port_tl_state(state, np.float64, c)
    tends_o, diags_o = oracle_tangent_linear({k: v.numpy() for k, v in s.items()}, dt, jax_constants(c))
    assert (diags_o["covptot"] != 0).any()  # the branch is active
    assert_scaled(flat(cloudsc2_tl(s, dt, c)), {**tends_o, **diags_o}, 1e-9, 1e-12)


@pytest.fixture(scope="module")
def synth32_small():
    _, state, dt = iox.synthesize_input(ncols=1024, nlev=53, seed=0, dtype=np.float32)
    return state, dt


def _tl_f32_tolerances(c, want):
    """The TL tolerances of tests/test_pallas.py; a perturbation field's
    atol is at least 1e-3 of its largest magnitude.  XLA compiles the
    kernel with its own re-association, and where the linearization
    amplifies a cancellation (``clc_i`` goes as ``1/sqrt(ratio)`` where
    ``qsat - qt`` cancels; a fully evaporated flux) a few points out of
    54,272 move by up to 3.5e-4 of the field's scale.  The same JAX
    function evaluated op by op agrees with the port there to 1e-6 of it
    (:func:`test_plain_tl_f32_matches_jax_op_by_op`)."""
    tol = nl_tolerances((3e-5, 1e-7), (3e-5, 1e-5), c, np.float32, perturbations=True)
    return {
        n: (r, max(a, 1e-3 * float(np.abs(want[n]).max())) if n.endswith("_i") else a)
        for n, (r, a) in tol.items() if n in want
    }


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_tl_f32_matches_pallas_interpret(synth32_small, cfg):
    from cloudsc2_tpu.pallas.tangent_linear import cloudsc2_tl_pallas

    state, dt = synth32_small
    c = CONFIGS[cfg]()
    s = port_tl_state(state, np.float32, c)
    got = flat(cloudsc2_tl(s, dt, c))
    want = flat(cloudsc2_tl_pallas(as_jax(s), dt, jax_constants(c), interpret=True, wb=128))
    assert_fields(got, want, _tl_f32_tolerances(c, want), cfg)


def test_plain_tl_f32_tangent_only_matches_pallas_interpret(synth32_small):
    """``tangent_only``: the same ten ``*_i`` outputs as the Pallas kernel's
    δ-only form, each bitwise equal to the plain version's full output."""
    from cloudsc2_tpu.pallas.tangent_linear import cloudsc2_tl_pallas

    state, dt = synth32_small
    c = CONFIGS["default"]()
    s = port_tl_state(state, np.float32, c)
    got = flat(cloudsc2_tl(s, dt, c, tangent_only=True))
    full = flat(cloudsc2_tl(s, dt, c))
    want = flat(cloudsc2_tl_pallas(as_jax(s), dt, jax_constants(c), interpret=True, wb=128, tangent_only=True))
    assert got.keys() == want.keys() == {k for k in full if k.endswith("_i")}
    for k in got:
        np.testing.assert_array_equal(got[k], full[k], err_msg=k)
    assert_fields(got, want, _tl_f32_tolerances(c, want))


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plain_tl_f32_matches_jax_op_by_op(synth32_small, cfg):
    """In f32 the port is the JAX TL's algorithm: against the JAX scan run
    op by op (``jax.disable_jit``, so XLA re-associates nothing) every
    field agrees to rtol 3e-5 and an atol of 2e-6 of its largest magnitude
    (the two libraries' exp/tanh differ by an ulp)."""
    import jax

    from cloudsc2_tpu.physics.tangent_linear import cloudsc2_tl as jtl

    state, dt = synth32_small
    c = CONFIGS[cfg]()
    s = port_tl_state(state, np.float32, c)
    with jax.disable_jit():
        want = flat(jtl(as_jax(s), dt, jax_constants(c)))
    assert_scaled(flat(cloudsc2_tl(s, dt, c)), want, 3e-5, 2e-6, cfg)


@pytest.mark.parametrize("cfg", ["default", "levapls2"])
def test_plain_tl_matches_jvp_of_plain_nl(cfg):
    """With LREGCL off the hand-written TL is the exact linearization:
    ``torch.func.jvp`` of the plain NL scheme with respect to the 16
    perturbed fields gives the TL's perturbations."""
    _, state, dt = iox.synthesize_input(ncols=8, nlev=30, seed=0)
    c = _config(cfg, "nolregcl")
    s = port_state(state, np.float64, c)
    incr = state_increment(s, 0.01)
    primals = tuple(s[n] for n in INCREMENT_FIELDS)
    tangents = tuple(incr[n + "_i"] for n in INCREMENT_FIELDS)

    def nl(*fields):
        return cloudsc2_nl({**s, **dict(zip(INCREMENT_FIELDS, fields))}, dt, c)

    (tends_nl, diags_nl), (tends_dot, diags_dot) = torch.func.jvp(nl, primals, tangents)
    tends_tl, diags_tl = cloudsc2_tl({**s, **incr}, dt, c)
    if cfg == "levapls2":
        assert (diags_nl["covptot"] != 0).any()  # the branch is active
    for base, dot, tl, names in (
        (tends_nl, tends_dot, tends_tl, ("t", "q", "ql", "qi")),
        (diags_nl, diags_dot, diags_tl, ("clc", "fplsl", "fplsn", "covptot")),
    ):
        for n in names:
            scale = max(base[n].abs().max().item() * 0.01, 1e-300)
            np.testing.assert_allclose(
                tl[n + "_i"].numpy() / scale, dot[n].numpy() / scale, rtol=2e-7, atol=2e-7, err_msg=n
            )


def test_tl_forward_matches_plain_nl_and_zero_increment(synth64):
    state, dt = synth64
    c = CONFIGS["default"]()
    s = port_tl_state(state, np.float64, c)
    tl = flat(cloudsc2_tl(s, dt, c))
    nl = flat(cloudsc2_nl(s, dt, c))
    for n in nl:
        np.testing.assert_allclose(tl[n], nl[n], rtol=5e-12, atol=1e-16, err_msg=n)
    zero = flat(cloudsc2_tl(port_tl_state(state, np.float64, c, factor=0.0), dt, c))
    for n in ("t", "q", "ql", "qi", "clc", "fplsl", "fplsn"):
        assert np.abs(zero[n + "_i"]).max() == 0.0, n


@pytest.mark.parametrize("case", ROBUST_CASES)
def test_plain_tl_finite(case):
    """The robustness states of tests/test_robustness.py stay finite through
    the TL (its guarded denominators), with clc in [0, 1].  With
    evaporation on, a fully evaporated flux leaves a rounding residue of
    either sign (the TL, as the JAX TL, does not clamp the autoconversion
    as the NL does), bounded here by ``utils.compare.flux_residue``."""
    c = CONFIGS["levapls2"]()
    s, dt = robust_state(case, np.float32, c, increment=True)
    out = cloudsc2_tl(s, dt, c)
    assert_physical(out, strict_fluxes=False)
    f = flat(out)
    assert min(f["fplsl"].min(), f["fplsn"].min()) >= -flux_residue(np.float32)
