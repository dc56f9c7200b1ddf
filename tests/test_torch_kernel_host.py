# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The NL, TL and AD kernels' own bodies (kernels/csrc/nl_level.h,
tl_level.h and ad_level.h through levelscan.cuh), compiled for the host
with g++ -ffp-contract=off, vs their plain versions.

This is the port's counterpart of running a Pallas kernel in interpret
mode: the CUDA file itself only builds on a card, but its arithmetic is
the header's, checked here.  The two use different libm exp/pow/tanh
(glibc vs PyTorch's vectorized ones), so they agree to rounding:
f64 rtol 1e-12 with atol 1e-13 (the f64 atol of tests/test_nonlinear.py;
values below it are rounding residues of cancelled sums), f32 the
tests/test_pallas.py gate (rtol 2e-5, atol 1e-8 / 1e-6), fhps* with the
flux-residue atol of ``cloudsc2_tpu_torch.utils.compare.nl_tolerances``.
The TL (every field and its ``*_i``): f64 rtol 1e-12 with an atol of 1e-13
times the field's largest magnitude (measured: 1.5e-15 of it), f32 the TL
gate of tests/test_pallas.py (rtol 3e-5, atol 1e-7 / 1e-5) with the same
flux-residue atol.
The NL with its trajectory: the step's outputs bitwise those without it,
and the carry entering level k bitwise the flux at interface k.  The AD
(the host NL with its trajectory, then the reverse body) against the plain
AD, every field within the limits of
``cloudsc2_tpu_torch.utils.compare.ad_limit``: a share of its largest
magnitude, f64 1e-10 (measured 8.6e-14), f32 2e-6, but
``AD_F32_KERNEL_WIDE``: lu_i 5e-6, lude_i 1e-5 and qsat_i 3e-6 (measured
here 1.47e-6, 3.9e-7 and 7.2e-7) with a median relative difference below
1e-3 (the two f32 roundings of cotangents that sum cancelling terms).  Both f32 sides' lu_i
and lude_i, which go as 1/lu_next**2, stay within the spread gate
(``AD_F32_SPREAD_WIDE``: 5e-5, 1e-5) of the f64 plain AD on the same
inputs, which ``test_ad_f32_detrainment_spread_is_rounding`` holds.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl
from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl
from cloudsc2_tpu_torch.utils.compare import AD_F32_KERNEL_WIDE, AD_F32_SPREAD_WIDE, ad_errors, nl_tolerances
from tests.torch_helpers import (
    CONFIGS,
    ROBUST_CASES,
    assert_ad,
    assert_fields,
    assert_physical,
    assert_scaled,
    flat,
    port_ad_state,
    port_state,
    port_tl_state,
    robust_state,
)

torch.set_num_threads(1)

TOL = {
    np.float64: ((1e-12, 1e-13), (1e-12, 1e-13)),
    np.float32: ((2e-5, 1e-8), (2e-5, 1e-6)),
}


@pytest.fixture(scope="module")
def synth():
    return {dtype: iox.synthesize_input(ncols=100, nlev=137, seed=0, dtype=dtype) for dtype in TOL}


def test_host_library_argument_lists():
    """The compiled header reports the constant, input and output orders
    the Python wrapper passes (a reordering would scramble the fields)."""
    lib = nlk._load("host")
    assert lib.cloudsc2_nl_signature().decode() == nlk.signature()


def test_fastdiv_host_library_argument_lists():
    """The faithful / approx bodies are in the same library, selected by the
    ``div`` switch of the reported lists; a double step takes the exact
    divide only, and the library refuses another (the JAX kernel divides
    non-f32 operands exactly, so no body exists for it).  The library holds
    one saturation-adjustment form, its ``compact`` switch, and refuses the
    other."""
    lib = nlk._load("host")
    assert nlk.signature().startswith("switches:is_double,thermo,evap,traj,fuse,div,compact,;")
    c = CONFIGS["default"]()
    _, state, dt = iox.synthesize_input(ncols=4, nlev=8, seed=0, dtype=np.float64)
    s = port_state(state, np.float64, c)
    ins, dtype = [s[n] for n in nlk.NL_INPUTS], s["ap"].dtype
    plan = nlk._nl_plan("cloudsc2_nl_host", dtype, (8, 4), c, dt, False, False, False, 1)
    outs = [None if shape is None else torch.empty(shape, dtype=dtype) for shape in plan.shapes]
    switches = plan.switches
    run = lambda sw: lib.cloudsc2_nl_host(  # noqa: E731
        *sw, nlk.ptrs(ins), nlk.ptrs(outs), plan.consts.data_ptr(), 8, 4)
    assert switches[0] == 1 and switches[-2:] == (0, 1) and run(switches) == 0
    for div in (1, 2, 3):
        assert run(switches[:-2] + (div, 1)) == 1
    assert run(switches[:-1] + (0,)) == 1


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_body_matches_plain(synth, cfg, dtype):
    _, state, dt = synth[dtype]
    c = CONFIGS[cfg]()
    s = port_state(state, dtype, c)
    got = flat(nlk.cloudsc2_nl_host(s, dt, c))
    want = flat(cloudsc2_nl(s, dt, c))
    tend, diag = TOL[dtype]
    assert_fields(got, want, nl_tolerances(tend, diag, c, dtype), f"{cfg} {dtype.__name__}")
    # the kernel assembles the fluxes itself: zero top row, fhps = -L * fpls
    assert (got["fplsl"][0] == 0).all() and (got["fplsn"][0] == 0).all()
    np.testing.assert_array_equal(got["fhpsl"], -got["fplsl"] * dtype(c.RLVTT))
    np.testing.assert_array_equal(got["fhpsn"], -got["fplsn"] * dtype(c.RLSTT))
    if not (c.LEVAPLS2 or c.LDRAIN1D):
        assert (got["covptot"] == 0).all()


@pytest.mark.parametrize("ncols", [1, 37])
def test_host_body_ragged_column_counts(ncols):
    """Any column count: one column, and a count that is no multiple of a
    warp or a block."""
    c = CONFIGS["ldrain1d"]()
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=29, seed=4)
    s = port_state(state, np.float64, c)
    tend, diag = TOL[np.float64]
    assert_fields(flat(nlk.cloudsc2_nl_host(s, dt, c)), flat(cloudsc2_nl(s, dt, c)),
                  nl_tolerances(tend, diag, c, np.float64), f"ncols={ncols}")


@pytest.mark.parametrize("case", ROBUST_CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_body_finite(case, dtype):
    """The robustness states of tests/test_robustness.py: the kernel body's
    guarded denominators keep every output finite and physical."""
    c = CONFIGS["default"]()
    s, dt = robust_state(case, dtype, c)
    assert_physical(nlk.cloudsc2_nl_host(s, dt, c))


def test_tl_host_library_argument_lists():
    lib = tlk._load("host")
    assert lib.cloudsc2_tl_signature().decode() == tlk.signature()


def _assert_tl_host(got, want, c, dtype, label):
    if dtype == np.float64:
        assert_scaled(got, want, 1e-12, 1e-13, label)
    else:
        tol = nl_tolerances((3e-5, 1e-7), (3e-5, 1e-5), c, dtype, perturbations=True)
        assert_fields(got, want, tol, label)


@pytest.mark.parametrize("lregcl", [True, False])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tl_host_body_matches_plain(synth, cfg, dtype, lregcl):
    _, state, dt = synth[dtype]
    c = CONFIGS[cfg]().replace(LREGCL=lregcl)
    s = port_tl_state(state, dtype, c)
    got = flat(tlk.cloudsc2_tl_host(s, dt, c))
    _assert_tl_host(got, flat(cloudsc2_tl(s, dt, c)), c, dtype, f"{cfg} {dtype.__name__} {lregcl}")
    # the kernel assembles the fluxes itself: zero top row, fhps = -L * fpls
    for sfx in ("", "_i"):
        assert (got["fplsl" + sfx][0] == 0).all() and (got["fplsn" + sfx][0] == 0).all()
        np.testing.assert_array_equal(got["fhpsl" + sfx], -got["fplsl" + sfx] * dtype(c.RLVTT))
        np.testing.assert_array_equal(got["fhpsn" + sfx], -got["fplsn" + sfx] * dtype(c.RLSTT))
    if not (c.LEVAPLS2 or c.LDRAIN1D):
        assert (got["covptot"] == 0).all() and (got["covptot_i"] == 0).all()


@pytest.mark.parametrize("ncols", [1, 37])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tl_host_body_ragged_and_tangent_only(ncols, dtype):
    """Any column count; ``tangent_only`` writes exactly the ``*_i`` outputs
    of the full launch, bit for bit."""
    c = CONFIGS["ldrain1d"]().replace(LREGCL=False)
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=29, seed=4, dtype=dtype)
    s = port_tl_state(state, dtype, c)
    full = flat(tlk.cloudsc2_tl_host(s, dt, c))
    _assert_tl_host(full, flat(cloudsc2_tl(s, dt, c)), c, dtype, f"ncols={ncols}")
    only = flat(tlk.cloudsc2_tl_host(s, dt, c, tangent_only=True))
    assert sorted(only) == sorted(k for k in full if k.endswith("_i"))
    for k in only:
        np.testing.assert_array_equal(only[k], full[k], err_msg=k)


@pytest.mark.parametrize("case", ROBUST_CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tl_host_body_finite(case, dtype):
    """The robustness states stay finite through the TL kernel's body, with
    the evaporation branch on (its guarded denominators)."""
    c = CONFIGS["levapls2"]()
    s, dt = robust_state(case, dtype, c, increment=True)
    assert_physical(tlk.cloudsc2_tl_host(s, dt, c), strict_fluxes=False)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_body_with_trajectory(synth, cfg, dtype):
    """``with_trajectory`` leaves the step's outputs bitwise unchanged; the
    carry entering level k is bitwise the flux at interface k; ``c_cov``
    only with evaporation, within the NL tolerance of the plain one."""
    _, state, dt = synth[dtype]
    c = CONFIGS[cfg]()
    s = port_state(state, dtype, c)
    plain = flat(nlk.cloudsc2_nl_host(s, dt, c))
    tends, diags, traj = nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True)
    got = flat((tends, diags))
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    evap = c.LEVAPLS2 or c.LDRAIN1D
    assert sorted(traj) == (["c_cov", "c_rfl", "c_sfl"] if evap else ["c_rfl", "c_sfl"])
    np.testing.assert_array_equal(traj["c_rfl"].numpy(), got["fplsl"][:-1])
    np.testing.assert_array_equal(traj["c_sfl"].numpy(), got["fplsn"][:-1])
    want = cloudsc2_nl(s, dt, c, with_trajectory=True)[2]
    assert sorted(want) == sorted(traj)
    tend, diag = TOL[dtype]
    tol = nl_tolerances(tend, diag, c, dtype)
    assert_fields({k: v.numpy() for k, v in traj.items()}, {k: v.numpy() for k, v in want.items()},
                  {"c_rfl": tol["fplsl"], "c_sfl": tol["fplsn"], "c_cov": tol["covptot"]} if evap
                  else {"c_rfl": tol["fplsl"], "c_sfl": tol["fplsn"]}, cfg)


def test_ad_host_library_argument_lists():
    lib = adk._load("host")
    assert lib.cloudsc2_ad_signature().decode() == adk.signature()


@pytest.mark.parametrize("lregcl", [True, False])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ad_host_body_matches_plain(cfg, dtype, lregcl):
    c = CONFIGS[cfg]().replace(LREGCL=lregcl)
    _, state, dt = iox.synthesize_input(ncols=16, nlev=137, seed=0, dtype=dtype)
    s = port_ad_state(state, dtype, c, dt)
    got = flat(adk.cloudsc2_ad_host(s, dt, c))
    want = flat(cloudsc2_ad(s, dt, c))
    assert len(want) == 26
    assert_ad(got, want, dtype, f"{cfg} {lregcl}")
    # the kernel assembles the cotangents itself
    assert (got["lu_i"][0] == 0).all()
    np.testing.assert_array_equal(got["mfu_i"], got["mfd_i"])
    np.testing.assert_array_equal(got["q_i"], got["supsat_i"])
    np.testing.assert_array_equal(got["cml_t_i"], (got["t_i"] * dtype(dt)).astype(dtype))


def test_ad_f32_detrainment_spread_is_rounding():
    """Where the f32 host body and the f32 plain AD part most (lu_i,
    lude_i), each stays within the f32 gate of the f64 plain AD on the same
    inputs: the spread is f32 rounding on both sides."""
    c = CONFIGS["default"]()
    _, state, dt = iox.synthesize_input(ncols=16, nlev=137, seed=0, dtype=np.float32)
    s32 = port_ad_state(state, np.float32, c, dt)
    ref = flat(cloudsc2_ad({k: v.double() for k, v in s32.items()}, dt, c))
    for side, got in (("host body", adk.cloudsc2_ad_host(s32, dt, c)), ("plain", cloudsc2_ad(s32, dt, c))):
        got = flat(got)
        for n in ("lu_i", "lude_i"):
            assert_scaled({n: got[n]}, {n: ref[n]}, 0.0, AD_F32_SPREAD_WIDE[n], side)


def test_ad_kernel_gate_catches_a_tenfold_qsat_i_fault():
    """The f32 gate of the AD kernels against the plain AD
    (``AD_F32_KERNEL_WIDE``) passes the host body's qsat_i and fails it with
    its residual made ten times its reading (at the configuration with the
    largest qsat_i reading here, evaporation on), which the old single gate
    (now the spread gate ``AD_F32_SPREAD_WIDE``, 2e-5) passed."""
    c = CONFIGS["levapls2"]()
    _, state, dt = iox.synthesize_input(ncols=16, nlev=137, seed=0, dtype=np.float32)
    s = port_ad_state(state, np.float32, c, dt)
    got = flat(adk.cloudsc2_ad_host(s, dt, c))
    want = flat(cloudsc2_ad(s, dt, c))
    ok = ad_errors({"qsat_i": got["qsat_i"]}, {"qsat_i": want["qsat_i"]}, np.float32)["qsat_i"]
    assert 0.0 < ok[0] and ok[2] <= 1.0
    w = want["qsat_i"].astype(np.float64)
    fault = {"qsat_i": w + 10.0 * (got["qsat_i"].astype(np.float64) - w)}
    assert ad_errors(fault, {"qsat_i": w}, np.float32)["qsat_i"][2] > 1.0
    assert ad_errors(fault, {"qsat_i": w}, np.float32, AD_F32_SPREAD_WIDE)["qsat_i"][2] <= 1.0
    assert AD_F32_KERNEL_WIDE.keys() == AD_F32_SPREAD_WIDE.keys()
    assert all(AD_F32_KERNEL_WIDE[n] <= AD_F32_SPREAD_WIDE[n] for n in AD_F32_KERNEL_WIDE)


@pytest.mark.parametrize("ncols", [1, 37])
def test_ad_host_body_ragged_and_zero_seeds(ncols):
    """Any column count; zero seeds give exactly zero cotangents."""
    c = CONFIGS["ldrain1d"]()
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=29, seed=4)
    s = port_ad_state(state, np.float64, c, dt)
    assert_ad(flat(adk.cloudsc2_ad_host(s, dt, c)), flat(cloudsc2_ad(s, dt, c)), np.float64, f"ncols={ncols}")
    for n in adk.AD_SEEDS:
        s[n] = torch.zeros_like(s[n])
    tends, diags = adk.cloudsc2_ad_host(s, dt, c)
    for k, v in {**tends, **diags}.items():
        if k.endswith("_i"):
            assert v.abs().max().item() == 0.0, k


@pytest.mark.parametrize("case", ROBUST_CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ad_host_body_finite(case, dtype):
    """The robustness states stay finite through the AD kernels' bodies,
    with the evaporation branch on."""
    c = CONFIGS["levapls2"]()
    s, dt = robust_state(case, dtype, c, ncols=32, nlev=53, increment=True)
    tends, diags = cloudsc2_tl(s, dt, c)
    for n in ("t", "q", "ql", "qi"):
        s["tnd_" + n + "_i"] = tends[n + "_i"]
    for n in ("clc", "covptot", "fhpsl", "fhpsn", "fplsl", "fplsn"):
        s[n + "_i"] = diags[n + "_i"]
    for k, v in flat(adk.cloudsc2_ad_host(s, dt, c)).items():
        assert np.isfinite(v).all(), f"{case}: {k} has non-finite values"


@pytest.mark.parametrize("build", ["nl", "nl trajectory", "tl", "ad", "ad fused", "ad fused resident"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_builds_match_plain_where_eta_crosses_the_clamp(build, dtype):
    """Every kernel derives ``scalm`` from ``eta`` itself (``nl_level.h``
    ``ScalmTable``), where the plain versions take ``scalm_profile``: on a
    state whose ``eta`` runs across the clamp at 0.2 (``scalm`` is
    ``ZSCAL * ZEPS1 ** 0.2`` above it), each host build still matches its
    plain version within the gates above."""
    c = CONFIGS["default"]()
    _, state, dt = iox.synthesize_input(ncols=16, nlev=137, seed=0, dtype=dtype)
    make = port_ad_state if build.startswith("ad") else port_tl_state if build == "tl" else port_state
    s = make(state, dtype, c, dt) if build.startswith("ad") else make(state, dtype, c)
    eta = s["eta"].numpy()
    assert (eta < 0.2).sum() >= 10 and (eta > 0.2).sum() >= 10
    tend, diag = TOL[dtype]
    if build == "nl":
        assert_fields(flat(nlk.cloudsc2_nl_host(s, dt, c)), flat(cloudsc2_nl(s, dt, c)),
                      nl_tolerances(tend, diag, c, dtype), build)
    elif build == "nl trajectory":
        got, want = nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True), cloudsc2_nl(s, dt, c, with_trajectory=True)
        tol = nl_tolerances(tend, diag, c, dtype)
        assert_fields(flat(got[:2]), flat(want[:2]), tol, build)
        assert_fields({k: v.numpy() for k, v in got[2].items()}, {k: v.numpy() for k, v in want[2].items()},
                      {"c_rfl": tol["fplsl"], "c_sfl": tol["fplsn"]}, build)
    elif build == "tl":
        _assert_tl_host(flat(tlk.cloudsc2_tl_host(s, dt, c)), flat(cloudsc2_tl(s, dt, c)), c, dtype, build)
    else:
        got = {"ad": lambda: adk.cloudsc2_ad_host(s, dt, c),
               "ad fused": lambda: adk.cloudsc2_ad_fused_host(s, dt, c),
               "ad fused resident": lambda: adk.cloudsc2_ad_fused_host(s, dt, c, resident=True)}[build]()
        assert_ad(flat(got), flat(cloudsc2_ad(s, dt, c)), dtype, build)
