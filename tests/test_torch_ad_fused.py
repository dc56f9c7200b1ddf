# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The single-kernel adjoint (kernels/csrc/ad_fused.h through the fused
form of levelscan.cuh, the port of cloudsc2_ad_pallas_fused and
level_scan_fwdrev_pallas) and the AD's gradient-only forms
(``cotangent_only``, and the NL kernel's ``traj_only`` it runs), through
their host builds (g++ -ffp-contract=off) and the plain AD.

* the host fused AD, rolled and ``resident``, is bitwise the host build of
  the two-kernel AD: both run the same level bodies around the same
  trajectory, f32 and f64, the three configurations with LREGCL on and
  off, at a ragged 37 x 137;
* f32 against ``cloudsc2_ad_pallas_fused(interpret=True, wb=128,
  unroll=1)``, with and without ``resident``, at 1024 x 53 (the size of
  tests/test_torch_adjoint.py's Pallas comparison): every field within
  ``PALLAS_F32_WIDE`` (measured: at most 0.62 of a limit, aph_i);
* f64 against the JAX scan AD ``cloudsc2_tpu.physics.adjoint.cloudsc2_ad``
  at 32 x 137: every field within 1e-10 of its largest magnitude;
* ``cotangent_only`` through the plain AD and the host build: the key sets
  of the JAX ``cloudsc2_ad_pallas(cotangent_only=True)``, its values within
  ``PALLAS_F32_WIDE``, and bitwise the full form's ``*_i`` outputs;
  ``traj_only`` bitwise the trajectory of ``with_trajectory``;
* ``LPHYLIN=False`` taken by the fused entries, bitwise the ``LPHYLIN=True``
  launch (the AD does not read it); refusals: ``traj_only`` without
  ``with_trajectory``, CPU tensors on the CUDA entry, a stack that does not
  fit; and the plan's
  block sizes and blocks per SM (the block that keeps the most threads on
  an SM).
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import dispatch, iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
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

DTYPES = {"f64": np.float64, "f32": np.float32}
LREGCL = {"lregcl": True, "nolregcl": False}
FORMS = {"rolled": False, "resident": True}


def _config(cfg, lregcl="lregcl"):
    return CONFIGS[cfg]().replace(LREGCL=LREGCL[lregcl])


def _assert_bitwise(got, want, label):
    assert got.keys() == want.keys(), label
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not differ, f"{label}: differ in {differ}"


@pytest.fixture(scope="module")
def ragged():
    """Per (dtype, configuration, LREGCL): the AD state at 37 x 137 and the
    host two-kernel AD on it."""
    out = {}
    for tag, dtype in DTYPES.items():
        _, state, dt = iox.synthesize_input(ncols=37, nlev=137, seed=0, dtype=dtype)
        for cfg in CONFIGS:
            for lregcl in LREGCL:
                c = _config(cfg, lregcl)
                s = port_ad_state(state, dtype, c, dt)
                out[tag, cfg, lregcl] = s, dt, flat(adk.cloudsc2_ad_host(s, dt, c))
    return out


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("lregcl", list(LREGCL))
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("tag", list(DTYPES))
def test_host_fused_is_bitwise_the_two_kernel_ad(ragged, tag, cfg, lregcl, form):
    s, dt, want = ragged[tag, cfg, lregcl]
    got = flat(adk.cloudsc2_ad_fused_host(s, dt, _config(cfg, lregcl), resident=FORMS[form]))
    assert len(got) == 26
    _assert_bitwise(got, want, f"{tag} {cfg} {lregcl} {form}")


@pytest.fixture(scope="module")
def pallas32():
    """Per configuration: the f32 AD state at 1024 x 53."""
    _, state, dt = iox.synthesize_input(ncols=1024, nlev=53, seed=0, dtype=np.float32)
    return {cfg: (port_ad_state(state, np.float32, CONFIGS[cfg](), dt), dt) for cfg in ("default", "levapls2")}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("cfg", ["default", "levapls2"])
def test_host_fused_f32_matches_pallas_fused_interpret(pallas32, cfg, form):
    from cloudsc2_tpu.pallas.adjoint import cloudsc2_ad_pallas_fused

    s, dt = pallas32[cfg]
    c = CONFIGS[cfg]()
    got = flat(adk.cloudsc2_ad_fused_host(s, dt, c, resident=FORMS[form]))
    want = flat(cloudsc2_ad_pallas_fused(as_jax(s), dt, jax_constants(c), interpret=True, wb=128, unroll=1,
                                         resident=FORMS[form]))
    assert_ad(got, want, np.float32, f"{cfg} {form}", wide=PALLAS_F32_WIDE)


@pytest.fixture(scope="module")
def scan64():
    """Per configuration: the f64 AD state at 32 x 137 and the JAX scan AD
    on it."""
    from cloudsc2_tpu.physics.adjoint import cloudsc2_ad as jad

    _, state, dt = iox.synthesize_input(ncols=32, nlev=137, seed=0)
    out = {}
    for cfg in ("default", "ldrain1d"):
        c = CONFIGS[cfg]()
        s = port_ad_state(state, np.float64, c, dt)
        out[cfg] = s, dt, flat(jad(as_jax(s), dt, jax_constants(c)))
    return out


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("cfg", ["default", "ldrain1d"])
def test_host_fused_f64_matches_jax_scan_ad(scan64, cfg, form):
    s, dt, want = scan64[cfg]
    got = flat(adk.cloudsc2_ad_fused_host(s, dt, CONFIGS[cfg](), resident=FORMS[form]))
    assert_ad(got, want, np.float64, f"{cfg} {form}")


@pytest.mark.parametrize("side", ["plain", "host"])
@pytest.mark.parametrize("cfg", ["default", "levapls2"])
def test_cotangent_only_matches_pallas_and_the_full_form(pallas32, cfg, side):
    """Key sets equal to the JAX ``cotangent_only`` AD's (tests/test_pallas.py
    :794-795), values within ``PALLAS_F32_WIDE`` of it and bitwise the full
    form's cotangents."""
    from cloudsc2_tpu.pallas.adjoint import cloudsc2_ad_pallas

    s, dt = pallas32[cfg]
    c = CONFIGS[cfg]()
    fn = cloudsc2_ad if side == "plain" else adk.cloudsc2_ad_host
    tends, diags = fn(s, dt, c, cotangent_only=True)
    jt, jd = cloudsc2_ad_pallas(as_jax(s), dt, jax_constants(c), interpret=True, wb=128, cotangent_only=True)
    assert set(tends) == set(jt) == {"cml_t_i", "cml_q_i", "cml_ql_i", "cml_qi_i"}
    assert set(diags) == set(jd) and all(k.endswith("_i") for k in diags) and len(diags) == 12
    got = flat((tends, diags))
    assert_ad(got, flat((jt, jd)), np.float32, f"{side} {cfg}", wide=PALLAS_F32_WIDE)
    full = flat(fn(s, dt, c))
    _assert_bitwise(got, {k: full[k] for k in got}, f"{side} {cfg} against the full form")


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_traj_only_is_the_trajectory_of_with_trajectory(cfg):
    c = CONFIGS[cfg]()
    _, state, dt = iox.synthesize_input(ncols=37, nlev=29, seed=4)
    s = port_state(state, np.float64, c)
    tends, diags, traj = nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True, traj_only=True)
    assert tends == {} and diags == {}
    want = nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True)[2]
    _assert_bitwise({k: v.numpy() for k, v in traj.items()}, {k: v.numpy() for k, v in want.items()}, cfg)


def _cpu_ad_state():
    c = CONFIGS["default"]()
    _, state, dt = iox.synthesize_input(ncols=8, nlev=11, seed=0)
    return port_ad_state(state, np.float64, c, dt), dt, c


def test_traj_only_requires_with_trajectory():
    s, dt, c = _cpu_ad_state()
    for fn in (nlk.cloudsc2_nl_host, nlk.cloudsc2_nl_cuda):
        with pytest.raises(ValueError, match="traj_only requires with_trajectory"):
            fn(s, dt, c, traj_only=True)


def test_fused_entries_refuse_without_lphylin_and_on_cpu_tensors():
    """LPHYLIN=False is taken by every fused entry: the host body, rolled
    and resident, is bitwise its LPHYLIN=True launch, and the CPU dispatch
    is the plain AD's outputs; the CUDA entries refuse CPU tensors under
    either setting; no launch is counted."""
    s, dt, c = _cpu_ad_state()
    off = c.replace(LPHYLIN=False)
    before = adk.cloudsc2_ad_fused_cuda.launches
    for resident in (False, True):
        want = flat(adk.cloudsc2_ad_fused_host(s, dt, c, resident=resident))
        got = flat(adk.cloudsc2_ad_fused_host(s, dt, off, resident=resident))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"resident={resident} {k}")
    want = flat(cloudsc2_ad(s, dt, off))
    got = flat(dispatch.cloudsc2_ad_fused(s, dt, off))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for cc in (c, off):
        with pytest.raises(ValueError, match="cuda"):
            adk.cloudsc2_ad_fused_cuda(s, dt, cc)
        with pytest.raises(ValueError, match="cuda"):
            adk.cloudsc2_ad_cuda(s, dt, cc, cotangent_only=True)
    assert adk.cloudsc2_ad_fused_cuda.launches == before


def test_dispatch_sends_cpu_tensors_to_the_plain_ad():
    """On CPU tensors the fused entry and the cotangent-only entry are the
    plain AD's outputs, exactly."""
    s, dt, c = _cpu_ad_state()
    want = flat(cloudsc2_ad(s, dt, c))
    for resident in (False, True):
        _assert_bitwise(flat(dispatch.cloudsc2_ad_fused(s, dt, c, resident=resident)), want, "fused")
    got = flat(dispatch.cloudsc2_ad(s, dt, c, cotangent_only=True))
    _assert_bitwise(got, {k: want[k] for k in got}, "cotangent_only")
    with pytest.raises(ValueError, match="no AD implementation"):
        dispatch.cloudsc2_ad_fused({k: v.to("meta") for k, v in s.items()}, dt, c)


@pytest.mark.parametrize("tag,evap,resident,block,per_sm", [
    ("f32", False, False, 64, 3), ("f32", True, False, 128, 1), ("f64", False, False, 32, 3),
    ("f64", True, False, 64, 1), ("f32", False, True, 32, 1), ("f32", True, True, 32, 1),
    ("f64", False, True, 16, 1), ("f64", True, True, 16, 1),
])
def test_fused_plan_block_sizes_at_137_levels(tag, evap, resident, block, per_sm):
    dtype = torch.float64 if tag == "f64" else torch.float32
    got, nbytes, got_per_sm = adk.fused_plan(137, dtype, evap, resident)
    item = 8 if tag == "f64" else 4
    assert (got, nbytes, got_per_sm) == (block, block * adk.fused_stack_slots(evap, resident) * 137 * item, per_sm)
    # the plan fills the SM: no other block keeps more threads resident on it
    # (a block of b threads: 233,472 // (b x stack + 1,024) blocks per SM)
    assert nbytes <= adk.MAX_SHARED_BYTES
    for other in adk.FUSED_BLOCKS:
        b = other * nbytes // block
        if b <= adk.MAX_SHARED_BYTES:
            assert other * (adk.SM_SHARED_BYTES // (b + adk.BLOCK_RESERVED_BYTES)) <= block * per_sm, other


def test_fused_plan_counts_threads():
    """At few levels the SM's 2,048 threads bound the blocks, not the
    stacks; ties go to the larger block."""
    # 2 values x 11 levels x 4 B: every block fits 16 or more times
    assert adk.fused_plan(11, torch.float32, False, False) == (128, 128 * 88, 16)


def test_fused_occupancy_takes_the_cards_best_block(monkeypatch):
    """The launch's block is the card's (here a stand-in for its occupancy
    query): of the blocks whose stacks fit, the most threads per SM, ties
    to the larger; a block whose stacks do not fit is never asked about."""
    c = CONFIGS["default"]()
    block, nbytes, per_sm = adk.fused_plan(137, torch.float32, False, False)
    # the stacks alone: the card agrees with the plan
    card = {b: adk.SM_SHARED_BYTES // (b * nbytes // block + adk.BLOCK_RESERVED_BYTES) for b in adk.FUSED_BLOCKS}
    monkeypatch.setattr(adk, "_occupancy", lambda switches, b, nlev: (card[b], 128, 0, b * nbytes // block))
    assert adk.fused_occupancy(torch.float32, c, False, 137) == {
        "block": block, "blocks_per_sm": per_sm, "threads_per_sm": block * per_sm, "registers": 128,
        "local_bytes": 0, "shared_bytes": nbytes}
    # registers cut 64 threads to 2 blocks: 128 x 1 and 64 x 2 tie below 32 x 6 and 16 x 12
    card = {128: 1, 64: 2, 32: 6, 16: 12}
    assert adk.fused_occupancy(torch.float32, c, False, 137)["block"] == 32
    # f64 resident: only 16 threads fit, and only they are asked about
    asked = []
    monkeypatch.setattr(adk, "_occupancy", lambda switches, b, nlev: asked.append(b) or (1, 238, 0, 0))
    assert adk.fused_occupancy(torch.float64, c, True, 137)["block"] == 16
    assert asked == [16]


def test_fused_plan_raises_where_16_threads_do_not_fit():
    # f64 resident without evaporation: 12 values x 8 B a level, 16 threads
    # fit 151 levels
    assert adk.fused_plan(151, torch.float64, False, True)[0] == 16
    with pytest.raises(ValueError, match=r"12 values x 152 levels x 8 B = 14592 B a thread"):
        adk.fused_plan(152, torch.float64, False, True)
    with pytest.raises(ValueError, match="stack does not fit"):
        adk.fused_plan(200, torch.float64, True, True)


def test_fused_host_library_argument_lists():
    lib = adk._load("host", "ad_fused")
    assert lib.cloudsc2_ad_fused_signature().decode() == adk.fused_signature()
