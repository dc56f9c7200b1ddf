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
  ``with_trajectory``, CPU tensors on the CUDA entry, a column of one level;
* the stack in its scratch: the host build runs the kernel's index function
  on the kernel's layout, every column's forward sweep before any reverse
  sweep, so a stack that aliased two columns, or a slot off by one, would
  break its bitwise equality with the two-kernel host AD (at a ragged 37
  columns, nlev 2, 3 and 137, and deep f64 resident columns of 152 and 200
  levels, which the stack in shared memory could not hold); and the plan's
  blocks per SM at a register count, as the card's occupancy calculator
  counts them, and the blocks per SM that a float32 NL launch sizes its
  shared-memory carveout for (``nlk.carveout_blocks``).
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import dispatch, iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.physics.adjoint import cloudsc2_ad
from cloudsc2_tpu_torch.physics.increment import state_increment
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


#: the stack's scratch at 65,536 x 137: slots x 137 x 65,536 values
_SCRATCH = {n: n * 137 * 65_536 for n in (2, 3, 12, 13)}


@pytest.mark.parametrize("tag,evap,resident,registers,per_sm,values", [
    ("f32", False, False, 128, 4, _SCRATCH[2]), ("f32", False, True, 127, 4, _SCRATCH[12]),
    ("f32", True, False, 160, 3, _SCRATCH[3]), ("f32", True, True, 163, 3, _SCRATCH[13]),
    ("f32", False, False, 153, 3, _SCRATCH[2]), ("f64", False, False, 240, 2, _SCRATCH[2]),
    ("f64", False, True, 238, 2, _SCRATCH[12]), ("f64", True, False, 255, 2, _SCRATCH[3]),
    ("f64", True, True, 255, 2, _SCRATCH[13]), ("f32", False, False, 129, 3, _SCRATCH[2]),
    ("f32", False, False, 32, 8, _SCRATCH[2]),
])
def test_fused_plan_block_sizes_at_137_levels(tag, evap, resident, registers, per_sm, values):
    """Blocks of 128 threads, as many an SM as the registers allow (f32
    default switches 4 at 128 registers, 512 threads; one register more
    and an SM holds 3; f64 2), the level table (137 values) and the
    forward sweep's ring in shared memory (f32 3 slots x 16 fields x 128
    threads, 24 KB a block, which with the table would bound an SM at 8
    blocks, at 32 registers; f64's ring is in registers), no level of the
    stack in shared memory, and the stack's scratch in device memory: 71.8
    MB rolled and 431 MB resident in f32 at 65,536 x 137, twice that in
    f64."""
    dtype = torch.float64 if tag == "f64" else torch.float32
    item = 8 if tag == "f64" else 4
    plan = adk.fused_plan(137, 65_536, dtype, evap, resident, registers)
    assert plan == {"block": 128, "blocks_per_sm": per_sm, "threads_per_sm": 128 * per_sm,
                    "shared_bytes": 137 * item + (24_576 if tag == "f32" else 0), "levels_in_shared": 0,
                    "scratch_bytes": values * item}
    assert plan["scratch_bytes"] == adk.fused_stack_slots(evap, resident) * 137 * 65_536 * item


def test_fused_ring_is_the_nl_kernels():
    """The plan's ring is the NL kernel's (``NLRing``, read from its host
    build): f32 three slots in shared memory, f64 two in registers."""
    assert nlk.ring_depth(torch.float32) == adk.FUSED_RING_SLOTS[torch.float32] == 3
    assert nlk.ring_depth(torch.float64) == 2 and adk.FUSED_RING_SLOTS[torch.float64] == 0


@pytest.mark.parametrize("registers,block,per_sm", [
    (32, 128, 16), (24, 128, 16), (24, 32, 32), (64, 128, 8), (72, 128, 7), (255, 128, 2), (255, 32, 8),
])
def test_fused_plan_counts_threads(registers, block, per_sm):
    """A warp's registers rounded up to 256, whole warps in each of the
    SM's four sub-partitions of 16,384 (72 registers: 2,304 a warp, 7 in a
    partition, 28 warps, 7 blocks of 4 warps); and at few registers the
    SM's 2,048 threads and 32 blocks bound it instead."""
    assert adk.register_blocks(registers, block) == per_sm


def test_fused_occupancy_takes_the_cards_best_block(monkeypatch):
    """The card's reading (here a stand-in for its occupancy query) is
    returned where its blocks per SM are those the registers allow, and
    refused where anything else (shared memory, a wrong launch bound) sets
    them."""
    c = CONFIGS["default"]()
    monkeypatch.setattr(adk, "_occupancy", lambda switches, nlev: (4, 128, 0, 25_124))
    assert adk.fused_occupancy(torch.float32, c, False, 137) == {
        "block": 128, "blocks_per_sm": 4, "threads_per_sm": 512, "registers": 128, "local_bytes": 0,
        "shared_bytes": 25_124, "levels_in_shared": 0}
    monkeypatch.setattr(adk, "_occupancy", lambda switches, nlev: (2, 240, 0, 1_096))
    assert adk.fused_occupancy(torch.float64, c, True, 137)["threads_per_sm"] == 256
    for reading in ((3, 128, 0, 25_124), (4, 128, 0, 24_576), (4, 128, 0, 49_152)):
        monkeypatch.setattr(adk, "_occupancy", lambda switches, nlev, r=reading: r)
        with pytest.raises(RuntimeError, match="otherwise than its plan"):
            adk.fused_occupancy(torch.float32, c, False, 137)


#: the f32 NL kernel's shared bytes a block at 137 levels, fused (15 ring
#: fields) and unfused (16): the level table, then 3 ring slots of 128
#: values a field; and its ring's 2 slots in flight
NL_SLOT = {"fused": 15 * 128 * 4, "unfused": 16 * 128 * 4}
NL_SHARED = {form: 137 * 4 + 3 * slot for form, slot in NL_SLOT.items()}
NL_IN_FLIGHT = {form: 2 * slot for form, slot in NL_SLOT.items()}


@pytest.mark.parametrize("form,register_blocks,ncols,sms,blocks", [
    ("fused", 8, 65_536, 132, 4),  # 512 blocks, 3.88 an SM: one wave of four
    ("fused", 8, 262_144, 132, 6),  # 2,048 blocks, 15.5 an SM: six fit the SM's memory, eight its registers
    ("unfused", 8, 262_144, 132, 6),
    ("fused", 8, 100, 132, 4),  # one block: never fewer than four
    ("fused", 5, 262_144, 132, 5),  # registers allow fewer than the grid and the memory would take
    ("fused", 8, 66_000, 132, 4),  # 516 blocks, 3.91 an SM: four
    ("fused", 8, 67_712, 132, 5),  # 529 blocks, a block past four waves' 528
])
def test_nl_carveout_blocks(form, register_blocks, ncols, sms, blocks):
    """The rule that sizes a float32 NL launch's shared-memory carveout
    (``nl_level.h`` ``nl_carveout_blocks``, from the host build): the fewest
    of the registers' blocks an SM, the blocks the SM's memory holds (each
    its shared bytes plus 1 KB, and its ring's copies in flight in L1),
    and the grid's blocks an SM rounded up, but never fewer than four, so a
    grid that fits one wave of four asks for the carveout of four."""
    got = nlk.carveout_blocks(register_blocks, NL_SHARED[form], NL_IN_FLIGHT[form], -(-ncols // 128), sms)
    assert got == blocks


@pytest.mark.parametrize("shared,in_flight,blocks", [
    (40_000, 0, 5),  # 228 KB of shared memory holds five blocks of 40,000 + 1,024 bytes
    (0, 0, 16),  # nothing in shared memory: the registers' sixteen, below the grid's 63
    (0, 30_000, 8),  # 256 KB holds eight blocks of 1,024 + 30,000 bytes
])
def test_nl_carveout_blocks_by_memory(shared, in_flight, blocks):
    """The memory's term alone: the SM's 228 KB of shared memory at the
    shared bytes plus 1 KB, and its 256 KB of shared memory and L1 at that
    plus the bytes in flight, whichever holds fewer."""
    assert nlk.carveout_blocks(16, shared, in_flight, -(-1_048_576 // 128), 132) == blocks


def test_nl_carveout_blocks_refuses_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        nlk.carveout_blocks(8, NL_SHARED["fused"], NL_IN_FLIGHT["fused"], 2_048, 0)
    with pytest.raises(ValueError, match="out of range"):
        nlk.carveout_blocks(0, NL_SHARED["fused"], NL_IN_FLIGHT["fused"], 2_048, 132)
    with pytest.raises(ValueError, match="out of range"):
        nlk.carveout_blocks(8, NL_SHARED["fused"], -1, 2_048, 132)


def _seeded_ad_state(nlev, ncols, cfg, dtype, seed=5):
    """The state with its increments and seeded cotangent seeds from
    numpy (the AD is linear in them), at any depth the wrappers take."""
    c = CONFIGS[cfg]()
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=0, dtype=dtype)
    s = port_state(state, dtype, c)
    s.update(state_increment(s, 0.01, ignore_supsat=True))
    rng = np.random.default_rng(seed)
    for n in adk.AD_SEEDS:
        rows = nlev + 1 if n[:4] in ("fpls", "fhps") else nlev
        s[n] = torch.from_numpy(rng.standard_normal((rows, ncols)).astype(dtype))
    for n in ("t", "q", "ql", "qi"):
        s["tnd_" + n] = torch.zeros_like(s["t"])
    return s, dt, c


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("cfg", ["default", "levapls2"])
@pytest.mark.parametrize("nlev", [2, 3, 137])
def test_host_stack_order_is_bitwise_the_two_kernel_ad(nlev, cfg, form):
    """Every column's forward sweep before any reverse sweep, on the
    kernel's scratch layout, at a ragged 37 columns: bitwise the two-kernel
    host AD, f32, at the shallowest depths the wrappers take and at 137."""
    s, dt, c = _seeded_ad_state(nlev, 37, cfg, np.float32)
    want = flat(adk.cloudsc2_ad_host(s, dt, c))
    got = flat(adk.cloudsc2_ad_fused_host(s, dt, c, resident=FORMS[form]))
    _assert_bitwise(got, want, f"{nlev} {cfg} {form}")


def test_fused_entries_refuse_a_column_of_one_level():
    s, dt, c = _seeded_ad_state(2, 8, "default", np.float64)
    s = {k: v[:1] if v.shape[0] == 2 else v[:2] for k, v in s.items()}
    for fn in (adk.cloudsc2_ad_fused_host, adk.cloudsc2_ad_fused_cuda):
        with pytest.raises(ValueError, match="nlev >= 2"):
            fn(s, dt, c)


@pytest.mark.parametrize("evap", [False, True])
@pytest.mark.parametrize("nlev", [152, 200])
def test_deep_f64_resident_columns_are_planned_and_bitwise(nlev, evap):
    """f64 resident past 151 levels, where the stack in shared memory did
    not fit 16 threads: planned (2 blocks of 128 at 240 registers, the
    scratch 12-13 values a level), and the host build bitwise the
    two-kernel host AD."""
    plan = adk.fused_plan(nlev, 65_536, torch.float64, evap, True, 240)
    assert (plan["threads_per_sm"], plan["scratch_bytes"]) == (256, (13 if evap else 12) * nlev * 65_536 * 8)
    s, dt, c = _seeded_ad_state(nlev, 5, "levapls2" if evap else "default", np.float64)
    _assert_bitwise(flat(adk.cloudsc2_ad_fused_host(s, dt, c, resident=True)), flat(adk.cloudsc2_ad_host(s, dt, c)),
                    f"{nlev} evap={evap}")


def test_fused_host_library_argument_lists():
    lib = adk._load("host", "ad_fused")
    assert lib.cloudsc2_ad_fused_signature().decode() == adk.fused_signature()
