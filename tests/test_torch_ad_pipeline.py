# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The AD reverse kernel's pipelined scan (``levelscan.cuh``
``level_scan_pipelined_column`` run bottom-up over ``ad_level.h``
``ADPipeBody``, the harness the card runs), compiled for the host, against
the direct reverse scan of the same level (``level_scan_host`` of
``ADBody``): bitwise.

The pipelined scan copies each level's 27 input values (29 with
evaporation: the raw fields, the seeds, the trajectory) into a ring of D
slots while the levels below it run, and folds them from the slot; the
direct scan loads and folds them at the level.  Both run the same
arithmetic on the same values, so any difference is the ring's indexing:
the slot a level reads, the prefetch distance, the bottom D - 1 levels
issued before the prologue, the empty groups past level 0, the interface
carried up from the level below, ``nlev < D``.  The host ring models the
card's asynchrony (a copy lands only when a wait retires its group, the
ring starts as NaN), so a read before its wait or a slot refilled before it
was read changes the outputs.  D is the card's, per dtype
(``kernels.adjoint.reverse_ring_depth``).

Every form: evaporation, LREGCL, the three divide modes in float32, both
``CUADJ_COMPACT`` libraries, float32 and float64, LPHYLIN off in the
``CUADJ_COMPACT=False`` half (the trajectory from the host NL kernel under
``forward_constants``), each at ``nlev`` 2, D - 1, D, D + 1 and 137 and
``ncols`` 1, 100 and 130.  The seeds are random, made with numpy from a
seed: the comparison needs no particular cotangent.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import build
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.state import state_from_numpy

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
NCOLS = (1, 100, 130)
FORMS = [
    (dtype, compact, div, evap, lregcl)
    for dtype in DTYPES
    for compact in (True, False)
    for div in (("exact", "faithful", "approx") if dtype == "f32" else ("exact",))
    for evap in (False, True)
    for lregcl in (True, False)
]
#: the seeds the reverse kernel reads
SEEDS = ("tnd_t_i", "tnd_q_i", "tnd_ql_i", "tnd_qi_i", "clc_i", "covptot_i",
         "fplsl_i", "fplsn_i", "fhpsl_i", "fhpsn_i")


@pytest.fixture(scope="module", autouse=True)
def _host_libraries():
    """The NL host libraries (the trajectory) and the AD host library of
    every form, built at once."""
    loads = [functools.partial(nlk._load, "host", compact) for compact in (True, False)]
    loads += [functools.partial(adk._load, "host", "ad", compact, fast) for compact, fast in build.FORMS]
    with ThreadPoolExecutor(len(loads)) as pool:
        for f in [pool.submit(load) for load in loads]:
            f.result()


@functools.lru_cache(maxsize=None)
def _state(dtype, nlev, ncols, lphylin):
    np_dtype, torch_dtype = DTYPES[dtype]
    seed = nlev * 1000 + ncols
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=seed, dtype=np_dtype)
    s = state_from_numpy(state, torch.device("cpu"), torch_dtype)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=lphylin, c=make_constants())
    rng = np.random.default_rng(seed)
    for n in SEEDS:
        rows = nlev + 1 if n[:4] in ("fpls", "fhps") else nlev
        s[n] = torch.from_numpy(rng.standard_normal((rows, ncols)).astype(np_dtype))
    return s, dt


def _levels(depth):
    return sorted({n for n in (2, depth - 1, depth, depth + 1, 137) if n >= 2})


@pytest.mark.parametrize("dtype,compact,div,evap,lregcl", FORMS)
def test_pipelined_reverse_scan_is_the_direct_scan(dtype, compact, div, evap, lregcl):
    c = make_constants(lphylin=compact, ldrain1d=False).replace(
        LEVAPLS2=evap, LREGCL=lregcl, FAST_DIV=div, CUADJ_COMPACT=compact)
    depth = adk.reverse_ring_depth(DTYPES[dtype][1])
    for nlev in _levels(depth):
        for ncols in NCOLS:
            s, dt = _state(dtype, nlev, ncols, compact)
            traj = nlk.cloudsc2_nl_host(s, dt, adk.forward_constants(c), with_trajectory=True, traj_only=True)[2]
            got = adk.cloudsc2_ad_reverse_host(s, traj, dt, c)
            want = adk.cloudsc2_ad_reverse_host(s, traj, dt, c, direct=True)
            label = f"{dtype} D={depth} {nlev}x{ncols}"
            assert got.keys() == want.keys() and len(want) == 16, label
            assert all(torch.isfinite(w).all() for w in want.values()), label
            for k in want:
                assert torch.equal(got[k], want[k]), (
                    f"{label} {k}: max abs difference {(got[k] - want[k]).abs().max().item():.3e}")


def test_reverse_wrapper_refuses_an_output_that_overlaps_an_input():
    """The kernel reads the next levels up ahead of the stores of the levels
    below them, so the wrapper refuses outputs that overlap an input (here
    the first output allocated as the state's ``t`` itself) before anything
    runs."""
    c = make_constants()
    s, dt = _state("f32", 8, 100, True)
    traj = nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True, traj_only=True)[2]
    t0 = s["t"].clone()
    overlapping = nlk.allocated_by(lambda shape, dtype, device: (
        s["t"] if tuple(shape) == tuple(s["t"].shape) else torch.empty(shape, dtype=dtype, device=device)))
    with overlapping, pytest.raises(ValueError, match="overlaps input 't'"):
        adk.cloudsc2_ad_reverse_host(s, traj, dt, c)
    assert torch.equal(s["t"], t0)


@pytest.mark.parametrize("dtype, evap, shared, blocks", [
    (torch.float32, False, 27648 + 548, (7, 4, 3, 2)),
    (torch.float32, True, 29696 + 548, (7, 4, 3, 2)),
    (torch.float64, False, 55296 + 1096, (4, 4, 3, 2)),
    (torch.float64, True, 59392 + 1096, (3, 3, 3, 2)),
])
def test_reverse_plan_counts_the_ring(dtype, evap, shared, blocks):
    """The plan of the reverse kernel's launch at 137 levels: the level
    table (137 values) and a ring of 2 slots of 27 values a thread (29 with
    evaporation) for 128 threads, and the blocks of 128 an SM at 64, 128,
    168 and 255 registers a thread, the fewer of what the registers and the
    shared bytes leave: in f32 the registers set them from 128 registers up
    (4 at 128: 512 threads); in f64 the ring of more than 48 KB caps them
    at 4, 3 with evaporation."""
    assert adk.reverse_ring_depth(dtype) == 2
    assert adk.reverse_ring_fields(evap) == (29 if evap else 27)
    for registers, want in zip((64, 128, 168, 255), blocks):
        plan = adk.reverse_plan(dtype, evap, registers, 2)
        assert plan == {"block": 128, "blocks_per_sm": want, "shared_bytes": shared, "depth": 2}, registers
    assert adk.reverse_plan(torch.float32, evap, 128, 4)["blocks_per_sm"] == (3 if evap else 4)
