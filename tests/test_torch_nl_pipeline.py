# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The NL kernel's pipelined scan (``levelscan.cuh``
``level_scan_pipelined_column`` over ``nl_level.h`` ``NLPipeBody``, the
harness the card runs), compiled for the host, against the direct scan of
the same body (``level_scan_host`` of ``NLBody``): bitwise.

The pipelined scan copies each level's raw inputs into a ring of D slots
ahead of the level and folds them from the slot; the direct scan loads and
folds them at the level.  Both run the same arithmetic on the same values,
so any difference is the ring's indexing: the slot a level reads, the
prefetch distance, the first D - 1 levels issued before the prologue, the
empty groups past the last level, ``nlev < D``.  The host ring models the
card's asynchrony (a copy lands only when a wait retires its group, the ring
starts as NaN), so a read before its wait or a slot refilled before it was
read changes the outputs.  D is the card's, per dtype
(``kernels.nonlinear.ring_depth``).

Every form: fused or not, ``traj`` 0 / 1 / 2, evaporation, the three divide
modes in float32, both ``CUADJ_COMPACT`` libraries, float32 and float64
(LPHYLIN, so the thermo switch, off in the ``CUADJ_COMPACT=False`` half),
each at ``nlev`` 2, D - 1, D, D + 1 and 137 and ``ncols`` 1, 100 and 130.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.state import state_from_numpy

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
NCOLS = (1, 100, 130)
FORMS = [
    (dtype, compact, div, fuse, traj, evap)
    for dtype in DTYPES
    for compact in (True, False)
    for div in (("exact", "faithful", "approx") if dtype == "f32" else ("exact",))
    for fuse in (False, True)
    for traj in (0, 1, 2)
    for evap in (False, True)
]


@pytest.fixture(scope="module", autouse=True)
def _host_libraries():
    """Both host libraries (``CUADJ_COMPACT`` on and off), built at once."""
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(nlk._load, "host", compact) for compact in (True, False)]:
            f.result()


@functools.lru_cache(maxsize=None)
def _state(dtype, nlev, ncols, lphylin):
    np_dtype, torch_dtype = DTYPES[dtype]
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=nlev * 1000 + ncols, dtype=np_dtype)
    s = state_from_numpy(state, torch.device("cpu"), torch_dtype)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=lphylin, c=make_constants())
    return s, dt


def _levels(depth):
    return sorted({n for n in (2, depth - 1, depth, depth + 1, 137) if n >= 2})


@pytest.mark.parametrize("dtype,compact,div,fuse,traj,evap", FORMS)
def test_pipelined_scan_is_the_direct_scan(dtype, compact, div, fuse, traj, evap):
    c = make_constants(lphylin=compact, ldrain1d=False).replace(
        LEVAPLS2=evap, FAST_DIV=div, CUADJ_COMPACT=compact)
    opts = {"fuse_saturation": fuse, "with_trajectory": traj > 0, "traj_only": traj == 2}
    depth = nlk.ring_depth(DTYPES[dtype][1])
    for nlev in _levels(depth):
        for ncols in NCOLS:
            s, dt = _state(dtype, nlev, ncols, compact)
            got = nlk.cloudsc2_nl_host(s, dt, c, **opts)
            want = nlk.cloudsc2_nl_direct_host(s, dt, c, **opts)
            label = f"{dtype} D={depth} {nlev}x{ncols}"
            assert len(got) == len(want), label
            for g, w in zip(got, want):
                assert g.keys() == w.keys(), label
                for k in w:
                    assert torch.equal(g[k], w[k]), (
                        f"{label} {k}: max abs difference {(g[k] - w[k]).abs().max().item():.3e}")


def test_wrapper_refuses_an_output_that_overlaps_an_input():
    """The kernel reads a level's inputs ahead of the stores of the levels
    before it, so the wrapper refuses outputs that overlap an input (here
    the first output allocated as the state's ``t`` itself) before anything
    runs; storage that only touches an input passes."""
    c = make_constants()
    s, dt = _state("f32", 8, 100, True)
    t0 = s["t"].clone()
    overlapping = nlk.allocated_by(lambda shape, dtype, device: (
        s["t"] if tuple(shape) == tuple(s["t"].shape) else torch.empty(shape, dtype=dtype, device=device)))
    with overlapping, pytest.raises(ValueError, match="overlaps input 't'"):
        nlk.cloudsc2_nl_host(s, dt, c)
    assert torch.equal(s["t"], t0)
    buf = torch.empty(2 * s["t"].numel(), dtype=s["t"].dtype)
    touching = {"tnd_t": buf[s["t"].numel():]}
    nlk.check_disjoint([buf[: s["t"].numel()]], touching)
