# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""``scalm`` derived inside the kernels from ``eta``
(``kernels/csrc/nl_level.h`` ``ScalmTable``, the "level table" of
``levelscan.cuh``): no wrapper computes it, and the kernels' derivation is
torch's ``scalm_profile``.

On the CPU: no NL, TL or AD entry calls ``physics.nonlinear.scalm_profile``
(patched to raise) in any form; the argument lists the wrappers pass and
the host libraries report take ``eta`` and no ``scalm``, and the constant
structs end in ``zscal``, ``zeps1``; the host build's derivation
(``scalm_host``, glibc's ``pow``) is within 2 ulps of ``scalm_profile``
(PyTorch's vectorized ``pow`` on the CPU) over [0, 1] and the clamp's edge.

On the card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_scalm.py``: tests/conftest.py imports jax, which that
machine may not have, and this file imports none): the kernels' derivation
(``scalm_cuda``) bitwise ``scalm_profile`` on the card on every float32 in
[0, 1] and on ``eta`` of the 4 pool states of the benchmark's generator
(``portbench/generate.py``) in each cell's precision at its 262,144
columns.  In float64 it is not bitwise everywhere: the kernels are built
``--fmad=false`` and PyTorch with FMA contraction, and libdevice's ``pow``
rounds differently at a few arguments in ten million under the two (with
contraction the same derivation was bitwise on all of the samples below,
NVIDIA H100, CUDA 12.9 against PyTorch's 12.8).  So on 1.34e8 float64
samples of [0, 1], 3.4e7 about the clamp and its edge (0.2, 0.2 + ZEPS1,
0 and 1, with their neighbours to 64 ulps) the test holds it within 2 ulps
at no more than 1e-6 of the samples, and prints the count.
"""
import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics import nonlinear as physics_nl
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.physics.nonlinear import scalm_profile
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.state import NL_CONST_NAMES, TL_CONST_NAMES, state_from_numpy

BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _state(nlev=137, ncols=6):
    """A seeded state with increments and seeds, ``eta`` from 0.004 at the
    top to 0.996 at the bottom, across the clamp at 0.2."""
    c = make_constants()
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=11, dtype=np.float64)
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=True, c=c)
    s.update(state_increment(s, 0.01))
    rng = np.random.default_rng(11)
    for n in adk.AD_SEEDS:
        rows = nlev + 1 if n[:4] in ("fpls", "fhps") else nlev
        s[n] = torch.from_numpy(rng.standard_normal((rows, ncols)) * 1e-3)
    assert bool((s["eta"] < 0.2).any()) and bool((s["eta"] > 0.2).any())
    return s, dt, c


#: every entry of the port's kernels on the host, each form that reads eta
ENTRIES = {
    "nl": lambda s, dt, c: nlk.cloudsc2_nl_host(s, dt, c),
    "nl fused": lambda s, dt, c: nlk.cloudsc2_nl_host(s, dt, c, fuse_saturation=True),
    "nl trajectory": lambda s, dt, c: nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True),
    "nl traj_only": lambda s, dt, c: nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True, traj_only=True),
    "nl direct": lambda s, dt, c: nlk.cloudsc2_nl_direct_host(s, dt, c),
    "tl": lambda s, dt, c: tlk.cloudsc2_tl_host(s, dt, c),
    "tl tangent_only": lambda s, dt, c: tlk.cloudsc2_tl_host(s, dt, c, tangent_only=True),
    "ad": lambda s, dt, c: adk.cloudsc2_ad_host(s, dt, c),
    "ad cotangent_only": lambda s, dt, c: adk.cloudsc2_ad_host(s, dt, c, cotangent_only=True),
    "ad reverse direct": lambda s, dt, c: adk.cloudsc2_ad_reverse_host(
        s, nlk.cloudsc2_nl_host(s, dt, c, with_trajectory=True)[2], dt, c, direct=True),
    "ad fused": lambda s, dt, c: adk.cloudsc2_ad_fused_host(s, dt, c),
    "ad fused resident": lambda s, dt, c: adk.cloudsc2_ad_fused_host(s, dt, c, resident=True),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_no_wrapper_calls_scalm_profile(entry, monkeypatch):
    """With ``scalm_profile`` made to raise, every entry still runs: the
    kernels derive ``scalm`` themselves, and no kernel module holds a
    reference of its own to the function."""
    s, dt, c = _state()

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper called scalm_profile")

    monkeypatch.setattr(physics_nl, "scalm_profile", refuse)
    for mod in (nlk, tlk, adk):
        assert not hasattr(mod, "scalm_profile"), mod.__name__
    out = ENTRIES[entry](s, dt, c)
    tensors = [v for d in (out if isinstance(out, tuple) else (out,)) for v in d.values()]
    assert tensors and all(bool(v.isfinite().all()) for v in tensors)


def test_argument_lists_take_eta_and_no_scalm():
    """The wrappers' lists and the host libraries' (each library reports
    its own, and loading it holds the two equal): ``eta`` the last input of
    every kernel and ``scalm`` none, and both constant structs end in
    ``zscal``, ``zeps1``."""
    lists = {"nl": nlk.NL_INPUTS, "tl": tlk.TL_INPUTS, "ad": adk.AD_INPUTS, "ad fused": adk.AD_FUSED_INPUTS}
    for name, inputs in lists.items():
        assert inputs[-1] == "eta" and "scalm" not in inputs, name
    assert NL_CONST_NAMES[-2:] == TL_CONST_NAMES[-2:] == ("zscal", "zeps1")
    assert nlk._load("host").cloudsc2_nl_signature().decode() == nlk.signature()
    assert tlk._load("host").cloudsc2_tl_signature().decode() == tlk.signature()
    assert adk._load("host").cloudsc2_ad_signature().decode() == adk.signature()
    assert adk._load("host", "ad_fused").cloudsc2_ad_fused_signature().decode() == adk.fused_signature()
    for sig in (nlk.signature(), tlk.signature(), adk.signature(), adk.fused_signature()):
        assert "scalm," not in sig and "eta," in sig
    # the pointwise level entry of the duality tests still takes scalm itself
    assert adk.AD_LEVEL_X[-2:] == ("eta", "scalm")


def _ulps(got, want):
    it = BITS[got.dtype]
    return (got.view(it).to(torch.int64) - want.view(it).to(torch.int64)).abs()


def _edge(dtype, c, ulps=4):
    """The clamp's edge and the interval's ends, with their neighbours to
    ``ulps`` ulps on each side."""
    points = torch.tensor([0.0, 0.2, 0.2 + c.ZEPS1, 1.0], dtype=dtype)
    out = [points]
    up, down = points.clone(), points.clone()
    for _ in range(ulps):
        up = torch.nextafter(up, torch.full_like(up, 2.0))
        down = torch.nextafter(down, torch.full_like(down, -1.0))
        out += [up, down]
    return torch.cat(out).clamp(min=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_host_derivation_is_scalm_profile_to_two_ulps(dtype):
    """The host build's derivation against ``scalm_profile`` on the CPU:
    the same operations in the same order, whose only difference is the
    libm ``pow`` (glibc's against PyTorch's vectorized one), to 2 ulps."""
    c = make_constants()
    g = torch.Generator().manual_seed(5)
    eta = torch.cat([torch.rand(1_000_000, generator=g, dtype=dtype), _edge(dtype, c)])
    got = nlk.scalm_host(eta, c)
    assert int(_ulps(got, scalm_profile(eta, c)).max()) <= 2
    with pytest.raises(ValueError, match="contiguous"):
        nlk.scalm_host(eta[::2], c)


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _differ(eta, c):
    """``(values that differ, largest ulp distance)`` of the kernels'
    derivation against ``scalm_profile`` over ``eta``."""
    d = _ulps(nlk.scalm_cuda(eta, c), scalm_profile(eta, c))
    return int((d != 0).sum()), int(d.max())


def _assert_bitwise(eta, c, label):
    bad, ulps = _differ(eta, c)
    assert bad == 0, f"{label}: {bad} of {eta.numel()} differ, up to {ulps} ulps"


@pytest.mark.cuda
def test_every_float32_in_the_unit_interval_on_card(card):
    """Every float32 from 0 to 1 (1,065,353,217 values, in chunks of 2**26
    by their bits): the kernels' derivation bitwise ``scalm_profile``."""
    c = make_constants()
    top = int(torch.tensor(1.0).view(torch.int32))
    chunk = 1 << 26
    for lo in range(0, top + 1, chunk):
        bits = torch.arange(lo, min(lo + chunk, top + 1), dtype=torch.int32, device=card)
        _assert_bitwise(bits.view(torch.float32), c, f"float32 bits [{lo}, {lo + bits.numel()})")


@pytest.mark.cuda
def test_float64_samples_and_the_clamps_edge_on_card(card, capsys):
    """134,217,728 float64 samples of [0, 1], 16,777,216 within 1e-9 of
    0.2 and as many within 1e-9 of 0.2 + ZEPS1, and the edge points with
    their neighbours: the kernels' derivation within 2 ulps of
    ``scalm_profile`` at no more than 1e-6 of them (libdevice's ``pow``
    without FMA contraction against PyTorch's with it), the float32 edge
    bitwise."""
    c = make_constants()
    g = torch.Generator(device=card).manual_seed(18)
    chunk = 1 << 24
    sets = {"uniform": [torch.rand(chunk, generator=g, dtype=torch.float64, device=card) for _ in range(8)]}
    for centre in (0.2, 0.2 + c.ZEPS1):
        sets[f"about {centre!r}"] = [
            centre + 1e-9 * (2.0 * torch.rand(chunk, generator=g, dtype=torch.float64, device=card) - 1.0)]
    sets["edge"] = [_edge(torch.float64, c, ulps=64).to(card)]
    for name, chunks in sets.items():
        found = [_differ(eta, c) for eta in chunks]
        bad, ulps, n = sum(b for b, _ in found), max(u for _, u in found), sum(e.numel() for e in chunks)
        with capsys.disabled():
            print(f"\nfloat64 {name}: {bad} of {n} differ, up to {ulps} ulps")
        assert ulps <= 2 and bad <= 1e-6 * n, (name, bad, n, ulps)
    _assert_bitwise(_edge(torch.float32, c, ulps=64).to(card), c, "edge float32")


#: seeds of the benchmark's runs that this test holds, and each cell's
#: precision and columns
SEEDS = (0, 3_000_000_018, 2**31 + 18)
CELLS = {"nl-f32-c262144": torch.float32, "tlad-f64-c262144": torch.float64}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_the_benchmark_pool_states_on_card(card, cell):
    """``eta`` of the 4 pool states of each seed, derived as the cell's
    entry derives it (the state in the cell's precision, then
    ``eta_levels``) at 262,144 columns: the kernels' derivation bitwise
    ``scalm_profile``."""
    from portbench.generate import synthesize

    c = make_constants()
    for seed in SEEDS:
        for index in range(4):
            x = synthesize(262_144, 137, seed, index, card)
            eta = eta_levels(x["ap"].to(CELLS[cell]), x["aph"].to(CELLS[cell]))
            del x
            _assert_bitwise(eta, c, f"{cell} seed {seed} state {index}")
