# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's two probes (``cloudsc2_tpu_torch/kernels/microbench.py``): the
reader and the chain, against the Pallas kernels of the JAX scripts in
interpret mode, against their host builds, and through their drivers.

The JAX kernels are taken from the scripts' source: the functions
``make_reader`` (``benchmarks/microbench_hbm.py``) and ``make_chain`` with
``VARIANTS`` and ``_nr`` (``benchmarks/microbench_div.py``) are executed in a
namespace that holds the scripts' constants and a ``pl`` whose
``pallas_call`` runs in interpret mode and drops ``compiler_params``.
Importing the scripts is no option: ``microbench_hbm.py`` runs its benchmark
at import, and ``microbench_div.py`` would set JAX's compilation cache
directory for the whole test process.

Reader.  JAX adds each block of 16 levels into its accumulator as a block
sum; the port adds level by level, stream by stream: rtol 1e-5 of the sum
(read: 1.19e-6).  The JAX kernel reads past its array at its own depth: with
NLEV = 137 and KB = 16 its grid has ceil(137 / 16) = 9 level blocks, and the
last covers rows 128-143, 7 of them outside the array; in interpret mode it
returns NaN in every column (on the TPU it summed whatever the DMA brought).
So it is compared at NLEV 128 and 144, which KB divides, and the port's
reader, which sums the 137 real levels, is held at 137 against a float64
numpy sum (rtol 1e-5: 411 float32 additions of values in [0, 1); read:
1.10e-6).

Chain.  ``div`` and ``rcpx`` are bitwise JAX's.  ``rcp``, ``rcpx1`` and
``rcpx2`` are not: XLA on the CPU contracts a product and the add that
follows into one FMA (the chain's ``1.25 * r`` into the next step's ``+ 1``,
and ``2 - b * r`` in the Newton step), where the kernel, built with
``--fmad=false``, and the plain version round each operation.  Readings at 8
x 256, REPS 3, n = 2 and 5: largest relative difference 1.66e-7 (rcp),
2.49e-7 (rcpx1, rcpx2); held at rtol 1e-6.  (``rcpx`` rounds ``x + 1`` to
bfloat16 before its reciprocal, which absorbs the one rounding's difference
at these points.)
"""
import ast
import json
import math
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cloudsc2_tpu_torch.kernels import microbench as mb

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_probe(script, names, constants):
    """The named top-level functions and assignments of a JAX probe script,
    executed with ``constants`` and an interpret-mode ``pallas_call``."""
    tree = ast.parse((REPO / "benchmarks" / script).read_text())

    def wanted(node):
        if isinstance(node, ast.FunctionDef):
            return node.name in names
        return isinstance(node, ast.Assign) and any(getattr(t, "id", None) in names for t in node.targets)

    def pallas_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        return pl.pallas_call(*args, interpret=True, **kwargs)

    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("_")})
    shim.pallas_call = pallas_call
    ns = {"jax": jax, "jnp": jnp, "math": math, "pl": shim, "pltpu": pltpu, **constants}
    module = ast.Module(body=[n for n in tree.body if wanted(n)], type_ignores=[])
    exec(compile(module, script, "exec"), ns)
    return ns


def _streams(rng, nstreams, shape):
    return [torch.from_numpy(rng.uniform(size=shape).astype(np.float32)) for _ in range(nstreams)]


@pytest.mark.parametrize("layout", mb.LAYOUTS)
@pytest.mark.parametrize("nlev", [128, 144])
def test_plain_reader_matches_jax_make_reader(nlev, layout):
    """3 streams, 8192 columns: the plain reader against ``make_reader`` in
    interpret mode, both layouts (JAX's ``(NLEV, 8, w)`` is the port's
    ``(nlev, ncols)``; its tile ``(nj, NLEV, 8, 512)`` the port's ``(nj,
    nlev, 4096)``, whose column ``j * 4096 + r * 512 + i`` JAX writes at
    ``(r, j * 512 + i)``)."""
    ncols, nstreams = 8192, 3
    ns = _jax_probe("microbench_hbm.py", {"make_reader"}, dict(NLEV=nlev, KB=16, WB=512, S=nstreams))
    call, shape = ns["make_reader"](ncols, layout == "tile")
    xs = [np.random.default_rng(i).uniform(size=shape).astype(np.float32) for i in range(nstreams)]
    got = np.asarray(call(jnp.full((1,), 2.0, jnp.float32), *map(jnp.asarray, xs)))
    if layout == "tile":
        got = got.reshape(8, ncols // mb.TILE, mb.TILE // 8).transpose(1, 0, 2)
    got = got.reshape(ncols)
    streams = [torch.from_numpy(x.reshape(mb.reader_shape(layout, nlev, ncols))) for x in xs]
    mine = mb.plain_reader(streams, 2.0, layout).numpy()
    np.testing.assert_allclose(mine, got, rtol=1e-5, atol=0)


@pytest.mark.parametrize("layout,ncols", [("global", 1000), ("tile", 5000)])
def test_plain_reader_sums_the_real_levels(layout, ncols):
    """At 137 levels, where the JAX kernel's last block runs past its array,
    the plain reader is the sum over the 137 real levels (float64 numpy),
    also over a ragged last tile."""
    rng = np.random.default_rng(1)
    streams = _streams(rng, 3, mb.reader_shape(layout, 137, ncols))
    got = mb.plain_reader(streams, -3.0, layout, ncols).numpy()
    tot = sum(s.numpy().astype(np.float64) for s in streams)
    if layout == "tile":
        tot = tot.transpose(1, 0, 2).reshape(137, -1)[:, :ncols]
    np.testing.assert_allclose(got, tot.sum(axis=0) - 3.0, rtol=1e-5, atol=0)
    assert got.shape == (ncols,)


#: the plain chain against the JAX chain: bitwise, or this rtol (module docstring)
CHAIN_BITWISE = {"div", "rcpx"}


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("variant", mb.VARIANTS)
def test_plain_chain_matches_jax_make_chain(variant, n):
    """8 x 256 elements (half the columns in [1e-6, 1], half in [1, 1e6]),
    BLOCK_COLS 128, REPS 3 launches of n steps: the plain chain against
    ``make_chain`` in interpret mode."""
    reps = 3
    ns = _jax_probe("microbench_div.py", {"make_chain", "VARIANTS", "_nr"},
                    dict(ROWS=8, COLS=256, BLOCK_COLS=128, REPS=reps))
    rng = np.random.default_rng(2)
    row = np.concatenate([rng.uniform(1e-6, 1.0, 128), rng.uniform(1.0, 1e6, 128)])
    x0 = np.stack([row * (1 + 0.01 * r) for r in range(8)]).astype(np.float32)
    want = np.asarray(ns["make_chain"](variant, n)(jnp.asarray(x0)))
    x = torch.from_numpy(x0)
    for _ in range(reps):
        x = mb.plain_chain(x, variant, n)
    got = x.numpy()
    if variant in CHAIN_BITWISE:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("nstreams,ncols", [(3, 4096), (10, 4000), (32, 100)])
@pytest.mark.parametrize("layout", mb.LAYOUTS)
def test_reader_host_build_bitwise_plain(layout, nstreams, ncols):
    """The reader kernel's body, compiled for the host, bitwise its plain
    version: full, ragged and one-block column counts, up to the most
    streams."""
    streams = _streams(np.random.default_rng(nstreams), nstreams, mb.reader_shape(layout, 137, ncols))
    want = mb.plain_reader(streams, 5.0, layout, ncols)
    assert torch.equal(mb.reader_host(streams, 5.0, layout, ncols), want)
    assert torch.equal(mb.reader(streams, 5.0, layout, ncols), want)


@pytest.mark.parametrize("variant", mb.VARIANTS)
def test_chain_host_build_bitwise_plain(variant):
    """The chain kernel's body, compiled for the host (the approximate
    reciprocal as interpret mode computes it), bitwise its plain version:
    n below, at and above the 16 unrolled steps, and n = 0."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([rng.uniform(1e-6, 1.0, 700), rng.uniform(1.0, 1e6, 700)])
                         .astype(np.float32).reshape(14, 100))
    for n in (0, 1, 5, 16, 37):
        want = mb.plain_chain(x, variant, n)
        assert torch.equal(mb.chain_host(x, variant, n), want), n
        assert torch.equal(mb.chain(x, variant, n), want), n


def test_plain_chain_takes_the_approximate_reciprocal():
    """``plain_chain``'s ``approx`` is the reciprocal its ``rcpx`` variants
    start from: by default interpret mode's; given the IEEE reciprocal,
    ``rcpx`` is ``rcp`` bitwise and ``rcpx1`` one Newton step of it."""
    from cloudsc2_tpu_torch.physics import fastmath

    x = torch.from_numpy(_wide(4, 300))
    for variant in mb.VARIANTS:
        default = mb.plain_chain(x, variant, 3)
        assert torch.equal(mb.plain_chain(x, variant, 3, lambda b: fastmath.rcp(b, "approx")), default), variant
    assert torch.equal(mb.plain_chain(x, "rcpx", 4, torch.reciprocal), mb.plain_chain(x, "rcp", 4))
    b = x + 1.0
    r = torch.reciprocal(b)
    assert torch.equal(mb.plain_chain(x, "rcpx1", 1, torch.reciprocal), 1.25 * (r * (2.0 - b * r)))


def test_step_ulps_reads_ulps_of_the_float64_map():
    """``step_ulps``: the float32 rounding of the map is within half an ulp,
    one ulp up from it within 1.5; ``div`` and ``rcp`` (IEEE on the CPU as
    on the card) within their ``STEP_ULP_BOUND`` over the wide range."""
    from drivers.microbench_div_torch import STEP_ULP_BOUND, step_ulps

    x = torch.from_numpy(_wide(16, 4096))
    exact = (1.25 / (x.double() + 1.0)).float()
    assert step_ulps(x, exact) <= 0.5
    up = torch.nextafter(exact, torch.full_like(exact, float("inf")))
    assert 0.5 <= step_ulps(x, up) <= 1.5
    for variant in ("div", "rcp"):
        assert step_ulps(x, mb.plain_chain(x, variant, 1)) <= STEP_ULP_BOUND[variant], variant


def _wide(rows, cols):
    from drivers.microbench_div_torch import wide_operands

    return wide_operands(rows, cols, seed=4)


def test_probe_library_reports_the_wrappers_lists():
    """The host library reports the variants, stream limit and tile width
    the wrapper passes."""
    lib = mb._load("host")
    assert lib.cloudsc2_microbench_signature().decode() == mb._SIGNATURE


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: CPU tensors are refused before
    anything is built, and neither launch count moves."""
    before = (mb.reader_cuda.launches, mb.chain_cuda.launches)
    streams = _streams(np.random.default_rng(0), 2, (5, 8))
    with pytest.raises(ValueError, match="cuda"):
        mb.reader_cuda(streams, 0.0)
    with pytest.raises(ValueError, match="cuda"):
        mb.chain_cuda(streams[0], "div", 3)
    assert (mb.reader_cuda.launches, mb.chain_cuda.launches) == before


def _reader_case(case):
    s = _streams(np.random.default_rng(0), 2, (5, 8))
    tile = _streams(np.random.default_rng(0), 2, (2, 5, mb.TILE))
    return {
        "f64": ([s[0].double(), s[1].double()], "global", None, TypeError, "dtype"),
        "shapes differ": ([s[0], s[1][:, :4].contiguous()], "global", None, ValueError, "stream 1"),
        "too many streams": ([s[0]] * (mb.MAX_STREAMS + 1), "global", None, ValueError, "streams"),
        "no streams": ([], "global", None, ValueError, "streams"),
        "not contiguous": ([s[0], s[1].t().contiguous().t()], "global", None, ValueError, "contiguous"),
        "global ncols": (s, "global", 7, ValueError, "columns"),
        "tile width": ([x[:, :, :8].contiguous() for x in tile], "tile", None, ValueError, "4096"),
        "tile ncols": (tile, "tile", mb.TILE, ValueError, "columns"),
        "1-D": ([x[0] for x in s], "global", None, ValueError, "2-D"),
        "layout": (s, "rows", None, ValueError, "layout"),
    }[case]


@pytest.mark.parametrize("case", ["f64", "shapes differ", "too many streams", "no streams", "not contiguous",
                                  "global ncols", "tile width", "tile ncols", "1-D", "layout"])
def test_reader_wrappers_check_their_arguments(case):
    """The plain version and the host build refuse what the kernel does not
    take: float64, streams of different shapes, more than 32 streams, a
    non-contiguous stream, a column count the arrays do not hold, a tile of
    another width, another layout."""
    streams, layout, ncols, err, match = _reader_case(case)
    for fn in (mb.plain_reader, mb.reader_host):
        with pytest.raises(err, match=match):
            fn(streams, 0.0, layout, ncols)


def test_chain_wrappers_check_their_arguments():
    x = torch.ones(4, 8)
    for fn in (mb.plain_chain, mb.chain_host):
        with pytest.raises(TypeError, match="float32"):
            fn(x.double(), "div", 2)
        with pytest.raises(ValueError, match="variant"):
            fn(x, "rcpx3", 2)
        with pytest.raises(ValueError, match="n >= 0"):
            fn(x, "div", -1)
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.t(), "div", 2)


def test_dispatch_refuses_other_devices():
    """Dispatch goes by device: a meta tensor has no implementation, and
    nothing falls back."""
    with pytest.raises(ValueError, match="no reader implementation"):
        mb.reader([torch.ones(5, 8, device="meta")], 0.0)
    with pytest.raises(ValueError, match="no chain implementation"):
        mb.chain(torch.ones(5, 8, device="meta"), "div", 2)


def _driver(name, *args):
    proc = subprocess.run([sys.executable, f"drivers/{name}.py", "--device", "cpu", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def test_hbm_driver_runs_on_the_cpu():
    """The read-bandwidth driver at 64 columns, 2 streams: one line per
    layout with the JAX script's keys, labelled as CPU host-clock times."""
    lines = _driver("microbench_hbm_torch", "6", "--streams", "2")
    assert [(x["ncols"], x["tile"]) for x in lines] == [(64, False), (64, True)]
    for x in lines:
        assert {"ncols", "tile", "streams", "step_bytes_gb", "per_step_ms", "read_gb_per_s"} <= x.keys()
        assert x["streams"] == 2 and x["l2_resident"] and x["device"] == "cpu"
        assert x["step_bytes_gb"] == 2 * 137 * 64 * 4 / 1e9
        assert "no device timing" in x["card"] and x["library_ms"] > 0


def test_div_driver_runs_on_the_cpu():
    """The divide-chain driver at 4 x 64, 2 launches: each variant's
    ``chain_rel_err`` and ``step_ulp_err`` and timing line with the JAX
    script's keys, then the latency reading; ``div`` and ``rcp`` within
    float32 rounding of the float64 chain and their one-step ulp bounds on
    the CPU too; the card's bounds and placement only on the card."""
    lines = _driver("microbench_div_torch", "--rows", "4", "--cols", "64", "--reps", "2")
    errs = {x["variant"]: x["chain_rel_err"] for x in lines if "chain_rel_err" in x}
    timed = [x for x in lines if "ns_per_elem" in x]
    latency = [x for x in lines if "ns_per_step" in x]
    assert list(errs) == [x["variant"] for x in timed] == [x["variant"] for x in latency] == list(mb.VARIANTS)
    assert errs["div"] <= 1e-6 and errs["rcp"] <= 1e-6
    ulps = {x["variant"]: x["step_ulp_err"] for x in lines if "step_ulp_err" in x}
    assert list(ulps) == list(mb.VARIANTS) and ulps["div"] <= 1.5 and ulps["rcp"] <= 2.5
    assert not any("step_ulp_bound" in x or "one_warp_per_sm" in x for x in lines)
    for x in timed:
        assert {"ns_per_elem", "vs_div", "t_short_ms", "t_long_ms"} <= x.keys() and x["elements"] == 256
    assert timed[0]["vs_div"] == 1.0
    assert all(x["elements"] == 132 * 32 and x["device"] == "cpu" for x in latency)
