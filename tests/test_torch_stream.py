# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's column-chunked stream (cloudsc2_tpu_torch.parallel.stream)
against the JAX package's (cloudsc2_tpu.parallel.stream), on the CPU, where
it runs the plain version chunk after chunk.  A base state of 16 columns at
20 levels, chunks of 24 columns.

* The byte counts and the ring equal JAX's: ``build_ring`` bitwise; the
  flat host ring holds the same numbers.
* Chunk 0 of ``stream_columns`` equals JAX ``stream_columns(impl="scan")``'s
  at the golden double gate (rtol 1e-10, atol 1e-16), half and full
  duplex; the stats have JAX's keys; a ragged ``total_cols`` rounds up as
  JAX's does.
* The checksums are bitwise the chunk-order sums of the one-shot
  ``forward_step`` outputs of ring slot ``i % ring``: in half duplex
  ``torch.sum`` / ``torch.stack``, in full duplex numpy's sums; the full
  duplex's sample is bitwise slot 0's one-shot output.  A chunk computed
  from the wrong slot, or a host slot read before its chunk landed, moves
  them.
* A CUDA device without a card raises, with no fall back; a pageable ring
  is refused for a CUDA device.
* The NL driver's ``--stream-chunk`` prints the JAX driver's lines and
  HOORAY (tests/test_framework.py:469-503).
"""
import math

import numpy as np
import pytest
import torch

from cloudsc2_tpu.parallel import stream as jstream
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.parallel import stream
from cloudsc2_tpu_torch.parallel.step import forward_step
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.utils.compare import DIAGNOSTICS, TENDENCIES
from tests.torch_helpers import CONFIGS, assert_fields, flat, jax_constants

torch.set_num_threads(1)

NLEV, BASE, CHUNK, RING = 20, 16, 24, 3
GOLDEN_F64 = {n: (1e-10, 1e-16) for n in TENDENCIES + DIAGNOSTICS}


@pytest.fixture(scope="module")
def base():
    _, state, dt = iox.synthesize_input(ncols=BASE, nlev=NLEV, seed=0)
    return state, dt


@pytest.mark.parametrize("nlev", [20, 137])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_byte_counts_equal_jax(nlev, itemsize):
    assert stream.h2d_bytes_per_column(nlev, itemsize) == jstream.h2d_bytes_per_column(nlev, itemsize)
    assert stream.d2h_bytes_per_column(nlev, itemsize) == jstream.d2h_bytes_per_column(nlev, itemsize)
    assert (stream.h2d_bytes_per_column(137, 4), stream.d2h_bytes_per_column(137, 4)) == (8224, 5496)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("chunk", [7, 16, 37])
def test_build_ring_bitwise_jax(base, dtype, chunk):
    state = {k: v.astype(dtype) for k, v in base[0].items()}
    mine = stream.build_ring(state, chunk, RING)
    theirs = jstream.build_ring(state, chunk, RING)
    assert len(mine) == len(theirs) == RING
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)
    host = stream.host_ring(mine, pin=False)
    for slot, chunk_np in zip(host, mine):
        assert not slot.flat.is_pinned()
        for k, v in chunk_np.items():
            t = slot.fields[k]
            offset = t.data_ptr() - slot.flat.data_ptr()
            assert t.is_contiguous() and offset % (stream.ALIGN * t.element_size()) == 0
            np.testing.assert_array_equal(t.numpy(), v, err_msg=k)


def _one_shot(ring_np, dt, c, fuse=True):
    """Each ring slot's one-shot ``forward_step``, eta from slot 0."""
    slots = [{k: torch.from_numpy(v) for k, v in chunk.items()} for chunk in ring_np]
    eta = eta_levels(slots[0]["ap"], slots[0]["aph"])
    return [forward_step(dict(s, eta=eta), dt, c, fuse) for s in slots]


@pytest.mark.parametrize("outputs", [False, True], ids=["half", "full"])
def test_stream_chunk0_matches_jax_and_stats_keys(base, outputs):
    state, dt = base
    c = CONFIGS["default"]()
    stats, (tends, diags) = stream.stream_columns(
        state, dt, c, total_cols=3 * CHUNK, chunk_cols=CHUNK, ring_size=RING, device="cpu",
        stream_outputs=outputs)
    jstats, jout = jstream.stream_columns(
        state, dt, jax_constants(c), total_cols=3 * CHUNK, chunk_cols=CHUNK, ring_size=RING, impl="scan",
        stream_outputs=outputs)
    assert stats.keys() == jstats.keys()
    for k in ("total_cols", "chunk_cols", "nchunks", "h2d_bytes_per_col", "d2h_bytes_per_col"):
        assert stats.get(k) == jstats.get(k), k
    np.testing.assert_allclose(stats["checksum"], jstats["checksum"], rtol=1e-10)
    want = flat(jout)
    got = flat((tends, diags))
    assert_fields({k: got[k] for k in want}, want, GOLDEN_F64, "chunk 0")
    assert all(v.shape[1] == CHUNK for v in got.values())


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("ring", [1, 2, 3])
def test_stream_checksums_bitwise_one_shot(base, fuse, ring):
    """Five chunks over ``ring`` slots: each duplex mode's checksum is the
    chunk-order sum of the one-shot outputs of slot ``i % ring``, bit for
    bit, and the full duplex's host sample is slot 0's one-shot output."""
    state, dt = base
    c = CONFIGS["levapls2"]()
    nchunks = 5
    one = _one_shot(stream.build_ring(state, CHUNK, ring), dt, c, fuse)
    half, (t0, d0) = stream.stream_columns(state, dt, c, total_cols=nchunks * CHUNK, chunk_cols=CHUNK,
                                           ring_size=ring, device="cpu", fuse_saturation=fuse)
    want = float(torch.sum(torch.stack([torch.sum(one[i % ring][0]["t"]) for i in range(nchunks)])))
    assert half["checksum"] == want
    for k, v in {**t0, **d0}.items():
        assert torch.equal(v, {**one[0][0], **one[0][1]}[k]), k
    full, (t0, d0) = stream.stream_columns(state, dt, c, total_cols=nchunks * CHUNK, chunk_cols=CHUNK,
                                           ring_size=ring, device="cpu", fuse_saturation=fuse,
                                           stream_outputs=True)
    want = 0.0
    for i in range(nchunks):
        want += float(one[i % ring][0]["t"].numpy().sum())
    assert full["checksum"] == want
    assert sorted(d0) == sorted(stream.OUT_DIAGS) and sorted(t0) == ["q", "qi", "ql", "t"]
    for k, v in {**t0, **d0}.items():
        assert torch.equal(v, {**one[0][0], **one[0][1]}[k]), k
    if ring > 1:
        slot1 = float(torch.sum(one[1][0]["t"]))
        assert slot1 != float(torch.sum(one[0][0]["t"])), "ring slots must differ"


@pytest.mark.parametrize("total", [CHUNK * 2 + 1, CHUNK * 3 - 1, CHUNK])
def test_stream_ragged_total_rounds_up_as_jax(base, total):
    state, dt = base
    c = CONFIGS["default"]()
    stats, _ = stream.stream_columns(state, dt, c, total_cols=total, chunk_cols=CHUNK, ring_size=2, device="cpu")
    jstats, _ = jstream.stream_columns(state, dt, jax_constants(c), total_cols=total, chunk_cols=CHUNK,
                                       ring_size=2, impl="scan")
    assert stats["nchunks"] == jstats["nchunks"] == math.ceil(total / CHUNK)
    assert stats["total_cols"] == jstats["total_cols"] == stats["nchunks"] * CHUNK


def test_stream_cuda_without_card_raises(base):
    """A CUDA device on a machine without one is an error, never a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    state, dt = base
    with pytest.raises(RuntimeError, match="cuda"):
        stream.stream_columns(state, dt, CONFIGS["default"](), total_cols=2 * CHUNK, chunk_cols=CHUNK)


def test_sweep_refuses_pageable_ring_for_cuda(base):
    """A ring that is not pinned is refused for a CUDA device before any
    copy: a copy from pageable memory would run synchronously."""
    state, dt = base
    ring = stream.host_ring(stream.build_ring(state, CHUNK, 2), pin=False)
    with pytest.raises(ValueError, match="pageable"):
        stream.sweep_ring(ring, dt, CONFIGS["default"](), nchunks=2, device="cuda")


@pytest.mark.parametrize("argv", [
    [],
    ["--stream-outputs"],
    ["--no-fuse-saturation", "--precision", "single"],
], ids=["half", "full", "two-stage-single"])
def test_driver_streams_and_validates(argv, capsys):
    from drivers.run_nonlinear_torch import main

    rc = main(["--device", "cpu", "--num-cols", "1000", "--stream-chunk", "200", "--stream-ring", "2", *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Streamed 1000 columns in 5 chunks of 200" in out
    assert ("Full duplex" in out) == ("--stream-outputs" in argv)
    assert "HOORAY" in out and "FAILED" not in out
