# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's golden-file writers (cloudsc2_tpu_torch.iox.write_input_h5,
write_reference_h5) and generator (drivers/generate_reference_torch.py),
into a temporary directory only.

* The generator's three files are ``data/input_synth.h5`` and
  ``data/reference_synth_{double,single}.h5`` dataset for dataset: the same
  names, dtypes, shapes and bytes.
* Each writer's file equals the JAX writer's on the same arrays, with the
  default parameter groups and with groups read back from a file.
* ``data/`` is not written: its files keep their bytes.
"""
import hashlib
import pathlib

import h5py
import numpy as np
import pytest

from cloudsc2_tpu import iox as jiox
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.oracle import golden_outputs
from cloudsc2_tpu_torch.params import make_constants

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
FILES = ("input_synth.h5", "reference_synth_double.h5", "reference_synth_single.h5")


def assert_same_datasets(got, want):
    with h5py.File(got, "r") as a, h5py.File(want, "r") as b:
        assert sorted(a) == sorted(b)
        for k in b:
            x, y = a[k][()], b[k][()]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), k


def _digests():
    return {f: hashlib.sha256((DATA / f).read_bytes()).hexdigest() for f in FILES}


def test_generator_reproduces_the_committed_data(tmp_path):
    from drivers import generate_reference_torch as gen

    before = _digests()
    assert gen.main(["--out-dir", str(tmp_path)]) == 0
    for f in FILES:
        assert_same_datasets(tmp_path / f, DATA / f)
    assert _digests() == before


@pytest.mark.parametrize("params", ["default", "read back"])
def test_writers_equal_jax(tmp_path, params):
    _, state, dt = iox.synthesize_input(ncols=7, nlev=5, seed=2)
    groups = None
    if params == "read back":
        with h5py.File(DATA / "input_synth.h5", "r") as f:
            groups = iox.read_params(f)
    iox.write_input_h5(str(tmp_path / "mine.h5"), state, dt, groups)
    jiox.write_input_h5(str(tmp_path / "jax.h5"), state, dt, groups)
    assert_same_datasets(tmp_path / "mine.h5", tmp_path / "jax.h5")
    # and the port reads back what it wrote
    grid, back, dt_back, _ = iox.load_input(str(tmp_path / "mine.h5"))
    assert (grid.nlev, grid.ncols, dt_back) == (5, 7, dt)
    assert all(np.array_equal(back[k], state[k]) for k in state)

    tends, diags = golden_outputs(state, dt, make_constants(lphylin=True, ldrain1d=False), np.float32)
    iox.write_reference_h5(str(tmp_path / "ref_mine.h5"), tends, diags)
    jiox.write_reference_h5(str(tmp_path / "ref_jax.h5"), tends, diags)
    assert_same_datasets(tmp_path / "ref_mine.h5", tmp_path / "ref_jax.h5")
