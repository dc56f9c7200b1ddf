# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's column mesh (cloudsc2_tpu_torch.parallel.mesh) and the sharded
half of its step functions (cloudsc2_tpu_torch.parallel.step) against the
JAX package's on the tier-1 8-device virtual CPU mesh (tests/conftest.py).
The port's shards are virtual shards of the CPU, where each runs the plain
versions.  The stream tests' 20 levels, except where the JAX test uses 137.

* ``pad_columns`` / ``unpad_columns`` bitwise JAX's on numpy, and the
  tensor path bitwise the numpy one; ``column_mesh``'s factorings, and its
  refusal of cards that are not there; ``shard_state``,
  ``gather_columns`` and ``process_local_block`` round trips.
* ``make_sharded_forward_step`` on 4 and 8 shards against JAX's on the
  8-device mesh (``impl="scan"``): f64 at the port's plain-vs-JAX-scan gate
  (rtol 1e-10, atol 1e-16), f32 at tests/test_parallel.py's (rtol 3e-5;
  atol 1e-7 on tendencies, 1e-5 on diagnostics); and bitwise the port's
  unsharded step.
* eta from the global column 0 (a port of
  tests/test_parallel.py:153-184): with ``ap / aph_s`` varying by column
  the sharded step is bitwise the unsharded one, whether the state comes
  whole or sharded, and a shard-local eta would not be.
* ``full_step`` under ``make_sharded_fn``: per-column norms sharded like
  the columns, the unsharded ``full_step``'s to rtol 1e-13 (its
  tendencies bitwise), within the symmetry gate.
* The Taylor and symmetry protocols with ``mesh`` against the JAX
  protocols with the same mesh and padding: norms at rtol 1e-10, the same
  verdicts.
* ``dryrun_multichip(4, device="cpu")``, and the three drivers'
  ``--sharded --device cpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc2_tpu.parallel import mesh as jmesh
from cloudsc2_tpu.parallel import step as jstep
from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.parallel import mesh
from cloudsc2_tpu_torch.parallel.step import (
    forward_step,
    full_step,
    make_sharded_fn,
    make_sharded_forward_step,
    make_sharded_physics,
)
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.utils.compare import DIAGNOSTICS, TENDENCIES
from tests.torch_helpers import CONFIGS, TORCH, assert_fields, flat, jax_constants

torch.set_num_threads(1)

NLEV = 20
GOLDEN_F64 = {n: (1e-10, 1e-16) for n in TENDENCIES + DIAGNOSTICS}
#: tests/test_parallel.py:137-148
PARALLEL_F32 = {**{n: (3e-5, 1e-7) for n in TENDENCIES}, **{n: (3e-5, 1e-5) for n in DIAGNOSTICS}}


def _state(ncols, dtype, seed=0, nlev=NLEV):
    _, state, dt = iox.synthesize_input(ncols=ncols, nlev=nlev, seed=seed, dtype=dtype)
    return state, dt


def _gather(tree):
    return {k: mesh.gather_columns(v) for k, v in tree.items()}


# ---- the mesh


def test_pad_unpad_bitwise_jax():
    state, _ = _state(100, np.float64)
    state["eta"] = state["ap"][:, 0] / state["aph"][-1, 0]
    mine, n = mesh.pad_columns(state, 128)
    ref, jn = jmesh.pad_columns(state, 128)
    assert n == jn == 100 and mine.keys() == ref.keys()
    for k in ref:
        assert isinstance(mine[k], np.ndarray)
        np.testing.assert_array_equal(mine[k].view(np.uint8), ref[k].view(np.uint8), err_msg=k)
    tensors, _ = mesh.pad_columns(state_from_numpy(state, torch.device("cpu"), torch.float64), 128)
    for k in ref:
        np.testing.assert_array_equal(tensors[k].numpy(), ref[k], err_msg=k)
    for got, want in ((mesh.unpad_columns(mine, n), jmesh.unpad_columns(ref, n)),
                      (mesh.unpad_columns(tensors, n), state)):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    same, _ = mesh.pad_columns(state, 50)
    assert all(same[k] is state[k] for k in state)


def test_column_mesh_shapes():
    m = mesh.column_mesh(8, device="cpu")
    assert m.shape == (1, 8) and m.size == 8 and m.axis_names == jmesh.MESH_AXES == mesh.MESH_AXES
    assert m.devices == (torch.device("cpu"),) * 8 and (m.process_index, m.process_count) == (0, 1)
    assert mesh.column_mesh(8, n_nodes=2, device="cpu").shape == (2, 4)
    assert mesh.column_mesh(device="cpu").shape == (1, 1)
    assert [m.columns(64, d) for d in (0, 7)] == [(0, 8), (56, 64)]
    with pytest.raises(ValueError, match="not divisible"):
        mesh.column_mesh(6, n_nodes=4, device="cpu")
    with pytest.raises(ValueError, match="pad_columns"):
        m.columns(60, 0)
    with pytest.raises(ValueError, match="unsupported"):
        mesh.column_mesh(2, device="meta")


def test_column_mesh_refuses_missing_cards(monkeypatch):
    """A CUDA mesh takes real cards: none on this machine, and on a machine
    of one card, two shards, raise; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.column_mesh(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 card"):
        mesh.column_mesh(2, device="cuda")
    one = mesh.column_mesh(device="cuda")
    assert one.shape == (1, 1) and one.devices == (torch.device("cuda", 0),)


def test_shard_gather_round_trip():
    state, _ = _state(24, np.float64)
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    m = mesh.column_mesh(4, n_nodes=2, device="cpu")
    assert mesh.state_shardings(s) == {k: k != "eta" for k in s}
    sharded = mesh.shard_state(s, m)
    assert mesh.shard_state(sharded, m)["t"] is sharded["t"]
    t = sharded["t"]
    assert t.shape == (NLEV, 24) and t.column_sharded and len(t.shards) == 4
    assert [tuple(x.shape) for x in t.shards] == [(NLEV, 6)] * 4 and all(x.is_contiguous() for x in t.shards)
    assert not sharded["eta"].column_sharded and all(torch.equal(x, s["eta"]) for x in sharded["eta"].shards)
    for k, v in s.items():
        assert torch.equal(mesh.gather_columns(sharded[k]), v), k
    block, cols = mesh.process_local_block(sharded["aph"])
    assert cols == (0, 24) and torch.equal(block, s["aph"])
    # numpy in, the same tensors out
    from_np = mesh.shard_state(state, m)
    assert all(torch.equal(mesh.gather_columns(from_np[k]), s[k]) for k in state)


# ---- the sharded forward step


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's sharded forward step on the 8-device mesh, 32 x 20, by dtype."""
    jm = jmesh.column_mesh(8)
    c = CONFIGS["default"]()
    out = {}
    for dtype in (np.float64, np.float32):
        state, dt = _state(32, dtype)
        step = jstep.make_sharded_forward_step(jm, dt=dt, c=jax_constants(c), impl="scan")
        out[dtype] = flat(step(jmesh.shard_state({k: jnp.asarray(v) for k, v in state.items()}, jm)))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_forward_step_matches_jax(jax_forward, shards, dtype):
    state, dt = _state(32, dtype)
    c = CONFIGS["default"]()
    want = jax_forward[dtype]

    m = mesh.column_mesh(shards, device="cpu")
    s = state_from_numpy(state, torch.device("cpu"), TORCH[dtype])
    tends, diags = make_sharded_forward_step(m, dt=dt, c=c)(s)
    assert all(len(v.shards) == shards and v.column_sharded for v in {**tends, **diags}.values())
    got = flat((_gather(tends), _gather(diags)))
    assert sorted(got) == sorted([*want, "qsat"])
    assert_fields({k: got[k] for k in want}, want, GOLDEN_F64 if dtype == np.float64 else PARALLEL_F32,
                  f"{shards} shards")
    # the columns are independent: bitwise the unsharded step
    single = flat(forward_step(s, dt, c))
    for k, v in single.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _column_varying_state():
    """tests/test_parallel.py:159-168: ap scaled by a per-column, per-level
    factor, so that ap / aph_s varies by column."""
    state, dt = _state(64, np.float32, seed=3, nlev=137)
    nlev, ncols = state["ap"].shape
    w = 0.02 * np.sin(np.arange(ncols) + 1.0)[None, :]
    h = np.linspace(0.0, 1.0, nlev)[:, None]
    state["ap"] = state["ap"] * (1.0 + w * h).astype(np.float32)
    return state, dt


def test_sharded_forward_step_eta_from_global_column0():
    state, dt = _column_varying_state()
    c = CONFIGS["default"]()
    s = state_from_numpy(state, torch.device("cpu"), torch.float32)
    m = mesh.column_mesh(4, device="cpu")
    single = {k: v for d in forward_step(s, dt, c) for k, v in d.items()}
    for given in (s, mesh.shard_state(s, m)):  # eta derived whole, or from shard 0
        got = {k: v for d in make_sharded_forward_step(m, dt=dt, c=c)(given) for k, v in d.items()}
        for k, v in single.items():
            assert torch.equal(mesh.gather_columns(got[k]), v), k
    # the trap is armed: shard 1 with its own eta steps otherwise
    cols = slice(*m.columns(64, 1))
    local = forward_step({k: v[:, cols].contiguous() for k, v in s.items()}, dt, c)[0]["t"]
    assert not torch.equal(local, single["t"][:, cols])


def test_sharded_eta_needs_column0_in_this_process():
    """A process that does not hold the global column 0 cannot derive eta."""
    s = state_from_numpy(_state(8, np.float64)[0], torch.device("cpu"), torch.float64)
    other = mesh.ColumnMesh((2, 1), 1, 2, (torch.device("cpu"),))
    with pytest.raises(ValueError, match="before sharding"):
        make_sharded_forward_step(other, dt=1800.0, c=CONFIGS["default"]())(mesh.shard_state(s, other))


# ---- full_step and the protocols under a mesh


def test_full_step_sharded_norms():
    """The norms are column-sharded ``(ncols,)`` vectors equal to the
    unsharded ``full_step``'s (which tests/test_torch_step.py holds to
    JAX's) to rtol 1e-13: the same level sums, which torch orders by the
    tensor's width (read 2.2e-16); the tendencies bitwise; within the
    symmetry gate."""
    state, dt = _state(16, np.float64)
    c = CONFIGS["default"]()
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    m = mesh.column_mesh(4, device="cpu")
    step = make_sharded_fn(full_step, m, s, dt=dt, c=c)
    tends, norm1, norm2 = step(mesh.shard_state(s, m))
    assert norm1.shape == (16,) and norm1.column_sharded and [tuple(x.shape) for x in norm1.shards] == [(4,)] * 4
    n1, n2 = mesh.gather_columns(norm1).numpy(), mesh.gather_columns(norm2).numpy()
    want_tends, want1, want2 = full_step(s, dt, c)
    np.testing.assert_allclose(n1, want1.numpy(), rtol=1e-13, atol=0)
    np.testing.assert_allclose(n2, want2.numpy(), rtol=1e-13, atol=0)
    for k, v in want_tends.items():
        assert torch.equal(mesh.gather_columns(tends[k]), v), k
    assert np.abs(n1).max() > 0
    eps = np.finfo(np.float64).eps
    assert (np.abs(n1 - n2) / (eps * np.abs(n2))).max() < 1e4
    with pytest.raises(ValueError, match="not the step's"):
        step({k: v for k, v in s.items() if k != "eta"})


@pytest.fixture(scope="module")
def padded16():
    """16 columns padded to a multiple of 4 shards as the drivers pad
    (column 0 repeated), f64, with eta; the JAX state on the same mesh."""
    state, dt = _state(13, np.float64)
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s, _ = mesh.pad_columns(s, 4)
    jm = jmesh.column_mesh(4)
    return s, dt, jm, jmesh.shard_state({k: jnp.asarray(v.numpy()) for k, v in s.items()}, jm)


def test_taylor_with_mesh_matches_jax(padded16):
    from cloudsc2_tpu.validation.taylor import TaylorTest as JaxTaylor
    from cloudsc2_tpu_torch.validation.taylor import TaylorTest

    s, dt, jm, js = padded16
    c = CONFIGS["default"]()
    tt = TaylorTest(constants=c, mesh=mesh.column_mesh(4, device="cpu"))
    jt = JaxTaylor(constants=jax_constants(c), impl="scan", mesh=jm)
    norms, jnorms = tt.run(s, dt), jt.run(js, dt)
    # to λ = 1e-4, as tests/test_torch_taylor.py: below, the norm is a
    # cancelled difference over λ
    np.testing.assert_allclose(norms[:4], jnorms[:4], rtol=1e-8)
    assert (tt.validate(verbose=False) <= 5) == (jt.validate(verbose=False) <= 5)
    # bitwise the unsharded protocol: the shards run the same plain code
    np.testing.assert_array_equal(norms, TaylorTest(constants=c).run(s, dt))


def test_symmetry_with_mesh_matches_jax(padded16):
    from cloudsc2_tpu.validation.symmetry import SymmetryTest as JaxSymmetry
    from cloudsc2_tpu_torch.validation.symmetry import SymmetryTest

    s, dt, jm, js = padded16
    c = CONFIGS["default"]()
    st = SymmetryTest(constants=c, mesh=mesh.column_mesh(4, device="cpu"))
    n1, n2 = st.run(s, dt)
    j1, j2 = JaxSymmetry(constants=jax_constants(c), impl="scan", mesh=jm).run(js, dt)
    np.testing.assert_allclose(n1, j1, rtol=1e-10, atol=0)
    np.testing.assert_allclose(n2, j2, rtol=1e-10, atol=0)
    err = st.validate(n1, n2, verbose=False)
    assert (err < 1e4) == (JaxSymmetry.validate(None, j1, j2, verbose=False) < 1e4) and err < 1e4


def test_sharded_physics_refuses_a_multi_process_mesh():
    other = mesh.ColumnMesh((2, 1), 0, 2, (torch.device("cpu"),))
    with pytest.raises(ValueError, match="single-process"):
        make_sharded_physics(forward_step, other)


# ---- the dry run and the drivers


def test_dryrun_multichip_cpu():
    """The port's dry run at its contract (nlev 137, 128 columns a shard,
    both factorings, the golden NL gate, the symmetry gate), all asserted
    inside the function."""
    from cloudsc2_tpu_torch.parallel.dryrun import dryrun_multichip

    readings = dryrun_multichip(4, device="cpu")
    assert sorted(readings) == [(1, 4), (2, 2)]
    assert all(r["symmetry_eps"] < 1e4 and r["norm1_max"] > 0 for r in readings.values())


def test_nl_driver_sharded(capsys):
    from drivers import run_nonlinear_torch as drv

    assert drv.main(["--device", "cpu", "--sharded", "--num-cols", "100"]) == 0
    out = capsys.readouterr().out
    assert "holds columns [0, 128) of 128 (100 real)" in out and "HOORAY" in out
    with pytest.raises(ValueError, match="single-device"):
        drv.main(["--device", "cpu", "--sharded", "--num-cols", "100", "--stream-chunk", "50"])


def test_taylor_driver_sharded_per_column(capsys):
    from drivers import run_taylor_test_torch as drv

    assert drv.main(["--device", "cpu", "--sharded", "--num-cols", "4", "--per-column"]) == 0
    out = capsys.readouterr().out
    assert "128 columns (4 real)" in out and "columns passing individually" in out and "HOORAY" in out


def test_symmetry_driver_sharded(capsys):
    from drivers import run_symmetry_test_torch as drv

    assert drv.main(["--device", "cpu", "--sharded", "--num-cols", "4"]) == 0
    out = capsys.readouterr().out
    assert "128 columns (4 real)" in out and "HOORAY" in out


def test_sharded_drivers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from drivers import run_nonlinear_torch as drv

    with pytest.raises(RuntimeError, match="is_available"):
        drv.main(["--device", "cuda", "--sharded", "--num-cols", "8"])
