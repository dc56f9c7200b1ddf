# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Guards of the PyTorch port (cloudsc2_tpu_torch): it never imports jax,
its GPU smoke test refuses to run without a card, its state conversion is
exact, and its wrappers raise rather than fall back."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cloudsc2_tpu import iox, make_constants
from cloudsc2_tpu_torch import dispatch
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.physics.increment import state_increment
from cloudsc2_tpu_torch.state import (
    NL_CONST_NAMES,
    TL_CONST_NAMES,
    kernel_constants,
    state_from_numpy,
    tl_kernel_constants,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "cloudsc2_tpu_torch"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_never_import_jax():
    """AST scan: no file of the port (nor its driver and smoke test)
    imports jax or a module of the JAX package that does."""
    jax_modules = ("jax", "jaxlib", "cloudsc2_tpu.physics", "cloudsc2_tpu.pallas",
                   "cloudsc2_tpu.components", "cloudsc2_tpu.dispatch", "cloudsc2_tpu.parallel",
                   "cloudsc2_tpu.validation")
    files = sorted(PORT.rglob("*.py")) + [
        REPO / "drivers" / "run_nonlinear_torch.py",
        REPO / "drivers" / "run_taylor_test_torch.py",
        REPO / "chip_smoke.py",
    ]
    assert len(files) > 10
    offenders = [
        f"{p.relative_to(REPO)}: {m}"
        for p in files
        for m in _imported_modules(p)
        if any(m == j or m.startswith(j + ".") for j in jax_modules)
    ]
    assert not offenders, offenders


def test_chip_smoke_imports_only_the_port():
    """AST scan: the GPU smoke test reaches the JAX package's modules only
    through the port and its driver, never by importing ``cloudsc2_tpu``
    itself (not even its numpy-only modules)."""
    modules = list(_imported_modules(REPO / "chip_smoke.py"))
    assert "cloudsc2_tpu_torch.state" in modules
    offenders = [m for m in modules if m in ("jax", "cloudsc2_tpu") or m.startswith(("jax.", "cloudsc2_tpu."))]
    assert not offenders, offenders


def test_port_import_leaves_jax_unloaded():
    """Importing every module of the port and its driver in a fresh process
    with ``import jax`` blocked succeeds, and leaves jax out of sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    ) + ["drivers.run_nonlinear_torch", "drivers.run_taylor_test_torch"]
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith('jax.') or name == 'jaxlib':\n"
        "            raise ImportError('jax is blocked: ' + name)\n"
        "for m in [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """``python chip_smoke.py`` on a machine without CUDA (and, alone, in a
    directory without the rest of the repo) exits non-zero and prints no
    ``"ok": true`` result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the smoke test would run for real")
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300, env=env
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_state_from_numpy_round_trips(dtype):
    """Every field of the JAX package's numpy state survives the trip to
    tensors and back bit for bit."""
    _, state, _ = iox.synthesize_input(ncols=37, nlev=11, seed=3, dtype=dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    ts = state_from_numpy(state, torch.device("cpu"), tdtype)
    assert ts.keys() == state.keys()
    for k, v in state.items():
        assert ts[k].dtype == tdtype and ts[k].is_contiguous()
        back = ts[k].numpy()
        assert back.dtype == v.dtype
        np.testing.assert_array_equal(back.view(np.uint8), np.ascontiguousarray(v).view(np.uint8), err_msg=k)


def test_kernel_constants_fold_in_double_and_round_once():
    """The constant struct is folded in double and rounded once: each f32
    entry is the f32 rounding of the f64 entry, and a compound entry is
    not the product of its rounded factors."""
    c = make_constants(lphylin=True, ldrain1d=False)
    k64 = kernel_constants(c, 1800.0, torch.float64)
    k32 = kernel_constants(c, 1800.0, torch.float32)
    assert k64.shape == k32.shape == (len(NL_CONST_NAMES),)
    assert k64.dtype == np.float64 and k32.dtype == np.float32
    np.testing.assert_array_equal(k32, k64.astype(np.float32))
    at = dict(zip(NL_CONST_NAMES, k64))
    assert at["cons2"] == 1.0 / (c.RG * 1800.0)
    assert at["lcrit_k"] == 1.0 / (2.0 * c.RCLCRIT) ** 2
    ldrain = dict(zip(NL_CONST_NAMES, kernel_constants(make_constants(ldrain1d=True), 1800.0, torch.float64)))
    assert ldrain["icrit_k"] == 1.0 / (0.0001 * 0.0001)


def test_cuda_wrapper_raises_on_cpu_tensors():
    """The CUDA wrapper launches or raises: CPU tensors are refused before
    anything is built, and the launch count does not move."""
    c = make_constants()
    _, state, dt = iox.synthesize_input(ncols=8, nlev=5, seed=0)
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = s["ap"][:, 0] / s["aph"][-1, 0]
    s["qsat"] = torch.zeros_like(s["ap"])
    before = nlk.cloudsc2_nl_cuda.launches
    with pytest.raises(ValueError, match="cuda"):
        nlk.cloudsc2_nl_cuda(s, dt, c)
    assert nlk.cloudsc2_nl_cuda.launches == before


def test_wrapper_checks_shapes_dtypes_and_options():
    """The argument checks shared by the CUDA and host wrappers."""
    c = make_constants()
    _, state, dt = iox.synthesize_input(ncols=8, nlev=5, seed=0)
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = s["ap"][:, 0] / s["aph"][-1, 0]
    s["qsat"] = torch.zeros_like(s["ap"])
    with pytest.raises(TypeError, match="dtype"):
        nlk.cloudsc2_nl_host({**s, "q": s["q"].float()}, dt, c)
    with pytest.raises(ValueError, match="shape"):
        nlk.cloudsc2_nl_host({**s, "aph": s["aph"][:-1]}, dt, c)
    with pytest.raises(ValueError, match="contiguous"):
        nlk.cloudsc2_nl_host({**s, "t": s["t"].t().contiguous().t()}, dt, c)
    with pytest.raises(NotImplementedError, match="FAST_DIV"):
        nlk.cloudsc2_nl_host(s, dt, c.replace(FAST_DIV="approx"))
    with pytest.raises(NotImplementedError, match="CUADJ_COMPACT"):
        nlk.cloudsc2_nl_host(s, dt, c.replace(CUADJ_COMPACT=False))


def test_tl_kernel_constants_fold_in_double_and_round_once():
    """The TL constant struct is folded in double and rounded once; the
    LREGCL autoconversion damping lives in dl_k/di_k."""
    c = make_constants(lphylin=True, ldrain1d=False)
    k64 = tl_kernel_constants(c, 1800.0, torch.float64)
    k32 = tl_kernel_constants(c, 1800.0, torch.float32)
    assert k64.shape == k32.shape == (len(TL_CONST_NAMES),)
    assert k64.dtype == np.float64 and k32.dtype == np.float32
    np.testing.assert_array_equal(k32, k64.astype(np.float32))
    on = dict(zip(TL_CONST_NAMES, k64))
    off = dict(zip(TL_CONST_NAMES, tl_kernel_constants(c.replace(LREGCL=False), 1800.0, torch.float64)))
    lcrit = 2.0 * c.RCLCRIT
    assert on["dl_k"] == 2.0 * (2.0 * c.RKCONV * 1800.0 / 100.0) / lcrit**2.0
    assert off["dl_k"] == 2.0 * (2.0 * c.RKCONV * 1800.0) / lcrit**2.0
    assert on["di_k"] == 5.0 * c.RKCONV * 1800.0 / 100.0 and off["di_k"] == 5.0 * c.RKCONV * 1800.0
    assert on["beta_i_k"] == 0.5777 * c.RG * c.RPECONS / 0.00509
    assert on["mdt_rg"] == -1800.0 * c.RG
    # the constants shared with the NL struct are the same numbers
    nl = dict(zip(NL_CONST_NAMES, kernel_constants(c, 1800.0, torch.float64)))
    for n in set(NL_CONST_NAMES) & set(TL_CONST_NAMES):
        assert on[n] == nl[n], n


def _tl_cpu_state():
    c = make_constants()
    _, state, dt = iox.synthesize_input(ncols=8, nlev=5, seed=0)
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s["eta"] = s["ap"][:, 0] / s["aph"][-1, 0]
    s["qsat"] = torch.zeros_like(s["ap"])
    s.update(state_increment(s, 0.01))
    return s, dt, c


def test_tl_cuda_wrapper_raises_on_cpu_tensors():
    """The TL CUDA wrapper launches or raises: CPU tensors are refused
    before anything is built, and the launch count does not move."""
    s, dt, c = _tl_cpu_state()
    before = tlk.cloudsc2_tl_cuda.launches
    for tangent_only in (False, True):
        with pytest.raises(ValueError, match="cuda"):
            tlk.cloudsc2_tl_cuda(s, dt, c, tangent_only)
    assert tlk.cloudsc2_tl_cuda.launches == before


def test_tl_wrapper_checks_shapes_dtypes_and_options():
    s, dt, c = _tl_cpu_state()
    with pytest.raises(TypeError, match="dtype"):
        tlk.cloudsc2_tl_host({**s, "q_i": s["q_i"].float()}, dt, c)
    with pytest.raises(ValueError, match="shape"):
        tlk.cloudsc2_tl_host({**s, "aph_i": s["aph_i"][:-1]}, dt, c)
    with pytest.raises(ValueError, match="contiguous"):
        tlk.cloudsc2_tl_host({**s, "t_i": s["t_i"].t().contiguous().t()}, dt, c)
    with pytest.raises(KeyError):
        tlk.cloudsc2_tl_host({k: v for k, v in s.items() if k != "lu_i"}, dt, c)
    with pytest.raises(NotImplementedError, match="FAST_DIV"):
        tlk.cloudsc2_tl_host(s, dt, c.replace(FAST_DIV="approx"))


def test_dispatch_refuses_other_devices():
    """Dispatch goes by device: a tensor on neither the CPU nor a CUDA
    device has no implementation, and nothing falls back."""
    s, dt, c = _tl_cpu_state()
    meta = {k: v.to("meta") for k, v in s.items()}
    with pytest.raises(ValueError, match="no NL implementation"):
        dispatch.cloudsc2_nl(meta, dt, c)
    with pytest.raises(ValueError, match="no TL implementation"):
        dispatch.cloudsc2_tl(meta, dt, c)
