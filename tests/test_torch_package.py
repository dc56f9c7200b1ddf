# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Guards of the PyTorch port (cloudsc2_tpu_torch): it imports neither jax
nor anything of the JAX package, its copies of the JAX package's numpy-only
modules equal their originals, its GPU smoke test refuses to run without a
card, its state conversion is exact, and its wrappers raise rather than fall
back."""
import ast
import dataclasses
import itertools
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import dispatch, iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.params import Constants, constants_from_mapping, make_constants
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
#: the port's drivers, which import the port only
DRIVERS = ("run_nonlinear_torch", "run_taylor_test_torch", "run_symmetry_test_torch", "kernel_ab_torch",
           "microbench_hbm_torch", "microbench_div_torch", "generate_reference_torch")
#: the port's test worker process, which imports the port only
WORKERS = ("torch_distributed_worker",)
#: what the port may not import: jax, and the JAX package with any module of it
FORBIDDEN = ("jax", "jaxlib", "cloudsc2_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_never_import_jax():
    """AST scan: no file of the port (nor its drivers, its test worker and
    smoke test) imports jax, the JAX package or any module of it, nor the
    JAX drivers' configuration (which imports the JAX package)."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "drivers" / f"{d}.py" for d in DRIVERS] + [
        REPO / "tests" / f"{w}.py" for w in WORKERS] + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [
        f"{p.relative_to(REPO)}: {m}"
        for p in files
        for m in _imported_modules(p)
        if m == "drivers.config" or any(m == j or m.startswith(j + ".") for j in FORBIDDEN)
    ]
    assert not offenders, offenders


#: the system headers the kernel sources may include (no library of finished
#: kernels, no PyTorch headers)
SYSTEM_HEADERS = {"cuda_runtime.h", "math.h", "string.h", "vector"}


def test_kernel_sources_include_only_their_own_headers():
    """Every CUDA and C++ source of the port includes only headers of its
    own ``csrc/`` and the system headers of ``SYSTEM_HEADERS``; every
    ``.cu`` has a host build of the same bodies, and every ``.cu`` and
    ``.cpp`` is built by a wrapper of the port."""
    csrc = PORT / "kernels" / "csrc"
    sources = sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh", ".h", ".cpp"))
    assert {p.name for p in sources} >= {"ad_fused.cu", "ad_fused_host.cpp", "ad_fused.h", "levelscan.cuh"}
    offenders = []
    for p in sources:
        for quoted, angled in re.findall(r'^\s*#\s*include\s*(?:"([^"]+)"|<([^>]+)>)', p.read_text(), re.M):
            if (quoted and not (csrc / quoted).is_file()) or (angled and angled not in SYSTEM_HEADERS):
                offenders.append(f"{p.name}: {quoted or angled}")
    assert not offenders, offenders
    wrappers = "".join(p.read_text() for p in (PORT / "kernels").glob("*.py"))
    for p in sources:
        if p.suffix == ".cu":
            assert (csrc / f"{p.stem}_host.cpp").is_file(), f"{p.name} has no host build"
        if p.suffix in (".cu", ".cpp"):
            assert f'"{p.name}"' in wrappers, f"{p.name} is built by no wrapper"


def test_chip_smoke_imports_only_the_port():
    """AST scan: the GPU smoke test reaches the JAX package's modules only
    through the port and its driver, never by importing ``cloudsc2_tpu``
    itself (not even its numpy-only modules)."""
    modules = list(_imported_modules(REPO / "chip_smoke.py"))
    assert "cloudsc2_tpu_torch.state" in modules
    offenders = [m for m in modules if m in ("jax", "cloudsc2_tpu") or m.startswith(("jax.", "cloudsc2_tpu."))]
    assert not offenders, offenders


def test_port_import_leaves_jax_unloaded():
    """Importing every module of the port, its drivers and its test worker
    in a fresh process with jax and the JAX package blocked succeeds, and
    leaves both out of sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    ) + [f"drivers.{d}" for d in DRIVERS] + [f"tests.{w}" for w in WORKERS]
    code = (
        "import importlib, importlib.abc, sys\n"
        f"FORBIDDEN = {FORBIDDEN!r}\n"
        "def forbidden(name):\n"
        "    return name.split('.')[0] in FORBIDDEN\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if forbidden(name):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for m in [m for m in sys.modules if forbidden(m)]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if forbidden(m)]\n"
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
    # the fused saturation's ramp: foeewmcu's only for kflag 1 without LPHYLIN
    cu = c.replace(LPHYLIN=False, RTICECU=c.RTT - 38.0, RTWAT_RTICECU_R=1.0 / 38.0)
    for cc, kflag, want in ((c, 1, (c.RTICE, c.RTWAT_RTICE_R)), (cu, 2, (c.RTICE, c.RTWAT_RTICE_R)),
                            (cu, 1, (cu.RTICECU, cu.RTWAT_RTICECU_R)),
                            (cu.replace(LDRAIN1D=True), 1, (cu.RTICECU, cu.RTWAT_RTICECU_R))):
        got = dict(zip(NL_CONST_NAMES, kernel_constants(cc, 1800.0, torch.float64, kflag)))
        assert (got["sat_tice"], got["sat_twat_r"]) == want


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
    # the NL and TL take every divide mode (f64 divides exactly: the same
    # numbers) and both CUADJ_COMPACT forms; an unknown mode is refused
    exact = nlk.cloudsc2_nl_host(s, dt, c)
    st = {**s, **state_increment(s, 0.01)}
    tl_exact = tlk.cloudsc2_tl_host(st, dt, c)
    for mode in ("faithful", "approx"):
        for fn, x, want_all in ((nlk.cloudsc2_nl_host, s, exact), (tlk.cloudsc2_tl_host, st, tl_exact)):
            got = fn(x, dt, c.replace(FAST_DIV=mode))
            for want, have in zip(want_all, got):
                assert all(torch.equal(have[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="FAST_DIV"):
        nlk.cloudsc2_nl_host(s, dt, c.replace(FAST_DIV="fast"))
    for fn, x, want_all in ((nlk.cloudsc2_nl_host, s, exact), (tlk.cloudsc2_tl_host, st, tl_exact)):
        got = fn(x, dt, c.replace(CUADJ_COMPACT=False))
        for want, have in zip(want_all, got):
            assert sorted(have) == sorted(want) and all(bool(v.isfinite().all()) for v in have.values())


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
    with pytest.raises(ValueError, match="FAST_DIV"):
        tlk.cloudsc2_tl_host(s, dt, c.replace(FAST_DIV="fast"))


def test_dispatch_refuses_other_devices():
    """Dispatch goes by device: a tensor on neither the CPU nor a CUDA
    device has no implementation, and nothing falls back."""
    s, dt, c = _tl_cpu_state()
    meta = {k: v.to("meta") for k, v in s.items()}
    with pytest.raises(ValueError, match="no NL implementation"):
        dispatch.cloudsc2_nl(meta, dt, c)
    with pytest.raises(ValueError, match="no TL implementation"):
        dispatch.cloudsc2_tl(meta, dt, c)
    with pytest.raises(ValueError, match="no AD implementation"):
        dispatch.cloudsc2_ad(meta, dt, c)


def test_ad_cuda_wrapper_raises_on_cpu_tensors_and_without_lphylin():
    """The AD CUDA wrapper launches or raises: CPU tensors are refused
    before anything is built, under LPHYLIN=False as under True (the
    kernels take both), and neither launch count moves."""
    s, dt, c = _tl_cpu_state()
    before = (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches)
    for cc in (c, c.replace(LPHYLIN=False)):
        with pytest.raises(ValueError, match="cuda"):
            adk.cloudsc2_ad_cuda(s, dt, cc)
    assert (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches) == before
    assert adk.forward_constants(c.replace(LPHYLIN=False)) == c


@pytest.mark.parametrize("mode", ["faithful", "approx"])
def test_ad_refuses_fast_div_before_its_forward_launch(mode):
    """The AD takes every divide mode: in float64, which divides exactly,
    the host bodies and the CPU dispatch (the plain AD) under it are
    bitwise their exact forms; the CUDA entry refuses CPU tensors before
    its forward launch, and no count moves; an unknown mode is refused
    before anything runs."""
    from cloudsc2_tpu_torch.physics.tangent_linear import cloudsc2_tl

    s, dt, c = _tl_cpu_state()
    tends, diags = cloudsc2_tl(s, dt, c)
    s.update({"tnd_" + k: v for k, v in tends.items() if k.endswith("_i")})
    s.update({k: v for k, v in diags.items() if k.endswith("_i")})
    cm = c.replace(FAST_DIV=mode)
    before = (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches)
    for fn in (adk.cloudsc2_ad_host, dispatch.cloudsc2_ad):
        for want, got in zip(fn(s, dt, c), fn(s, dt, cm)):
            assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="cuda"):
        adk.cloudsc2_ad_cuda(s, dt, cm)
    with pytest.raises(ValueError, match="FAST_DIV"):
        adk.cloudsc2_ad_host(s, dt, c.replace(FAST_DIV="fast"))
    assert (nlk.cloudsc2_nl_cuda.launches, adk.cloudsc2_ad_cuda.launches) == before


# ---- the port's copies of the JAX package's numpy-only modules

#: every switch combination the tests use: (lphylin, ldrain1d, lregcl, LEVAPLS2)
SWITCHES = list(itertools.product((True, False), (False, True), (True, False), (False, True)))


@pytest.mark.parametrize("lphylin,ldrain1d,lregcl,levapls2", SWITCHES)
def test_make_constants_equals_jax(lphylin, ldrain1d, lregcl, levapls2):
    """The port's make_constants is the JAX package's, field by field, and
    constants_from_mapping of the JAX bundle gives the same constants."""
    from cloudsc2_tpu import params as jp

    mine = make_constants(lphylin=lphylin, ldrain1d=ldrain1d, lregcl=lregcl).replace(LEVAPLS2=levapls2)
    ref = jp.make_constants(lphylin=lphylin, ldrain1d=ldrain1d, lregcl=lregcl).replace(LEVAPLS2=levapls2)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert constants_from_mapping(dataclasses.asdict(ref)) == mine


def test_parameter_groups_equal_jax():
    """The six parameter groups: the same fields and defaults."""
    from cloudsc2_tpu import params as jp
    from cloudsc2_tpu_torch import params as pp

    for name in ("YoethfParams", "YomcstParams", "YrecldpParams", "YrephliParams", "YrnclParams",
                 "YrphncParams"):
        assert dataclasses.asdict(getattr(pp, name)()) == dataclasses.asdict(getattr(jp, name)()), name


def test_constants_from_mapping_round_trips_and_raises():
    c = make_constants(ldrain1d=True).replace(FAST_DIV="approx", LREGCL=False)
    d = dataclasses.asdict(c)
    assert constants_from_mapping(d) == c and isinstance(constants_from_mapping(d), Constants)
    with pytest.raises(ValueError, match="unknown keys \\['RBOGUS'\\]"):
        constants_from_mapping({**d, "RBOGUS": 1.0})
    with pytest.raises(ValueError, match="missing keys \\['RG'\\]"):
        constants_from_mapping({k: v for k, v in d.items() if k != "RG"})


def test_synthesize_input_and_oracle_nonlinear_bitwise_equal_jax():
    """On the seed-0 input: the port's synthesize_input and oracle (with
    oracle_saturation) give the JAX package's arrays bit for bit."""
    from cloudsc2_tpu import iox as jiox
    from cloudsc2_tpu import oracle as joracle
    from cloudsc2_tpu import params as jp
    from cloudsc2_tpu_torch import oracle

    grid, state, dt = iox.synthesize_input(ncols=100, nlev=137, seed=0)
    jgrid, jstate, jdt = jiox.synthesize_input(ncols=100, nlev=137, seed=0)
    assert (grid.ncols, grid.nlev, dt) == (jgrid.ncols, jgrid.nlev, jdt)
    assert state.keys() == jstate.keys()
    for k in jstate:
        np.testing.assert_array_equal(state[k], jstate[k], err_msg=k)
    for mine, ref in (
        (make_constants(), jp.make_constants()),
        (make_constants(ldrain1d=True), jp.make_constants(ldrain1d=True)),
    ):
        s = dict(state, eta=state["ap"][:, 0] / state["aph"][-1, 0])
        s["qsat"] = oracle.oracle_saturation(s["ap"], s["t"], mine)
        np.testing.assert_array_equal(s["qsat"], joracle.oracle_saturation(s["ap"], s["t"], ref))
        got = oracle.oracle_nonlinear(s, dt, mine)
        want = joracle.oracle_nonlinear(s, dt, ref)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_small_copies_equal_jax(capsys):
    """Grid, units, the driver Config, validate and the performance
    summary give what the JAX package's modules give."""
    from cloudsc2_tpu import config as jconfig
    from cloudsc2_tpu import grid as jgrid
    from cloudsc2_tpu import units as junits
    from cloudsc2_tpu.utils import output as joutput
    from cloudsc2_tpu.utils import validation as jvalidation
    from cloudsc2_tpu_torch import config, grid, units
    from cloudsc2_tpu_torch.utils import output, validation

    g, jg = grid.Grid(ncols=7, nlev=5), jgrid.Grid(ncols=7, nlev=5)
    assert (g.nlev_i, g.full_shape, g.iface_shape) == (jg.nlev_i, jg.full_shape, jg.iface_shape)
    for a, b in (("g g^-1", "kg kg^-1"), ("hPa", "Pa"), ("J m^-2 s^-1", "W m^-2"), ("K s^-1", "K h^-1")):
        assert units.convert(3.0, a, b) == junits.convert(3.0, a, b)
    with pytest.raises(units.UnitsError):
        units.convert(1.0, "kg", "K")
    mine = config.Config().with_precision("single").with_num_cols(9).with_num_runs(2)
    ref = jconfig.Config().with_precision("single").with_num_cols(9).with_num_runs(2)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for m, r in ((mine.with_sharded(True), ref.with_sharded(True)),
                 (mine.with_distributed(True), ref.with_distributed(True))):
        assert (m.sharded, m.distributed) == (r.sharded, r.distributed)
    assert mine.with_distributed(True).sharded
    assert mine.dtype == ref.dtype
    assert output.FLOPS_PER_POINT == joutput.FLOPS_PER_POINT
    assert output.performance_stats(100, [1.0, 2.0]) == joutput.performance_stats(100, [1.0, 2.0])
    a = {"x": np.ones(3), "y": np.zeros(2)}
    b = {"x": np.ones(3) * (1 + 1e-6), "y": np.zeros(2), "z": np.ones(1)}
    assert validation.validate(a, b) == jvalidation.validate(a, b) == ["x", "z"]
    out = capsys.readouterr().out
    assert out.count("FAILED") == 2 and out.count("MISSING") == 2
