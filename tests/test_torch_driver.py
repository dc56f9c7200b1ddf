# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's driver (drivers/run_nonlinear_torch.py) and component layer on
the CPU: golden validation (HOORAY) in both precisions, the refusal of a
CUDA device that is not there, the in-process goldens the GPU smoke test
uses, and the components' unit / shape handling."""
import os

import numpy as np
import pytest
import torch

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.components import Cloudsc2NL, EtaLevels, Saturation
from cloudsc2_tpu_torch.config import default_input_file, default_reference_file
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.units import UnitArray, UnitsError
from drivers import run_nonlinear_torch as drv

torch.set_num_threads(1)


@pytest.mark.parametrize("precision", ["double", "single"])
@pytest.mark.parametrize("ncols", [100, 250])
def test_driver_cpu_hooray(precision, ncols, capsys):
    """The CPU gate of drivers/run_nonlinear.py: double rtol 1e-10 / atol
    1e-16, single rtol 2e-3 / atol 1e-8, against the committed goldens."""
    rc = drv.main(["--device", "cpu", "--precision", precision, "--num-cols", str(ncols)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "HOORAY" in out and "FAILED" not in out


@pytest.mark.parametrize("opts", [
    {},
    {"fuse_saturation": False},
    {"fast_div": "faithful"},
], ids=["fused", "two-stage", "fused-faithful"])
def test_driver_core_cpu_paths_validate(opts, capsys):
    """core() on the CPU, in process, single at 130 columns: the fused
    default and the two-stage path (``--no-fuse-saturation``) print HOORAY
    against the goldens at the driver's single CPU gate (rtol 2e-3 / atol
    1e-8, the JAX driver's rule, for every divide mode); the fused path
    with ``--fast-div faithful``, whose plain version computes interpret
    mode's bfloat16 reciprocal and misses that gate, prints HOORAY when
    given the gate of the accelerator runs (``--rtol 1e-2 --atol 2e-4``).
    The fused step's qsat is left out of the validation."""
    from cloudsc2_tpu_torch.config import Config, TorchConfig

    gate = {"atol": 2e-4, "rtol": 1e-2} if "fast_div" in opts else {}
    rc = drv.core(
        Config(precision="single", num_cols=130), TorchConfig(device="cpu", precision="single"),
        inputs=drv.synthetic_input(130, "single"), reference=drv.synthetic_golden(130, "single"),
        **opts, **gate,
    )
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "HOORAY" in out and "FAILED" not in out and "qsat" not in out
    assert drv.config_tolerances("single", "cpu") == (1e-8, 2e-3)
    assert drv.config_tolerances("single", "cuda") == (2e-4, 1e-2)


def test_driver_fast_div_in_double_runs_exact(capsys):
    """--fast-div with --precision double says that the run is exact, and it
    validates at the double gate."""
    rc = drv.main(["--device", "cpu", "--precision", "double", "--num-cols", "100", "--fast-div", "approx"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "divides exactly, so this run is exact" in out and "HOORAY" in out


def test_driver_cuda_without_card_raises():
    """--device cuda on a machine without CUDA is an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        drv.main(["--device", "cuda", "--num-cols", "8", "--disable-validation"])


def test_driver_detects_wrong_answers(capsys):
    """Validation is live: a golden perturbed by 1e-6 relative fails."""
    from cloudsc2_tpu_torch.config import Config, TorchConfig

    tends, diags = drv.synthetic_golden(100, "double")
    tends = dict(tends, t=tends["t"] * (1 + 1e-6))
    rc = drv.core(Config(num_cols=100), TorchConfig(device="cpu"), reference=(tends, diags))
    assert rc == 1
    assert "Validation FAILED for fields: ['t']" in capsys.readouterr().out


@pytest.mark.parametrize("precision", ["double", "single"])
def test_in_process_golden_equals_files(precision):
    """chip_smoke.py builds the input and the goldens in process (the card's
    machine may lack h5py): they equal the committed files bit for bit."""
    import h5py

    ncols = 250
    dtype = np.float64 if precision == "double" else np.float32
    grid, state, dt, c = drv.synthetic_input(ncols, precision)
    grid_f, state_f, dt_f, params = iox.load_input(default_input_file(), ncols=ncols, dtype=dtype)
    assert grid == grid_f and dt == dt_f
    assert c == make_constants(lphylin=True, ldrain1d=False, **params)
    for k in state_f:
        np.testing.assert_array_equal(state[k], state_f[k], err_msg=k)
        assert state[k].dtype == state_f[k].dtype
    tends, diags = drv.synthetic_golden(ncols, precision)
    with h5py.File(default_reference_file(precision), "r") as f:
        tends_f, diags_f = iox.read_reference(f, ncols=ncols, dtype=dtype)
    for got, want in ((tends, tends_f), (diags, diags_f)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def small():
    grid, state, dt = iox.synthesize_input(ncols=16, nlev=19, seed=2)
    return grid, state, dt, make_constants()


def test_components_strip_units(small):
    """Unit-tagged inputs are converted to the declared units: ap in hPa
    gives the same eta and qsat as ap in Pa; a wrong dimension raises."""
    grid, state, dt, c = small
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    eta = EtaLevels(grid, c)(s)["eta"]
    qsat = Saturation(grid, c)(s)["qsat"]
    hpa = dict(s, ap=UnitArray(s["ap"] / 100.0, "hPa"), aph=UnitArray(s["aph"] / 100.0, "hPa"))
    torch.testing.assert_close(EtaLevels(grid, c)(hpa)["eta"], eta, rtol=1e-15, atol=0)
    torch.testing.assert_close(Saturation(grid, c)(hpa)["qsat"], qsat, rtol=1e-15, atol=0)
    with pytest.raises(UnitsError):
        Saturation(grid, c)(dict(s, t=UnitArray(s["t"], "kg")))


def test_fused_component_declares_qsat_as_a_diagnostic(small):
    """Cloudsc2NL with fuse_saturation takes no qsat and returns it: the
    plain fused form, equal to Saturation + Cloudsc2NL bitwise on the CPU."""
    grid, state, dt, c = small
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s.update(EtaLevels(grid, c)(s))
    nl = Cloudsc2NL(grid, c, fuse_saturation=True, enable_checks=True)
    assert "qsat" not in nl.input_properties and "qsat" in nl.diagnostic_properties
    assert "qsat" in Cloudsc2NL.input_properties and "qsat" not in Cloudsc2NL.diagnostic_properties
    tends, diags = nl(s, dt)
    s.update(Saturation(grid, c)(s))
    want_t, want_d = Cloudsc2NL(grid, c)(s, dt)
    torch.testing.assert_close(diags.pop("qsat"), s["qsat"], rtol=0, atol=0)
    for got, want in ((tends, want_t), (diags, want_d)):
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_components_checks_and_cpu_dispatch(small):
    """enable_checks rejects wrong shapes and mixed dtypes; Cloudsc2NL on
    CPU tensors runs the plain version and gives its outputs."""
    from cloudsc2_tpu_torch.physics.nonlinear import cloudsc2_nl

    grid, state, dt, c = small
    s = state_from_numpy(state, torch.device("cpu"), torch.float64)
    s.update(EtaLevels(grid, c)(s))
    s.update(Saturation(grid, c)(s))
    nl = Cloudsc2NL(grid, c, enable_checks=True)
    assert isinstance(nl, torch.nn.Module) and nl.name == "cloudsc2_nl"
    with pytest.raises(ValueError, match="shape"):
        nl(dict(s, q=s["q"][:, :-1]), dt)
    with pytest.raises(TypeError, match="dtype"):
        nl(dict(s, q=s["q"].float()), dt)
    with pytest.raises(KeyError, match="lude"):
        nl({k: v for k, v in s.items() if k != "lude"}, dt)
    tends, diags = nl(s, dt)
    want_t, want_d = cloudsc2_nl(s, dt, c)
    assert tends.keys() == want_t.keys() and diags.keys() == want_d.keys()
    for k in want_t:
        torch.testing.assert_close(tends[k], want_t[k], rtol=0, atol=0)
    assert diags["fplsl"].shape == (20, 16)


def test_driver_file_paths_exist():
    """The driver's default input and goldens are committed."""
    assert default_input_file() and os.path.exists(default_reference_file("double"))


def test_driver_without_h5py_builds_default_data_in_process():
    """Where h5py is not installed (as on a GPU machine without it), the
    driver builds the default input and goldens in process and still
    validates."""
    import subprocess
    import sys

    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('h5py', 'click'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from drivers import run_nonlinear_torch as drv\n"
        "sys.exit(drv.main(['--device', 'cpu', '--precision', 'single', '--num-cols', '130']))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "built in process" in proc.stdout and "HOORAY" in proc.stdout
