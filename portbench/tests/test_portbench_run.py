"""``run.py`` refuses to run where it cannot measure the port on a card,
and a run refuses to report once JAX or the JAX package was loaded."""
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import torch

from portbench import harness
from portbench.tests.conftest import small

REPO = Path(harness.__file__).resolve().parents[1]


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "portbench/run.py", "--workload", "nl-f32-c262144", "--seed", str(2**31 + 3),
           "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_fails_without_a_result():
    """With no CUDA device visible the command exits non-zero and prints
    nothing on stdout: it never falls back to the CPU."""
    out = _run(REPO)
    assert out.returncode == 2 and out.stdout == "", out.stderr
    assert "CUDA device" in out.stderr


def test_benchmark_files_alone_fail(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ (no port)
    gives no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_a_loaded_jax_module_refuses_the_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert harness.run(small("nl-f32-c262144"), 1, 0.1, False, torch.device("cpu"), 0.0) is None
    assert "jaxlib.fake" in capsys.readouterr().err


def test_the_port_is_not_mistaken_for_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudsc2_tpu_torchx", types.ModuleType("cloudsc2_tpu_torchx"))
    line = harness.run(small("nl-f32-c262144"), 1, 0.1, False, torch.device("cpu"), 0.0)
    assert line is not None and line["correct"]
    assert list(line)[-1] == "checks" and json.dumps(line)


def _plant(monkeypatch, name):
    """Put a module named ``name`` into ``sys.modules`` (undone after the test)."""
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))


def test_jax_loaded_by_a_metric_reader_refuses_the_result(monkeypatch, capsys):
    """The look for forbidden modules comes after the per-layer readers:
    one that loads JAX leaves the run without a result."""
    reader = types.SimpleNamespace(UNIT="ms", read=lambda run: _plant(monkeypatch, "jax") or 1.0)
    line = harness.run(small("nl-f32-c262144"), 1, 0.1, True, torch.device("cpu"), 0.0, metrics={"late": reader})
    assert line is None and "'jax'" in capsys.readouterr().err


def test_the_jax_package_loaded_by_the_reference_refuses_the_result(monkeypatch, capsys):
    """... and after the check: a reference that loads the JAX package
    leaves the run without a result."""
    cell = small("tlad-f64-c262144", 4, samples=1)
    reference = cell.entry.reference

    def loads_jax_package(*args):
        _plant(monkeypatch, "cloudsc2_tpu.physics")
        return reference(*args)

    monkeypatch.setattr(cell.entry, "reference", loads_jax_package)
    assert harness.run(cell, 1, 0.1, False, torch.device("cpu"), 0.0) is None
    assert "cloudsc2_tpu.physics" in capsys.readouterr().err
