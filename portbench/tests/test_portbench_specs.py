"""The benchmark's files load by name, agree with ``BENCHMARK.json``, and
a cell, a configuration, a traffic mix, an entry or a metric added as a new
file is found with no code edit."""
import json
import shutil
import textwrap
from pathlib import Path

import pytest
import torch

from portbench import harness

REPO = Path(harness.__file__).resolve().parents[1]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_loads_and_matches_its_files(workload):
    cell = harness.load_cell(workload["name"])
    assert cell.spec["config"] == workload["config"] == cell.config["name"]
    assert cell.spec["traffic"] == workload["traffic"]
    assert int(cell.spec["chips"]) == workload["chips"] == 1
    assert cell.ncols > 0 and int(cell.traffic["pool"]) >= 2 and int(cell.spec["samples"]) >= 1
    assert set(cell.limits) == set(cell.entry.CHECKS)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_benchmark_entry(config):
    data = json.loads((REPO / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert data["precision"] in ("float32", "float64") and data["nlev"] == 137
    assert (data["ngptot"], data["nproma"]) == (262144, 128), "the source's GPU runs"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_its_reader(metric):
    reader = harness.load_metrics()[metric["name"]]
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (metric["layer"], metric["unit"], metric["moves"])
    assert callable(reader.read)
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric["workloads"]) <= names


def test_every_file_is_used():
    """Every cell, configuration and traffic file is one BENCHMARK.json
    names, and every metric reader is a per-layer metric of it."""
    root = REPO / "portbench"
    assert {p.stem for p in (root / "cells").glob("*.json")} == {w["name"] for w in BENCH["workloads"]}
    assert {p.stem for p in (root / "configs").glob("*.json")} == {c["name"] for c in BENCH["configs"]}
    assert {p.stem for p in (root / "traffic").glob("*.json")} == {w["traffic"] for w in BENCH["workloads"]}
    assert set(harness.load_metrics()) == {m["name"] for m in BENCH["per_layer"]}


def test_unknown_names_are_refused():
    with pytest.raises(LookupError, match="have"):
        harness.load_cell("no-such-cell")
    with pytest.raises(LookupError):
        harness.load_entry("no_such_entry")


def test_new_files_are_found_without_a_code_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell, an entry and a metric as files alone; the harness finds each by name and runs the new
    cell (on the CPU, at 8 columns) with the new metric's reader."""
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "pool2.json").write_text(json.dumps({"pool": 2, "loop": "closed"}))
    config = json.loads((root / "configs" / "nl-f32-l137.json").read_text())
    (root / "configs" / "nl-f32-c8.json").write_text(json.dumps(dict(config, name="nl-f32-c8", ngptot=8)))
    (root / "entries" / "nl_again.py").write_text((root / "entries" / "nl_fused.py").read_text())
    (root / "cells" / "nl-f32-c8.json").write_text(json.dumps({
        "config": "nl-f32-c8", "traffic": "pool2", "entry": "nl_again", "chips": 1, "samples": 2,
        "limits": {"nl_err": 1e-3}}))
    (root / "metrics" / "steps_seen.py").write_text(textwrap.dedent('''
        LAYER = "step"
        UNIT = "steps"
        MOVES = "cols_per_s"


        def read(run):
            return float(len(run.wall_s))
        '''))
    cell = harness.load_cell("nl-f32-c8", root)
    assert cell.ncols == 8 and cell.entry.KIND == "nl"
    readers = harness.load_metrics(root)
    assert "steps_seen" in readers
    line = harness.run(cell, 5, 0.2, True, torch.device("cpu"), 0.0, metrics=readers)
    assert line["correct"] and line["metrics"]["steps_seen"]["value"] >= 1
