# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's CSV writers, ``IOConfig`` and the drivers' output flags against
the JAX package.

* For the same arguments the port's writers write files byte for byte
  equal to the JAX writers' (:mod:`cloudsc2_tpu.utils.output`): a fresh
  file, an append, a per-kernel row, a row realigned to an existing header,
  and the ``ValueError`` for a column not in the header.  Both writers are
  given the same day.
* ``IOConfig`` has the JAX fields, defaults and ``with_*`` methods.
* Each port driver, on the CPU with ``--output-csv-file`` and
  ``--output-csv-file-stencils``, writes the JAX header and a
  ``{nl,tl,ad}-torch:cpu`` row; the NL driver's ``--profile-dir`` writes a
  ``torch.profiler`` trace.
"""
import csv
import dataclasses
import json

import pytest
import torch

from cloudsc2_tpu import config as jconfig
from cloudsc2_tpu.utils import output as joutput
from cloudsc2_tpu_torch import config
from cloudsc2_tpu_torch.utils import output

torch.set_num_threads(1)

DAY = "2026-01-02"

PERF = dict(host_name="h1", precision="double", variant="nl-x", num_cols=100, num_threads=1, num_runs=3,
            runtime_mean=1.25, runtime_stddev=0.125, mflops_mean=4321.5, mflops_stddev=1e-3)


def _stencils(labels, **kw):
    args = dict(host_name="h1", precision="single", backend="torch:cpu", num_cols=64, num_threads=1,
                num_runs=2, exec_info={k: 0.5 + i for i, k in enumerate(labels)},
                key_patterns=("cloudsc", "saturation", "increment"))
    args.update(kw)
    return args


#: sequences of writes, each (writer name, keyword arguments)
CASES = {
    "fresh": [("write_performance_to_csv", PERF)],
    "append": [("write_performance_to_csv", PERF),
               ("write_performance_to_csv", dict(PERF, precision="single", runtime_mean=2.0 / 3.0))],
    "stencils": [("write_stencils_performance_to_csv",
                  _stencils(["cloudsc2_nl", "saturation", "run", "eta_levels"]))],
    "realigned": [("write_stencils_performance_to_csv",
                   _stencils(["cloudsc2_tl", "cloudsc2_ad", "state_increment", "saturation"])),
                  ("write_stencils_performance_to_csv", _stencils(["cloudsc2_ad", "saturation"]))],
}


@pytest.fixture
def same_day(monkeypatch):
    """Both writers date their rows with one day, so that a run across
    midnight cannot part them."""
    monkeypatch.setattr(output, "_today", lambda: DAY)
    monkeypatch.setattr(joutput, "_today", lambda: DAY)


@pytest.mark.parametrize("case", list(CASES))
def test_csv_writers_bytewise_equal_jax(case, tmp_path, same_day):
    mine, theirs = tmp_path / "port" / "out.csv", tmp_path / "jax" / "out.csv"
    for name, kwargs in CASES[case]:
        getattr(output, name)(str(mine), **kwargs)
        getattr(joutput, name)(str(theirs), **kwargs)
    assert mine.read_bytes() == theirs.read_bytes()
    rows = list(csv.reader(mine.open()))
    assert len(rows) == 1 + len(CASES[case])
    if case == "realigned":
        assert rows[0][-4:] == ["cloudsc2_ad", "cloudsc2_tl", "saturation", "state_increment"]
        assert rows[2][-3] == "" and rows[2][-1] == ""


def test_csv_column_not_in_header_raises_as_jax(tmp_path, same_day):
    """A label that the existing header lacks raises ``ValueError`` in both,
    and neither file changes."""
    files = {}
    for mod in (output, joutput):
        path = tmp_path / mod.__name__ / "k.csv"
        mod.write_stencils_performance_to_csv(str(path), **_stencils(["cloudsc2_nl"]))
        with pytest.raises(ValueError, match="not in the existing CSV header"):
            mod.write_stencils_performance_to_csv(str(path), **_stencils(["cloudsc2_nl", "saturation"]))
        files[mod] = path.read_bytes()
    assert files[output] == files[joutput]


def test_today_equal_jax():
    assert output._today() == joutput._today()


def test_io_config_equal_jax():
    mine, ref = config.DEFAULT_IO_CONFIG, jconfig.IOConfig()
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    mine = mine.with_output_csv_file("a.csv").with_output_csv_file_stencils("b.csv").with_host_name("n")
    ref = ref.with_output_csv_file("a.csv").with_output_csv_file_stencils("b.csv").with_host_name("n")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert config.DEFAULT_CONFIG.num_threads == jconfig.Config().num_threads


def _jax_headers(tmp_path):
    """The headers the JAX writers write: the performance CSV's, and the
    fixed columns of the per-kernel CSV's."""
    perf, sten = tmp_path / "jax_perf.csv", tmp_path / "jax_sten.csv"
    joutput.write_performance_to_csv(str(perf), **PERF)
    joutput.write_stencils_performance_to_csv(str(sten), **_stencils([]))
    return next(csv.reader(perf.open())), next(csv.reader(sten.open()))


#: each port driver, its arguments for a short CPU run, its variant and the
#: JAX driver's key patterns
DRIVERS = {
    "nl": ("drivers.run_nonlinear_torch", ["--num-cols", "8"],
           ("cloudsc", "saturation", "increment", "perturbed", "eta")),
    "tl": ("drivers.run_taylor_test_torch", ["--num-cols", "2"],
           ("cloudsc", "saturation", "increment", "perturbed")),
    "ad": ("drivers.run_symmetry_test_torch", ["--num-cols", "4"], ("cloudsc", "saturation", "increment")),
}


@pytest.mark.parametrize("kind", list(DRIVERS))
def test_driver_writes_csv_rows(kind, tmp_path, capsys):
    import importlib

    module, argv, patterns = DRIVERS[kind]
    perf, sten = tmp_path / "perf.csv", tmp_path / "stencils.csv"
    rc = importlib.import_module(module).main([
        "--device", "cpu", *argv, "--output-csv-file", str(perf),
        "--output-csv-file-stencils", str(sten), "--host-alias", "node7",
    ])
    assert rc == 0, capsys.readouterr().out
    perf_header, sten_header = _jax_headers(tmp_path)
    rows = list(csv.reader(perf.open()))
    assert rows[0] == perf_header and len(rows) == 2
    row = dict(zip(rows[0], rows[1]))
    assert (row["host"], row["precision"], row["variant"]) == ("node7", "double", f"{kind}-torch:cpu")
    assert (row["num_cols"], row["num_threads"], row["num_runs"]) == (argv[1], "1", "1")
    assert float(row["runtime_mean"]) > 0 and float(row["mflops_mean"]) > 0
    rows = list(csv.reader(sten.open()))
    assert rows[0][:7] == sten_header and len(rows) == 2
    labels = rows[0][7:]
    assert labels and labels == sorted(labels)
    assert all(any(p in k for p in patterns) for k in labels), labels
    assert any(k.startswith("cloudsc2_") for k in labels), labels
    assert rows[1][3] == "torch:cpu" and all(float(v) > 0 for v in rows[1][7:])


def test_nl_driver_profile_dir_writes_trace(tmp_path, capsys):
    from drivers.run_nonlinear_torch import main

    rc = main(["--device", "cpu", "--num-cols", "4", "--profile-dir", str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"Profiler trace written to {tmp_path / 'prof'}" in out
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    # the timed run's operators: the plain NL step's tensor operations
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
