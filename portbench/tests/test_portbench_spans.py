"""The readers of the port's spans (``portbench/spans.py``, the
``wrapper_us.*``, ``host_ms.port`` and ``device_idle.port`` metrics) on a
synthetic run: planted spans and device operations give the values worked
by hand, an idle gap half inside a root span counts half; without the
port's timing module, its spans, a profiled sub-window or a trace they
report nothing; the import guard still finds no offence."""
import json
import sys
import types
from typing import NamedTuple

import pytest

from portbench import guard, harness, spans

BASE_NS = 1_790_000_000_123_456_789
NEW = ("wrapper_us.check", "wrapper_us.plan", "wrapper_us.alloc", "wrapper_us.launch", "host_ms.port",
       "device_idle.port")


class Span(NamedTuple):
    name: str
    start_us: float
    end_us: float
    parent: int
    call: int
    thread: int


#: two NL steps, ``(name, start us, end us, parent)`` on the trace's clock
PLANTED = [
    ("nl", 0, 100, -1), ("check", 10, 40, 0), ("plan", 40, 50, 0), ("alloc", 50, 60, 0), ("check", 60, 70, 0),
    ("launch", 70, 90, 0),
    ("nl", 200, 300, -1), ("check", 210, 230, 6), ("plan", 230, 240, 6), ("alloc", 240, 250, 6),
    ("check", 250, 260, 6), ("launch", 260, 290, 6),
]
#: a small op inside the first step's check, the step's kernel, then a gap
#: [180, 220) half inside the second root span, a small op, and the second
#: kernel
OPS = [("small op", 25.0, 10.0), ("kernel", 85.0, 95.0), ("small op", 220.0, 2.0), ("kernel", 295.0, 95.0)]
WANT = {
    "wrapper_us.check": (30 + 10 + 20 + 10) / 2, "wrapper_us.plan": 10.0, "wrapper_us.alloc": 10.0,
    "wrapper_us.launch": (20 + 30) / 2, "host_ms.port": 0.1,
    # idle inside the roots: 100 - 10 - 15 in the first, 100 - 2 - 5 in the second
    "device_idle.port": 100 * (75 + 93) / 400,
}


def _port_timing(planted=PLANTED):
    """A stand-in for the port's timing module: ``spans(origin_ns)`` as the
    port's, the planted spans recorded at ``BASE_NS`` plus their times."""
    def spans_since(origin_ns=0):
        shift = (BASE_NS - origin_ns) / 1e3
        return [Span(n, lo + shift, hi + shift, parent, 0 if k < 6 else 1, 1)
                for k, (n, lo, hi, parent) in enumerate(planted)]

    return types.SimpleNamespace(spans=spans_since)


@pytest.fixture
def run(tmp_path, monkeypatch):
    """A traced run of two steps over 400 us, its trace (holding only the
    base time) under ``tmp_path``, the stand-in loaded as the port's."""
    monkeypatch.setattr(spans, "TRACES", tmp_path)
    (tmp_path / "cell-x.json").write_text(json.dumps({"baseTimeNanoseconds": BASE_NS, "traceEvents": []}))
    monkeypatch.setitem(sys.modules, spans.PORT_TIMING, _port_timing())
    busy = harness.busy_us(OPS)
    return harness.Run(types.SimpleNamespace(name="cell-x", kind="nl"), [], [], profiled_steps=2,
                       busy_s=busy * 1e-6, window_s=400e-6, device_ops=OPS)


def _read(run):
    readers = harness.load_metrics()
    return {name: readers[name].read(run) for name in NEW}


def test_readers_give_the_values_worked_by_hand(run):
    got = _read(run)
    assert got == pytest.approx(WANT, abs=1e-9)
    assert sum(got[n] for n in NEW[:4]) <= 1e3 * got["host_ms.port"]
    assert got["device_idle.port"] <= harness.load_metrics()["device_idle"].read(run)


def test_an_idle_gap_counts_only_where_a_root_span_is_open():
    assert spans.idle_us([(200.0, 300.0)], [("a", 100.0, 80.0), ("b", 220.0, 2.0)]) == pytest.approx(98.0)
    assert spans.idle_us([(0.0, 10.0), (20.0, 30.0)], [("a", 5.0, 20.0)]) == pytest.approx(10.0)
    assert spans.merged([(5.0, 9.0), (0.0, 6.0), (10.0, 11.0)]) == [(0.0, 9.0), (10.0, 11.0)]


def test_a_trace_without_a_base_time_takes_zero(run, tmp_path, monkeypatch):
    (tmp_path / "cell-x.json").write_text(json.dumps({"traceEvents": []}))
    seen = []
    port = _port_timing()
    monkeypatch.setitem(sys.modules, spans.PORT_TIMING,
                        types.SimpleNamespace(spans=lambda origin_ns=0: seen.append(origin_ns) or port.spans(BASE_NS)))
    assert _read(run) == pytest.approx(WANT, abs=1e-9) and set(seen) == {0}


@pytest.mark.parametrize("missing", ["module", "spans", "recorded", "roots", "sub-window", "trace"])
def test_readers_report_nothing_without_what_they_read(run, tmp_path, monkeypatch, missing):
    if missing == "module":
        monkeypatch.delitem(sys.modules, spans.PORT_TIMING)
    elif missing == "spans":
        monkeypatch.setitem(sys.modules, spans.PORT_TIMING, types.SimpleNamespace())
    elif missing == "recorded":
        monkeypatch.setitem(sys.modules, spans.PORT_TIMING, _port_timing([]))
    elif missing == "roots":
        monkeypatch.setitem(sys.modules, spans.PORT_TIMING, _port_timing([("check", 0, 1, -1)]))
    elif missing == "sub-window":
        run.profiled_steps, run.window_s = 0, None
    else:
        (tmp_path / "cell-x.json").unlink()
    assert set(_read(run).values()) == {None}


def test_each_stage_has_its_reader():
    readers = harness.load_metrics()
    assert {f"wrapper_us.{s}" for s in spans.STAGES} | {"host_ms.port", "device_idle.port"} == set(NEW)
    assert all(readers[n].LAYER == ("device" if n == "device_idle.port" else "kernel wrappers") for n in NEW)


def test_the_guard_finds_no_offence():
    assert guard.scan() == []
