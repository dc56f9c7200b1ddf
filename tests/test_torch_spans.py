# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""The port's spans (``utils/timing.py``; the kernel wrappers'
``nl``, ``tl``, ``ad`` and ``ad_fused`` root spans and their ``check``,
``plan``, ``alloc`` and ``launch`` stages), through the host builds on the
CPU:

- outside a profiler nothing records; inside one each call records one
  root span, its stages nested under it with its call id, in the order
  ``plan``, ``check``, ``alloc``, ``check``, ``launch`` for each launch
  (the fused AD's too), durations not negative and no stage's self time
  above its parent's duration;
- the profiler's flag turns on at entry and off at exit; the buffer's
  bound counts what it drops; a refused call closes what it opened;
- ``timing(label)`` adds to ``Timer`` whether a profiler runs or not, and
  is a span while one runs;
- a span is on the clock of the profiler's trace; the NL driver's
  ``--profile-dir`` trace carries the spans under a process of their own.

On the card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py``: tests/conftest.py imports jax, which that
machine may not have, and this file imports none): over profiled NL and
TL+AD steps, each kernel of the port in the device trace starts after its
``launch`` span begins, and on the NL step within 50 us of its end.
"""
import functools
import json
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudsc2_tpu_torch import iox
from cloudsc2_tpu_torch.kernels import adjoint as adk
from cloudsc2_tpu_torch.kernels import nonlinear as nlk
from cloudsc2_tpu_torch.kernels import tangent_linear as tlk
from cloudsc2_tpu_torch.params import make_constants
from cloudsc2_tpu_torch.physics.diagnostics import eta_levels
from cloudsc2_tpu_torch.physics.saturation import saturation
from cloudsc2_tpu_torch.state import state_from_numpy
from cloudsc2_tpu_torch.utils import timing

NLEV, NCOLS = 137, 8
STAGES = {"check", "plan", "alloc", "launch"}
#: a launch's stages in order: the plan's lookup, then the compiled call's
LAUNCH = ("plan", "check", "alloc", "check", "launch")


@functools.lru_cache(maxsize=None)
def _state_np():
    _, state, dt = iox.synthesize_input(ncols=NCOLS, nlev=NLEV, seed=7, dtype=np.float64)
    rng = np.random.default_rng(7)
    for n in adk.AD_SEEDS + tuple(n + "_i" for n in ("ap", "aph", "t", "q", "qsat", "ql", "qi", "lu", "lude",
                                                    "mfd", "mfu", "supsat", "tnd_cml_t", "tnd_cml_q",
                                                    "tnd_cml_ql", "tnd_cml_qi")):
        rows = NLEV + 1 if n[:4] in ("fpls", "fhps") or n == "aph_i" else NLEV
        state[n] = rng.standard_normal((rows, NCOLS)) * 1e-3
    return state, dt


def _state(device="cpu"):
    state, dt = _state_np()
    s = state_from_numpy(state, torch.device(device), torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=True, c=make_constants())
    return s, dt


CALLS = {
    "nl": lambda s, dt, c: nlk.cloudsc2_nl_host(s, dt, c, fuse_saturation=True),
    "tl": lambda s, dt, c: tlk.cloudsc2_tl_host(s, dt, c, tangent_only=True),
    "ad": lambda s, dt, c: adk.cloudsc2_ad_host(s, dt, c, cotangent_only=True),
    "ad_fused": lambda s, dt, c: adk.cloudsc2_ad_fused_host(s, dt, c),
}


@pytest.fixture(autouse=True)
def _empty_buffer():
    timing.clear()
    yield
    timing.clear()


@pytest.mark.parametrize("root", list(CALLS))
def test_no_span_outside_a_profiler(root):
    s, dt = _state()
    CALLS[root](s, dt, make_constants())
    assert timing.spans() == [] and timing.SPANS.dropped == 0


def _self_us(found, k):
    return (found[k].end_us - found[k].start_us
            - sum(s.end_us - s.start_us for s in found if s.parent == k))


@pytest.mark.parametrize("root", list(CALLS))
def test_a_profiled_call_is_one_root_with_its_stages(root):
    s, dt = _state()
    c = make_constants()
    CALLS[root](s, dt, c)  # builds the plan, so the profiled call finds it
    with profile(activities=[ProfilerActivity.CPU]):
        CALLS[root](s, dt, c)
    found = timing.spans()
    roots = [k for k, sp in enumerate(found) if sp.parent < 0]
    assert [found[k].name for k in roots] == [root]
    top = found[roots[0]]
    assert {sp.name for sp in found} == {root} | STAGES
    assert {sp.call for sp in found} == {top.call}
    launches = 2 if root == "ad" else 1
    assert sum(sp.name == "launch" for sp in found) == launches
    stages = sorted((sp for sp in found if sp.parent >= 0), key=lambda sp: sp.start_us)
    assert tuple(sp.name for sp in stages) == LAUNCH * launches
    for k, sp in enumerate(found):
        assert sp.end_us >= sp.start_us, sp
        if sp.parent >= 0:
            parent = found[sp.parent]
            assert parent.start_us <= sp.start_us and sp.end_us <= parent.end_us, (sp, parent)
            assert 0 <= _self_us(found, k) <= parent.end_us - parent.start_us
            assert parent is top, sp


def test_the_profiler_flag_follows_the_session():
    assert not timing.PROFILER._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.PROFILER._is_profiler_enabled
    assert not timing.PROFILER._is_profiler_enabled


def test_the_bound_counts_what_it_drops():
    buf = timing.SpanBuffer(limit=3)
    outer = buf.open("a")
    inner = buf.open("b")
    buf.close(inner)
    third = buf.open("c")
    assert buf.open("d") is None and buf.open("e") is None
    buf.close(None)
    buf.close(third)
    buf.close(outer)
    assert buf.dropped == 2
    got = buf.spans()
    assert [(sp.name, sp.parent, sp.call) for sp in got] == [("a", -1, 0), ("b", 0, 0), ("c", 0, 0)]
    buf.clear()
    assert buf.spans() == [] and buf.dropped == 0


def test_threads_keep_their_own_parents():
    buf = timing.SpanBuffer()
    outer = buf.open("main")
    worker = threading.Thread(target=lambda: buf.close(buf.open("worker")))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    buf.close(outer)
    got = {sp.name: sp for sp in buf.spans()}
    assert got["worker"].parent == -1 and got["worker"].call != got["main"].call
    assert got["worker"].thread != got["main"].thread


def test_a_refused_call_closes_its_spans():
    s, dt = _state()
    c = make_constants()
    s["t"] = s["t"].float()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(TypeError, match="dtype"):
            CALLS["nl"](s, dt, c)
        good, _ = _state()
        CALLS["nl"](good, dt, c)
    found = timing.spans()
    roots = [sp for sp in found if sp.parent < 0]
    assert [sp.name for sp in roots] == ["nl", "nl"] and roots[0].call != roots[1].call
    assert all(found[sp.parent].name in ("nl", "check") for sp in found if sp.parent >= 0)


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "on"])
def test_timing_adds_to_the_timer(profiled):
    timing.Timer.reset()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.timing("unit"):
                pass
    else:
        with timing.timing("unit"):
            pass
    assert timing.Timer.get_count("unit") == 1 and timing.Timer.get_time("unit", "us") >= 0.0
    assert [sp.name for sp in timing.spans()] == (["unit"] if profiled else [])
    timing.Timer.reset()


def test_spans_are_on_the_trace_clock(tmp_path):
    """The outputs' allocations, ``aten::empty`` ops that the CPU profiler
    records, fall inside the ``alloc`` span once it is put on the trace's
    clock."""
    s, dt = _state()
    c = make_constants()
    CALLS["nl"](s, dt, c)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        CALLS["nl"](s, dt, c)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    alloc = [sp for sp in timing.spans(int(trace.get("baseTimeNanoseconds", 0))) if sp.name == "alloc"]
    assert len(alloc) == 1
    lo, hi = alloc[0].start_us, alloc[0].end_us
    ops = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("name") == "aten::empty"]
    inside = [e for e in ops if lo - 20 <= e["ts"] and e["ts"] + e["dur"] <= hi + 20]
    assert inside, (lo, hi, [(e["name"], e["ts"]) for e in ops][:20])


def test_the_nl_driver_trace_carries_the_spans(tmp_path, capsys):
    from drivers.run_nonlinear_torch import main

    rc = main(["--device", "cpu", "--num-cols", "4", "--num-runs", "2", "--profile-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "spans of the port" in out, out
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    pid = [e["pid"] for e in events if e.get("ph") == "M" and e.get("args", {}).get("name") == timing.TRACE_PROCESS]
    assert len(pid) == 1
    ours = [e for e in events if e.get("ph") == "X" and e.get("pid") == pid[0]]
    assert [e["name"] for e in ours].count("run") == 2
    assert all(e["dur"] >= 0 and e["cat"] == "cloudsc2_tpu_torch" for e in ours)


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _profiled_kernels(step, steps, path):
    """``steps`` synchronized calls of ``step`` under a device-only profiler
    (as the benchmark traces): the port's kernels ``(start, end)`` in start
    order and its spans, both on the trace's clock (us).  One small torch
    operation runs first under the profiler: its first launch sets up the
    device tracing, and kernels launched in the milliseconds that takes can
    be missing from the trace."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    timing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(steps):
            step()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert "baseTimeNanoseconds" in trace
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel" and "level_scan" in e.get("name", ""))
    return kernels, timing.spans(int(trace["baseTimeNanoseconds"]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nl", "tlad"])
def test_launch_spans_line_up_with_the_kernels(card, kind, tmp_path):
    from cloudsc2_tpu_torch import dispatch
    from cloudsc2_tpu_torch.parallel.step import forward_step
    from cloudsc2_tpu_torch.physics.increment import state_increment

    c = make_constants()
    grid, st, dt = iox.synthesize_input(ncols=65536, nlev=NLEV, seed=3, dtype=np.float64)
    s = state_from_numpy(st, card, torch.float32 if kind == "nl" else torch.float64)
    s["eta"] = eta_levels(s["ap"], s["aph"])
    if kind == "nl":
        def step():
            return forward_step(s, dt, c, fuse_saturation=True)
    else:
        s["qsat"] = saturation(s["ap"], s["t"], kflag=1, lphylin=True, c=c)
        s.update(state_increment(s, 0.01, ignore_supsat=True))

        def step():
            tends, diags = dispatch.cloudsc2_tl(s, dt, c, tangent_only=True)
            sa = {**s, **{"tnd_" + k: v for k, v in tends.items()}, **diags}
            return dispatch.cloudsc2_ad(sa, dt, c, cotangent_only=True)

    steps = 20
    kernels, found = _profiled_kernels(step, steps, tmp_path / "trace.json")
    launches = [sp for sp in found if sp.name == "launch"]
    per_step = 1 if kind == "nl" else 3
    assert len(kernels) == len(launches) == per_step * steps, (len(kernels), len(launches))
    for (start, _), sp in zip(kernels, launches):
        assert start >= sp.start_us, (start, sp)
    if kind == "nl":
        gaps = [start - sp.end_us for (start, _), sp in zip(kernels, launches)]
        assert statistics.median(gaps) < 50.0, gaps
