"""The port's own spans, for the per-layer readers of the kernel-wrapper
layer (``metrics/wrapper_us.*.py``, ``metrics/host_ms.port.py``,
``metrics/device_idle.port.py``).

While the traced sub-window's ``torch.profiler`` runs, the port's kernel
wrappers record spans into a buffer in memory
(``cloudsc2_tpu_torch.utils.timing``): a root span for each call into an
entry (:data:`ROOTS`) and under it the stages of the call
(:data:`STAGES`), each with its start, end and parent, on the
``time.time_ns()`` clock.  :func:`load` takes them from the port's module
already loaded in the process (``sys.modules``: no import, so that nothing
of the benchmark but the entries imports the port), calling nothing of it
but ``spans``, and puts them on the clock of the device trace: an event's
``ts`` there is microseconds after the trace's ``baseTimeNanoseconds``.
Where the port records no spans (a checkout from before them, or a run
without a profiled sub-window) the readers report nothing.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from portbench import harness

#: the port's module that records the spans
PORT_TIMING = "cloudsc2_tpu_torch.utils.timing"
#: the root span of each entry into the port's kernel wrappers
ROOTS = ("nl", "tl", "ad", "ad_fused", "ad_reverse")
#: the stages under a root span
STAGES = ("check", "plan", "alloc", "launch")
#: where a traced run writes its device trace, one file a cell
TRACES = harness.OUT / "traces"

Interval = Tuple[float, float]


def trace_base_ns(path: Path) -> Optional[int]:
    """The trace's ``baseTimeNanoseconds`` (0 where the key is absent), or
    ``None`` where the trace cannot be read."""
    try:
        return int(json.loads(path.read_text()).get("baseTimeNanoseconds", 0))
    except (OSError, ValueError, TypeError):
        return None


def load(run) -> Optional[List]:
    """The spans the port recorded in ``run``'s profiled sub-window, their
    times in microseconds on the device trace's clock (the port's
    ``Span``: ``name``, ``start_us``, ``end_us``, ``parent`` the index of
    the enclosing span or -1); ``None`` where the port's timing module is
    not loaded or records no spans, where the run has no profiled
    sub-window or no trace, or where no root span was recorded."""
    if not run.profiled_steps or not run.window_s:
        return None
    read = getattr(sys.modules.get(PORT_TIMING), "spans", None)
    if read is None:
        return None
    base = trace_base_ns(TRACES / f"{run.cell.name}.json")
    if base is None:
        return None
    found = list(read(base))
    return found if any(s.name in ROOTS for s in found) else None


def self_us(found: Sequence, name: str) -> float:
    """The summed self time, in microseconds, of the spans named ``name``:
    each span's duration less those of the spans directly inside it."""
    inner = [0.0] * len(found)
    for s in found:
        if s.parent >= 0:
            inner[s.parent] += s.end_us - s.start_us
    return sum(s.end_us - s.start_us - inner[k] for k, s in enumerate(found) if s.name == name)


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    """``intervals`` as disjoint intervals in order, overlaps joined."""
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def roots(found: Sequence) -> List[Interval]:
    """The root spans' intervals (one span of :data:`ROOTS` inside another
    counts once)."""
    return merged([(s.start_us, s.end_us) for s in found if s.name in ROOTS])


def idle_us(within: Sequence[Interval], ops: Sequence[Tuple[str, float, float]]) -> float:
    """Microseconds of the disjoint intervals ``within`` in which no device
    operation ``(name, start us, duration us)`` ran."""
    busy = merged([(start, start + dur) for _, start, dur in ops])
    total, j = 0.0, 0
    for lo, hi in within:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= lo:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < hi:
            covered += min(hi, busy[k][1]) - max(lo, busy[k][0])
            k += 1
        total += hi - lo - covered
    return total


def stage_us(run, name: str) -> Optional[float]:
    """The self time of the stage ``name`` a step, in microseconds."""
    found = load(run)
    return None if found is None else self_us(found, name) / run.profiled_steps
