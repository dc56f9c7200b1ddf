# Copyright 2026.
# Licensed under the Apache License, Version 2.0.
"""Wall-clock timing: a process-wide :class:`Timer` accumulated by
``timing(label)`` blocks (the surface of the reference drivers' timing,
restated from :mod:`cloudsc2_tpu.utils.timing`), :func:`device_sync`, and
the port's spans.

PyTorch returns from a CUDA call before the device has finished, so a
``timing`` block around device work must end in :func:`device_sync`.

**Spans.**  While a ``torch.profiler.profile`` runs (``PROFILER.
_is_profiler_enabled``, which the profiler sets whatever its activities),
the kernel wrappers and ``timing`` blocks record spans into one bounded
buffer in memory, :data:`SPANS`: a name, a start and an end on the
``time.time_ns()`` clock, which is the clock of the profiler's trace (an
event's ``ts`` in microseconds plus the trace's ``baseTimeNanoseconds``),
the span open on the same thread when it began, and a call id shared by
every span under one outermost span.  Outside a profiler nothing records:
each site in a wrapper costs one test of the flag.  A site reads::

    k = open_span("check") if PROFILER._is_profiler_enabled else None
    ...
    if k: close_span(k)

No span synchronizes the device or reads a tensor.  :func:`spans` hands
out what was recorded, :func:`clear` empties the buffer; spans past its
bound are counted in ``SPANS.dropped``.  :func:`append_spans` adds them
to a profiler's Chrome trace (``drivers/run_nonlinear_torch.py
--profile-dir``); the benchmark's per-layer readers take them through
:func:`spans` (``portbench/spans.py``).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Union

import torch
from torch.autograd import profiler as PROFILER

__all__ = ["Timer", "timing", "device_sync", "PROFILER", "Span", "SpanBuffer", "SPANS", "open_span",
           "next_span", "close_span", "spans", "clear", "append_spans"]

_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6}
#: the most spans :data:`SPANS` keeps between two :func:`clear` calls
SPAN_LIMIT = 1 << 16
#: the Chrome-trace process :func:`append_spans` puts the spans under
TRACE_PROCESS = "cloudsc2_tpu_torch spans"


class Timer:
    """Process-wide accumulating timer keyed by label."""

    _times: Dict[str, float] = {}
    _counts: Dict[str, int] = {}

    @classmethod
    def reset(cls) -> None:
        cls._times = {}
        cls._counts = {}

    @classmethod
    def add(cls, label: str, seconds: float) -> None:
        cls._times[label] = cls._times.get(label, 0.0) + seconds
        cls._counts[label] = cls._counts.get(label, 0) + 1

    @classmethod
    def get_time(cls, label: str, units: str = "ms") -> float:
        return cls._times.get(label, 0.0) * _UNITS[units]

    @classmethod
    def get_count(cls, label: str) -> int:
        return cls._counts.get(label, 0)

    @classmethod
    def labels(cls):
        return tuple(cls._times)


class Span(NamedTuple):
    """One recorded span: ``start_us`` and ``end_us`` in microseconds on the
    profiler's clock less the origin :func:`spans` was given; ``parent``
    the index of the enclosing span in the same list (-1 for none);
    ``call`` the id shared by every span under one outermost span;
    ``thread`` the thread that recorded it."""

    name: str
    start_us: float
    end_us: float
    parent: int
    call: int
    thread: int


class _OpenSpans(threading.local):
    """The spans open on one thread, innermost last."""

    def __init__(self):
        self.stack: List[list] = []
        self.thread = threading.get_ident()


class SpanBuffer:
    """Spans in memory, at most ``limit`` of them; a span past the bound is
    not kept and counts in ``dropped``.  A record is the list ``[name,
    start ns, end ns (0 while open), parent record or None, call id,
    thread]``; :meth:`open` returns it (``None`` for a dropped span)."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self.limit = limit
        self.clear()

    def clear(self) -> None:
        self.records: List[list] = []
        self.dropped = 0
        self._open = _OpenSpans()
        self._calls = itertools.count()

    def open(self, name: str, now: Optional[int] = None) -> Optional[list]:
        """Start a span named ``name`` now (or at ``now``, ns) under the
        span open on this thread."""
        if len(self.records) >= self.limit:
            self.dropped += 1
            return None
        local = self._open
        stack = local.stack
        parent = stack[-1] if stack else None
        record = [name, time.time_ns() if now is None else now, 0, parent,
                  parent[4] if parent else next(self._calls), local.thread]
        self.records.append(record)
        stack.append(record)
        return record

    def close(self, record: Optional[list], now: Optional[int] = None) -> None:
        """End ``record`` now (or at ``now``, ns), and with it any span left
        open inside it (one that an exception passed through)."""
        if record is None:
            return
        t = time.time_ns() if now is None else now
        stack = self._open.stack
        while stack:
            top = stack.pop()
            top[2] = t
            if top is record:
                break

    def next(self, record: Optional[list], name: str) -> Optional[list]:
        """End ``record`` and start the next stage, ``name``, at one stamp."""
        t = time.time_ns()
        self.close(record, t)
        return self.open(name, t)

    def spans(self, origin_ns: int = 0) -> List[Span]:
        """The closed spans in the order they began, their times in
        microseconds after ``origin_ns`` (ns on the ``time.time_ns()``
        clock).  A span whose parent is still open has parent -1."""
        kept = [r for r in list(self.records) if r[2]]
        index = {id(r): i for i, r in enumerate(kept)}
        return [Span(name, (start - origin_ns) / 1e3, (end - origin_ns) / 1e3,
                     -1 if parent is None else index.get(id(parent), -1), call, thread)
                for name, start, end, parent, call, thread in kept]


#: the process's span buffer, which the wrappers and ``timing`` record into
SPANS = SpanBuffer()
open_span = SPANS.open
next_span = SPANS.next
close_span = SPANS.close


def spans(origin_ns: int = 0) -> List[Span]:
    """The spans recorded since the last :func:`clear` (see :class:`Span`)."""
    return SPANS.spans(origin_ns)


def clear() -> None:
    """Empty the span buffer and its ``dropped`` count."""
    SPANS.clear()


def append_spans(path: Union[str, Path]) -> int:
    """Append the recorded spans to the ``torch.profiler`` Chrome trace at
    ``path`` as complete (``X``) events on the trace's own clock (``ts``
    after its ``baseTimeNanoseconds``), under a process of their own named
    :data:`TRACE_PROCESS`, a track for each thread, so that one timeline
    (Perfetto, ``chrome://tracing``) shows each stage above the device
    operations it launched.  Returns how many were appended."""
    path = Path(path)
    trace = json.loads(path.read_text())
    events = trace.setdefault("traceEvents", [])
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    found = spans(int(trace.get("baseTimeNanoseconds", 0)))
    events.append({"ph": "M", "name": "process_name", "pid": pid, "args": {"name": TRACE_PROCESS}})
    events.extend({"ph": "X", "cat": "cloudsc2_tpu_torch", "name": s.name, "pid": pid, "tid": s.thread,
                   "ts": s.start_us, "dur": s.end_us - s.start_us, "args": {"call": s.call, "parent": s.parent}}
                  for s in found)
    path.write_text(json.dumps(trace))
    return len(found)


@contextmanager
def timing(label: str) -> Iterator[None]:
    """Accumulate the wall time of the block under ``label``; while a
    profiler runs, the block is also a span named ``label``."""
    k = open_span(label) if PROFILER._is_profiler_enabled else None
    start = time.perf_counter()
    try:
        yield
    finally:
        Timer.add(label, time.perf_counter() - start)
        if k:
            close_span(k)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def device_sync(tree: Any) -> Any:
    """``torch.cuda.synchronize()`` on every CUDA device holding a tensor of
    ``tree`` (nested dicts / tuples / lists); CPU tensors need nothing.
    Returns ``tree`` unchanged."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
