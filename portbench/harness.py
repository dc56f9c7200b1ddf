"""The benchmark's harness: finds a cell's files by name, makes its inputs
from the seed, warms up, runs the measured window, reads the per-layer
metrics from a traced sub-window, checks the sampled outputs against the
plain reference, and prints one JSON line.

Everything that belongs to one cell, configuration, traffic mix, entry or
per-layer metric sits in a file of its own (``cells/``, ``configs/``,
``traffic/``, ``entries/``, ``metrics/``), found by the name in
``BENCHMARK.json``; a new one is a new file.  This module imports neither
the port nor JAX: the entries import the port.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
#: where a run writes (the profiler's trace), inside the checkout
OUT = CHECKOUT / ".portbench"
#: top-level module names no run may have loaded once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudsc2_tpu")
#: seconds of closed-loop steps after the warm-up's first pass, so the card
#: runs at its working clocks when the window opens
SETTLE_S = 0.3
#: about this many seconds of steps make the profiled sub-window of a
#: traced run, between these step counts
PROFILE_S, PROFILE_STEPS = 0.5, (10, 2000)
#: the profiler's categories of device operations in its trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host's span a device-idle gap falls in, by its place in a step
BETWEEN = "between steps: the sync's return, the loop, the entry up to its first launch"
INSIDE = "inside a step: the entry between two of its launches"
#: columns of one block of the reference's step after the window (the f64
#: TL and its vjp at this size fit beside a run's sampled outputs)
REFERENCE_COLUMNS = 65536


def load_json(kind: str, name: str, root: Path = ROOT) -> Dict:
    """``<root>/<kind>/<name>.json``; ``LookupError`` names what is there."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        have = sorted(p.stem for p in (root / kind).glob("*.json"))
        raise LookupError(f"no {kind} file {name!r} ({path}); have {have}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at ``path`` as a module named ``name``."""
    if not path.is_file():
        raise LookupError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_entry(name: str, root: Path = ROOT) -> ModuleType:
    """The entry module ``entries/<name>.py``."""
    return load_module(root / "entries" / f"{name}.py", f"portbench_entry_{name}")


def load_metrics(root: Path = ROOT) -> Dict[str, ModuleType]:
    """Every per-layer metric's reader, ``metrics/<metric name>.py``, by
    metric name."""
    return {p.name[:-3]: load_module(p, "portbench_metric_" + p.name[:-3].replace(".", "_").replace("-", "_"))
            for p in sorted((root / "metrics").glob("*.py"))}


@dataclass
class Cell:
    """One cell: its file, its configuration, its traffic and its entry."""

    name: str
    spec: Dict
    config: Dict
    traffic: Dict
    entry: ModuleType

    @property
    def kind(self) -> str:
        return self.entry.KIND

    @property
    def ncols(self) -> int:
        """Columns a call: the configuration's NGPTOT."""
        return int(self.config["ngptot"])

    @property
    def nlev(self) -> int:
        return int(self.config["nlev"])

    @property
    def precision(self) -> str:
        return self.config["precision"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec["limits"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``cells/<name>.json`` with the files it names; raises
    where a file is missing or its limits are not its entry's numbers."""
    spec = load_json("cells", name, root)
    entry = load_entry(spec["entry"], root)
    cell = Cell(name, spec, load_json("configs", spec["config"], root), load_json("traffic", spec["traffic"], root),
                entry)
    if set(cell.limits) != set(entry.CHECKS):
        raise ValueError(f"cell {name!r} limits {sorted(cell.limits)}, its entry compares {sorted(entry.CHECKS)}")
    return cell


@dataclass
class Run:
    """What a run measured, for the per-layer readers: the cell, each
    step's host seconds (entry to the return of its last launch) and
    synchronized wall seconds in the unprofiled window, and from the
    profiled sub-window its steps, the device's busy seconds (the union of
    its operations), the sub-window's wall seconds and the device
    operations ``(name, start us, duration us)``."""

    cell: Cell
    host_s: List[float]
    wall_s: List[float]
    profiled_steps: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)


class Sampler:
    """A uniform sample of ``k`` of a window's steps, drawn from the seed
    (reservoir sampling): each kept as ``(step, pool slot, outputs)``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def offer(self, i: int, slot: int, outputs: Dict) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, slot, outputs))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, slot, outputs)


def closed_loop(step: Callable, xs: Sequence, sync: Callable, sampler: Sampler, first: int,
                until: Callable[[int, float], bool], slot0: int = 0) -> Tuple[float, float, List[float], List[float]]:
    """Steps ``i`` from ``first`` on, on state ``(slot0 + i) % len(xs)``,
    each synchronized before the next, until ``until(steps done, now)``.
    Returns ``(start, end, host seconds, wall seconds)``."""
    host, wall = [], []
    i, n = first, len(xs)
    start = now = time.perf_counter()
    while not until(i - first, now):
        slot = (slot0 + i) % n
        t0 = time.perf_counter()
        out = step(xs[slot])
        t1 = time.perf_counter()
        sync()
        now = time.perf_counter()
        host.append(t1 - t0)
        wall.append(now - t0)
        sampler.offer(i, slot, out)
        i += 1
    return start, now, host, wall


def load_libraries(loaders: Sequence[Callable[[], object]]) -> None:
    """Run the entry's library loaders side by side (one compiler each on
    a checkout's first run) and raise the first failure."""
    with ThreadPoolExecutor(max(1, len(loaders))) as pool:
        for future in [pool.submit(load) for load in loaders]:
            future.result()


def warm_up(step: Callable, xs: Sequence, sync: Callable, keep: int) -> int:
    """Every pool state through the step, ``keep + 2`` outputs held at
    once (the most a window holds, so the allocator has their storage
    before it opens), then :data:`SETTLE_S` of closed-loop steps.  Returns
    the steps it ran: the window goes on cycling the pool from there, so
    no step meets the state of the step before it."""
    held = len([step(xs[j % len(xs)]) for j in range(max(len(xs), keep + 2))])
    sync()
    end = time.perf_counter() + SETTLE_S
    return held + len(closed_loop(step, xs, sync, Sampler(0, 0), 0, lambda _, now: now >= end, held)[3])


def device_trace(path: Path) -> List[Tuple[str, float, float]]:
    """The device operations of a profiler trace, ``(name, start us,
    duration us)`` in start order."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS), key=lambda op: op[1])


def busy_us(ops: Sequence[Tuple[str, float, float]]) -> float:
    """Microseconds in which at least one operation ran."""
    total, end = 0.0, -math.inf
    for _, start, dur in ops:
        lo, hi = max(start, end), start + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total


def profile(run: Run, step: Callable, xs: Sequence, sync: Callable, sampler: Sampler, first: int, steps: int,
            path: Path, slot0: int) -> None:
    """``steps`` more steps under ``torch.profiler`` with device activity
    only (host activity would inflate the host's share); fills ``run``'s
    profiled fields from the trace written to ``path``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        start, end, _, _ = closed_loop(step, xs, sync, sampler, first, lambda done, _: done >= steps, slot0)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    run.device_ops = device_trace(path)
    run.profiled_steps, run.window_s = steps, end - start
    run.busy_s = busy_us(run.device_ops) * 1e-6


def breakdown(run: Run) -> Dict[str, List]:
    """The traced sub-window's device operations by time (top 10, summed
    by name) and its device-idle gaps by the host's span at the time
    (total and longest gap of each)."""
    by_name: Dict[str, float] = {}
    for name, _, dur in run.device_ops:
        short = name[5:] if name.startswith("void ") else name
        short = short.split("(")[0][:120]
        by_name[short] = by_name.get(short, 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # a step ends with the operation the traced window ends with: a gap
    # after one such is between steps, any other inside a step
    last = run.device_ops[-1][0] if run.device_ops else None
    gaps: Dict[str, List[float]] = {}
    end = -math.inf
    for k, (_, start, dur) in enumerate(run.device_ops):
        if k and start > end:
            gaps.setdefault(BETWEEN if run.device_ops[k - 1][0] == last else INSIDE, []).append((start - end) * 1e-6)
        end = max(end, start + dur)
    idle = []
    for label, values in sorted(gaps.items(), key=lambda kv: -sum(kv[1])):
        idle += [[f"{label} (total of {len(values)})", sum(values)], [f"{label} (longest)", max(values)]]
    return {"device_ops": [list(kv) for kv in ops], "idle_gaps": idle[:10]}


def reference_blocks(cell: Cell, inputs: Dict, precision: str, block: int = REFERENCE_COLUMNS) -> Iterator[
        Tuple[slice, Dict]]:
    """The reference's step on ``inputs`` in blocks of ``block`` columns,
    so that it fits beside what the run still holds: ``(columns, the
    reference's outputs for them)``.  Columns are independent but for
    ``eta``, which the scheme takes from column 0, so each block is run
    with column 0 in front and that column dropped from its outputs."""
    import torch

    for lo in range(0, cell.ncols, block):
        cols = slice(lo, min(lo + block, cell.ncols))
        part = {k: torch.cat([v[..., :1], v[..., cols]], dim=-1) for k, v in inputs.items()}
        want = cell.entry.reference(part, cell.config, precision)
        del part
        yield cols, {k: v[..., 1:] for k, v in want.items()}
        del want


def check(cell: Cell, kept: Sequence, seed: int, device, block: int = REFERENCE_COLUMNS) -> Tuple[
        Dict[str, float], int]:
    """Each compared number's worst reading over the sampled steps
    ``kept`` (``(step, pool slot, outputs)``), and how many samples failed
    a limit.  Each sampled slot's state is made again from the seed, and
    the reference's step run on it in the configuration's precision, in
    blocks of ``block`` columns (:func:`reference_blocks`)."""
    from portbench import compare, generate

    worst = {name: 0.0 for name in cell.entry.CHECKS}
    failed = 0
    for slot in sorted({slot for _, slot, _ in kept}):
        outputs = [got for _, s, got in kept if s == slot]
        tallies = [compare.Tally(cell.entry.CHECKS) for _ in outputs]
        inputs = generate.synthesize(cell.ncols, cell.nlev, seed, slot, device)
        for cols, want in reference_blocks(cell, inputs, cell.precision, block):
            for tally, got in zip(tallies, outputs):
                tally.add({k: v[..., cols] if v.shape[-1:] == (cell.ncols,) else v for k, v in got.items()}, want)
        del inputs
        for found in (t.numbers() for t in tallies):
            failed += not compare.passes(found, cell.limits)
            worst = {k: max(worst[k], found[k]) for k in worst}
    return worst, failed


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_label() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30, check=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"unknown ({err.__class__.__name__})"


def p95(values: Sequence[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    return statistics.quantiles(values, n=20, method="inclusive")[-1] if len(values) > 1 else values[0]


def finite(x: float) -> float:
    """``x`` for the JSON line: a non-finite reading as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, start: float,
        metrics: Optional[Dict[str, ModuleType]] = None) -> Optional[Dict]:
    """One run of ``cell`` on ``device`` (``start``: the process's start on
    the ``perf_counter`` clock).  Returns the result line's object, or
    ``None`` where a forbidden module was loaded (named on stderr)."""
    import torch

    from portbench import generate

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    marks = [("imports", time.perf_counter())]
    if on_card:
        torch.empty(0, device=device)
        sync()
        marks.append(("CUDA init", time.perf_counter()))
        load_libraries(cell.entry.libraries(cell.config))
        marks.append(("kernel libraries", time.perf_counter()))
    xs = [cell.entry.prepare(generate.synthesize(cell.ncols, cell.nlev, seed, j, device), cell.config)
          for j in range(int(cell.traffic["pool"]))]
    sync()
    marks.append(("inputs and the port's set-up", time.perf_counter()))
    step = cell.entry.program(cell.config)
    slot0 = warm_up(step, xs, sync, int(cell.spec["samples"]))
    sampler = Sampler(int(cell.spec["samples"]), seed)
    first = time.perf_counter()
    marks.append(("warm-up", first))
    setup_s = first - start
    since = [start] + [t for _, t in marks]
    print("set-up: " + ", ".join(f"{name} {t - t0:.3f} s" for (name, t), t0 in zip(marks, since)), file=sys.stderr)
    w_start, w_end, host, wall = closed_loop(step, xs, sync, sampler, 0, lambda _, now: now - first >= seconds, slot0)
    steps = len(wall)
    record = Run(cell, host, wall)
    if trace and on_card:
        count = int(min(max(PROFILE_S / statistics.median(wall), PROFILE_STEPS[0]), PROFILE_STEPS[1]))
        profile(record, step, xs, sync, sampler, steps, count, OUT / "traces" / f"{cell.name}.json", slot0)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del xs, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_check = time.perf_counter()
    worst, failed = check(cell, sampler.kept, seed, device)
    print(f"reference check: {time.perf_counter() - t_check:.3f} s, its device peak "
          f"{torch.cuda.max_memory_allocated(device) if on_card else 0} B", file=sys.stderr)
    correct = all(worst[k] <= cell.limits[k] for k in cell.limits)
    if trace:
        readers = load_metrics() if metrics is None else metrics
        values = {name: r.read(record) for name, r in readers.items()}
        out_metrics = {name: {"value": v, "unit": readers[name].UNIT} for name, v in values.items() if v is not None}
    else:
        out_metrics = {
            "cols_per_s": {"value": steps * cell.ncols / (w_end - w_start), "unit": "cols/s"},
            "step_ms_p95": {"value": 1e3 * p95(wall), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell.spec["chips"]), "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": steps + record.profiled_steps, "failed": failed,
            "metrics": out_metrics, "device": dev}
    if trace and record.window_s:
        dev.update(busy_s=record.busy_s, window_s=record.window_s)
        line["breakdown"] = breakdown(record)
    line["card"] = card_label() if on_card else "cpu"
    line["checks"] = {k: {"value": finite(worst[k]), "limit": cell.limits[k]} for k in cell.limits}
    # last: the reference, the metric readers and the card's label have run
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in the run: {loaded}; no result", file=sys.stderr)
        return None
    for k in cell.limits:
        print(f"check {k}: {worst[k]!r} against the limit {cell.limits[k]!r}", file=sys.stderr)
    return line


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True, help="a cell, cells/<name>.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: the per-layer metrics")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, start: Optional[float] = None) -> int:
    """The command: 0 with the result line printed last on stdout; 2
    without a card the cell needs or with a cell that does not load; 3
    where a forbidden module was loaded."""
    args = parse(argv)
    start = time.perf_counter() if start is None else start
    try:
        cell = load_cell(args.workload)
    except (LookupError, ValueError, KeyError) as err:
        print(f"cell {args.workload!r}: {err}", file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell.spec["chips"]):
        print(f"cell {cell.name!r} needs {cell.spec['chips']} CUDA device(s); this machine has {found}: no result",
              file=sys.stderr)
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), start)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0
