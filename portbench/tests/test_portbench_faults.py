"""Each fault a cell can have, planted under the timed path, turns
``correct`` false; the sound path keeps it true.  The run is driven on the
CPU past the harness's look for a card: the port's plain versions are the
timed path there."""
import pytest
import torch

from portbench import generate, harness
from portbench.tests.conftest import small

CELLS = {"nl-f32-c262144": dict(columns=16), "tlad-f64-c262144": dict(columns=4, pool=2, samples=2)}


def _stale(step):
    """The outputs of the step before, one call behind."""
    last = []

    def broken(x):
        out = step(x)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return broken


def _zeros(step):
    """A step that writes nothing: every output left zero."""
    return lambda x: {k: torch.zeros_like(v) for k, v in step(x).items()}


def _half(step):
    """Half of the columns left out: the second half of every output zero."""
    def broken(x):
        out = step(x)
        for v in out.values():
            v[..., v.shape[-1] // 2:] = 0
        return out
    return broken


def _truncated(step):
    """Half of the columns left out: every output cut to its first half."""
    return lambda x: {k: v[..., :v.shape[-1] // 2] for k, v in step(x).items()}


def _altered(step):
    """One answer altered where it is produced: the largest value of the
    first output off by 1e-2 of itself."""
    def broken(x):
        out = step(x)
        v = next(iter(out.values())).view(-1)
        i = int(v.abs().argmax())
        v[i] = v[i] * (1 + 1e-2)
        return out
    return broken


def _run(name, fault, monkeypatch):
    opts = dict(CELLS[name])
    columns = opts.pop("columns")
    pool = opts.pop("pool", None)
    cell = small(name, columns, **opts)
    if pool:
        cell.traffic["pool"] = pool
    if fault:
        program = cell.entry.program
        monkeypatch.setattr(cell.entry, "program", lambda config: fault(program(config)))
    return harness.run(cell, 2**31 + 11, 0.5, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_path_is_correct(name, monkeypatch):
    line = _run(name, None, monkeypatch)
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0.0 for c in line["checks"].values())


@pytest.mark.parametrize("fault", [_stale, _zeros, _half, _truncated, _altered], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    line = _run(name, fault, monkeypatch)
    assert not line["correct"] and line["failed"] >= 1, line["checks"]


@pytest.mark.parametrize("fault", [None, _half, _altered], ids=["sound", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_in_blocks_reads_as_one_block(name, fault):
    """The check runs the reference in blocks of columns, each with column
    0 (``eta``'s) in front: its numbers are those of one block of all the
    columns, faults included."""
    cell = small(name, 7, samples=1)
    x = cell.entry.prepare(generate.synthesize(cell.ncols, cell.nlev, 5, 0, torch.device("cpu")), cell.config)
    step = cell.entry.program(cell.config)
    kept = [(0, 0, (fault(step) if fault else step)(x))]
    whole = harness.check(cell, kept, 5, torch.device("cpu"), block=cell.ncols)
    assert harness.check(cell, kept, 5, torch.device("cpu"), block=3) == whole
    assert (whole[1] == 0) == (fault is None)
