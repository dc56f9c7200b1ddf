#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size:

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

For each of ``--seeds``, the program's sound reading: the cell's pool made
from the seed, each state through the timed step as a run drives it, and
the cell's numbers against the plain reference (:func:`harness.check`, the
run's own check) over as many states as a run samples.  For each of
``--control-seeds``, the control's reading: the reference computed one
precision below the configuration's (:data:`compare.LOWER`) in the
program's place, against the reference in the configuration's precision.
Prints one JSON line a seed, then a summary: each number's largest sound
reading and smallest control reading beside the cell's limit.  Needs the
card, as a run does (the tests call :func:`readings` on the CPU).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import compare, generate, harness  # noqa: E402


def sound(cell, seed, device):
    """The program's readings on the pool of ``seed``: each sampled state
    (the first ``samples`` slots) through the timed step, judged as a run
    judges them."""
    xs = [cell.entry.prepare(generate.synthesize(cell.ncols, cell.nlev, seed, j, device), cell.config)
          for j in range(int(cell.spec["samples"]))]
    step = cell.entry.program(cell.config)
    kept = [(j, j, step(x)) for j, x in enumerate(xs)]
    del xs
    return harness.check(cell, kept, seed, device)[0]


def control(cell, seed, device):
    """The control's readings on the pool of ``seed``: the reference one
    precision below the configuration's, in the program's place, both
    run in the same blocks of columns as a run's check."""
    lower = compare.LOWER[cell.precision]
    worst = {name: 0.0 for name in cell.entry.CHECKS}
    for slot in range(int(cell.spec["samples"])):
        inputs = generate.synthesize(cell.ncols, cell.nlev, seed, slot, device)
        tally = compare.Tally(cell.entry.CHECKS)
        for (_, want), (_, got) in zip(harness.reference_blocks(cell, inputs, cell.precision),
                                       harness.reference_blocks(cell, inputs, lower)):
            tally.add(got, want)
        worst = {k: max(worst[k], v) for k, v in tally.numbers().items()}
        del inputs
    return worst


def readings(cell, seeds, control_seeds, device, out=print):
    """Both kinds of reading; returns ``(largest sound, smallest control)``
    by number."""
    high = {k: 0.0 for k in cell.entry.CHECKS}
    low = {k: float("inf") for k in cell.entry.CHECKS}
    for kind, seed_list, fn in (("sound", seeds, sound), ("control", control_seeds, control)):
        for seed in seed_list:
            t = time.perf_counter()
            found = fn(cell, seed, device)
            out(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "numbers": found,
                            "seconds": time.perf_counter() - t}))
            for k, v in found.items():
                if kind == "sound":
                    high[k] = max(high[k], v)
                else:
                    low[k] = min(low[k], v)
    return high, low


def main(argv):
    import argparse

    import torch

    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    harness.load_libraries(cell.entry.libraries(cell.config))
    high, low = readings(cell, args.seeds, args.control_seeds, device, lambda s: print(s, flush=True))
    print(json.dumps({"cell": cell.name, "card": harness.card_label(),
                      "summary": {k: {"largest_sound": high[k], "smallest_control": low[k],
                                      "limit": cell.limits[k]} for k in cell.limits}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
