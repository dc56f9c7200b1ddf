"""``host_ms.port``: the host milliseconds a step inside the port's
kernel wrappers: the root spans of the entries (``nl``; ``tl`` and ``ad``)
that the wrappers record in the traced sub-window, over its steps
(``portbench/spans.py``).  The inside counterpart of ``host_ms.nl`` /
``host_ms.tlad``, the benchmark's own span around the same calls; the gap
between the two is the caller's host time."""
from portbench import spans

LAYER = "kernel wrappers"
UNIT = "ms"
MOVES = "cols_per_s"


def read(run):
    found = spans.load(run)
    if found is None:
        return None
    return sum(hi - lo for lo, hi in spans.roots(found)) / run.profiled_steps / 1e3
