"""``device_idle.port``: the part of ``device_idle`` that falls while the
port's kernel wrappers run on the host, in percent: 100 x the time inside
a root span of the port (``portbench/spans.py``) in which no operation ran
on the card, over the traced sub-window's wall.  ``device_idle`` less this
is the caller's: the loop, the sync and the entry around the port."""
from portbench import spans

LAYER = "device"
UNIT = "%"
MOVES = "cols_per_s"


def read(run):
    found = spans.load(run)
    if found is None:
        return None
    return 100.0 * spans.idle_us(spans.roots(found), run.device_ops) / (run.window_s * 1e6)
