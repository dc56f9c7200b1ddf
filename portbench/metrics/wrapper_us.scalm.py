"""``wrapper_us.scalm``: the host microseconds a step of the port's ``scalm``
stage, ``scalm_profile``: ``scalm`` derived from ``eta`` on every call, a few
small device operations: the self time of the spans the kernel wrappers record
under that name in the traced sub-window (``portbench/spans.py``), over its
steps."""
from portbench import spans

LAYER = "kernel wrappers"
UNIT = "us"
MOVES = "cols_per_s"


def read(run):
    return spans.stage_us(run, "scalm")
