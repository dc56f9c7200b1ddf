"""``wrapper_us.alloc``: the host microseconds a step of the port's ``alloc``
stage, the outputs' allocation (``_empty``, the TL's ``torch.empty``; the fused
AD's scratch): the self time of the spans the kernel wrappers record under that
name in the traced sub-window (``portbench/spans.py``), over its steps."""
from portbench import spans

LAYER = "kernel wrappers"
UNIT = "us"
MOVES = "cols_per_s"


def read(run):
    return spans.stage_us(run, "alloc")
