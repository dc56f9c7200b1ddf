"""``wrapper_us.check``: the host microseconds a step of the port's ``check``
stage, the compiled launcher's checks of the state and of the outputs'
overlap with the inputs: the self time of the spans the kernel wrappers
record under that name in the traced sub-window (``portbench/spans.py``),
over its steps."""
from portbench import spans

LAYER = "kernel wrappers"
UNIT = "us"
MOVES = "cols_per_s"


def read(run):
    return spans.stage_us(run, "check")
