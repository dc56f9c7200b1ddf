"""``wrapper_us.launch``: the host microseconds a step of the port's ``launch``
stage, the C entry's call: the library's ctypes call, the current stream's
lookup and the device guard: the self time of the spans the kernel wrappers
record under that name in the traced sub-window (``portbench/spans.py``), over
its steps."""
from portbench import spans

LAYER = "kernel wrappers"
UNIT = "us"
MOVES = "cols_per_s"


def read(run):
    return spans.stage_us(run, "launch")
