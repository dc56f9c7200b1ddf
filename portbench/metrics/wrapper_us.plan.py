"""``wrapper_us.plan``: the host microseconds a step of the port's ``plan``
stage, the launch plan's lookup (``cached(_nl_plan / _reverse_plan)``, its
key's hashing and any build); for the TL, which keeps no plan, its constant
struct folded and its switches on every call: the self time of the spans the
kernel wrappers record under that name in the traced sub-window
(``portbench/spans.py``), over its steps."""
from portbench import spans

LAYER = "kernel wrappers"
UNIT = "us"
MOVES = "cols_per_s"


def read(run):
    return spans.stage_us(run, "plan")
