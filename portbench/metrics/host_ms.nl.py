"""``host_ms.nl``: the mean host milliseconds of an NL step, from the
step's entry to the return of its last launch call, before the sync: the
benchmark's own span around its call into the port, over the unprofiled
window (the kernel wrappers' host time: the plan's lookup, checks,
allocation, the launch)."""
LAYER = "kernel wrappers"
UNIT = "ms"
MOVES = "cols_per_s"


def read(run):
    if run.cell.kind != "nl" or not run.host_s:
        return None
    return 1e3 * sum(run.host_s) / len(run.host_s)
