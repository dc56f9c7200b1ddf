"""``host_ms.tlad``: the mean host milliseconds of a 4D-Var inner
iteration, from its entry to the return of the AD call's last launch,
before the sync, over the TL call and the AD call: the benchmark's own span
around its calls into the port, over the unprofiled window."""
LAYER = "kernel wrappers"
UNIT = "ms"
MOVES = "cols_per_s"


def read(run):
    if run.cell.kind != "tlad" or not run.host_s:
        return None
    return 1e3 * sum(run.host_s) / len(run.host_s)
