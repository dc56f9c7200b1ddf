"""``nl_roofline``: the step's least possible time on the card over the
device time of the step's operations in the traced sub-window, in percent.
The least time is the larger of the step's bytes over the HBM rate and its
operations over the peak rate of its type, from the benchmark's own field
lists and hand counts (``portbench/counts/``, ``portbench/counts.py``),
not from the port's argument lists."""
from portbench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "cols_per_s"


def read(run):
    if run.cell.kind != "nl" or not run.busy_s or not run.profiled_steps:
        return None
    cell = run.cell
    least = counts.least_time_s([counts.load(n) for n in cell.entry.COUNTS], cell.nlev, cell.ncols,
                                cell.precision, counts.evaporation(cell.config["switches"]))
    return 100.0 * least / (run.busy_s / run.profiled_steps)
