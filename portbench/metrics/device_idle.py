"""``device_idle``: the share of the traced sub-window in which no
operation ran on the card, in percent: 100 x (1 - the union of the device
operations' intervals / the sub-window's wall).  The profiler records
device activity only, so host-side tracing does not stretch the window."""
LAYER = "device"
UNIT = "%"
MOVES = "cols_per_s"


def read(run):
    if not run.window_s or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
