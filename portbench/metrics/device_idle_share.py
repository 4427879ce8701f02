"""Percent of the traced sub-window (whole rounds) in which no operation
ran on the device, from the profiler's device intervals."""


def read(reading):
    tr = reading.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
