"""device_idle_share: 1 - (union of the device's kernel and copy
intervals) / the traced window's length, both inside the window, %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
