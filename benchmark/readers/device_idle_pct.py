"""The share of the profiled sub-window in which no kernel, copy or set
ran on the device (one minus the union of the device's intervals)."""


def read(run):
    p = run.window.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
