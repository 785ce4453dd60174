"""The share of the traced window in which no operation ran on the
device, in %: 100 (1 - the union of the device's operation intervals over
the window)."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s > 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
