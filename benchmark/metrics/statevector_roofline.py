"""The gate-level path's share of its roofline, in %: the bytes of every
circuit's outcome probabilities written once, at the memory peak, over all
the device time of the window. The count is the function's output alone,
so it reads the same work however many passes make it."""

from benchmark.metrics import _counts


def read(run):
    t = run.trace
    if t is None:
        return None
    device_s = sum(s for _, _, s, _ in t.device_ops)
    nbytes = _counts.outcome_bytes(run.window.work["width"]) \
        * run.window.units
    return _counts.roofline_percent(_counts.bound_seconds(nbytes=nbytes),
                                    device_s)
