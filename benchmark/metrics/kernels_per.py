"""Kernels launched a unit of the cell's work in the traced window
(``kernels_per.<unit>``: a circuit, a query, a step): the trace's kernel
count over the units completed."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not run.window.units:
        return None
    return len(t.kernels) / run.window.units
