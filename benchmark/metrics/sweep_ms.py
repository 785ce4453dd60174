"""The host's part of the split sweeps a unit of the cell's work
(``sweep_ms.<unit>``: a query or a step), in ms: the self time of the
program's ``qcmrf.kernels.sweep`` spans (the sweep wrappers, their
coefficients and combines; their plans and blocking reads apart)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, lambda s: _spans.self_ms(
        s, lambda name: name == "qcmrf.kernels.sweep"))
