"""The host's time in the program a unit of the cell's work
(``host_ms.<unit>``: a call, circuit, query or step), in ms: the
program's outermost spans less its blocking reads (``qcmrf.wait``)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, _spans.host_ms)
