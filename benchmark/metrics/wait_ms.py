"""The program's blocking device-to-host reads (``qcmrf.wait`` spans) a
unit of the cell's work (``wait_ms.<unit>``), in ms."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, _spans.wait_ms)
