"""Reducing a query's evidence (``reduce_ms.query``), in ms: the self
time of the program's ``qcmrf.moments.reduce`` spans (the clamped model
built from the full one; its blocking reads and uploads apart)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, lambda s: _spans.self_ms(
        s, lambda name: name == "qcmrf.moments.reduce"))
