"""The infer CLI's own host code a query (``cli_ms.query``), in ms: the
self time of every ``qcmrf.infer`` span and its stages (parse, load,
model, answer, route, emit)."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, lambda s: _spans.self_ms(
        s, lambda name: name == "qcmrf.infer"
        or name.startswith("qcmrf.infer.")))
