"""The host's lowering of a circuit to the basis gates ``[cx, id, rz, sx,
x]`` a circuit (``lower_ms.circuit``), in ms: the self time of the
program's ``qcmrf.circuit.lower`` spans. A program that records no such
span (one from before it) gives None, and the metric is left out of the
line."""

from benchmark.metrics import _spans

NAME = "qcmrf.circuit.lower"


def read(run):
    s = _spans.session()
    if s is None or not any(span.name == NAME for span in s.spans):
        return None
    return _spans.per_unit(run, lambda s: _spans.self_ms(
        s, lambda name: name == NAME))
