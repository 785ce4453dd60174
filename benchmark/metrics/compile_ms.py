"""The host's circuit compilation and op planning a circuit
(``compile_ms.circuit``), in ms: the self time of the program's
``qcmrf.circuit.compile`` and ``qcmrf.planes.fuse`` spans."""

from benchmark.metrics import _spans

NAMES = ("qcmrf.circuit.compile", "qcmrf.planes.fuse")


def read(run):
    return _spans.per_unit(run, lambda s: _spans.self_ms(
        s, lambda name: name in NAMES))
