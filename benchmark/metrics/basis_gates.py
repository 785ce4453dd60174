"""Basis gates emitted a circuit (``basis_gates.circuit``): the program's
``basis_gate`` counter, which its lowering to ``[cx, id, rz, sx, x]``
raises by the gates each call emits. A program that counts none (one from
before the counter) gives None, and the metric is left out of the line."""

from benchmark.metrics import _spans

COUNTER = "basis_gate"


def read(run):
    s = _spans.session()
    if s is None or COUNTER not in s.counts:
        return None
    return _spans.per_unit(run, lambda s: s.counts[COUNTER])
