"""Sandwich groups absorbed into the leading write-only pass a circuit
(``fresh_folds.circuit``): the program's ``fresh_fold`` counter, one a
group whose ancillas were still |0> when it ran. A program that counts no
``fresh_fold`` in the session (one from before the fold) gives None, and
the metric is left out of the line."""

from benchmark.metrics import _spans


def read(run):
    s = _spans.session()
    if s is None or "fresh_fold" not in s.counts:
        return None
    return _spans.per_unit(run, lambda s: s.counts["fresh_fold"])
