"""Fused streams refilled from the planner's cache a circuit
(``fuse_hits.circuit``): the program's ``fuse_hit`` counter. A program
whose planner counts neither ``fuse_hit`` nor ``fuse_build`` (one from
before its cache) gives None, and the metric is left out of the line."""

from benchmark.metrics import _spans

COUNTERS = ("fuse_hit", "fuse_build")


def read(run):
    s = _spans.session()
    if s is None or not any(name in s.counts for name in COUNTERS):
        return None
    return _spans.per_unit(run, lambda s: s.counts.get("fuse_hit", 0))
