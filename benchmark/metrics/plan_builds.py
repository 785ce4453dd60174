"""Split plans built anew (misses of the plan cache) a query
(``plan_builds.query``): the program's ``plan_build`` counter."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, lambda s: s.counts.get("plan_build", 0))
