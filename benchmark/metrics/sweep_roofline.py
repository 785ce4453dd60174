"""The split sweeps' share of their roofline over the served queries, in
%: for each query one sweep of the model its evidence leaves (ln Z's for
``lnz`` and ``prob``, the fused ln Z and moments sweep's for
``marginals``, the MAP sweep's for ``map``), its operations at the
float32 peak, over all the device time of the window."""

from benchmark.metrics import _counts


def query_ops(cliques, n, query) -> int:
    kind, evidence, _ = query
    cl, k = _counts.reduced_pairwise(cliques, n, evidence)
    if kind == "marginals":
        return _counts.split_ops(cl, k, masks=_counts.monomials(cl))
    if kind == "map":
        return _counts.split_ops(cl, k, per_state=3)
    return _counts.split_ops(cl, k)


def read(run):
    t = run.trace
    if t is None:
        return None
    w = run.window.work
    ops = sum(query_ops(w["cliques"], w["n"], q) for q in w["queries"])
    device_s = sum(s for _, _, s, _ in t.device_ops)
    return _counts.roofline_percent(_counts.bound_seconds(ops=ops), device_s)
