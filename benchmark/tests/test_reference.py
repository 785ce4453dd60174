"""The plain reference against exact enumeration at small sizes."""

import itertools
import math

import numpy as np
import pytest
import torch

from benchmark.reference import pairwise_mrf as ref


def model(n, seed, unary=False):
    rng = np.random.default_rng(seed)
    cl = [(i, j) for i in range(n) for j in range(i + 1, n)
          if rng.random() < 0.7]
    if unary:
        cl += [(v,) for v in range(0, n, 2)]
    d = sum(1 << len(C) for C in cl)
    theta = -np.abs(rng.normal(size=d)) * 0.7
    return cl, theta


def brute(cl, theta, n, beta):
    """beta theta^T phi(x) of every state by indexing theta clique by
    clique (variable 0 the most significant bit)."""
    out = np.zeros(1 << n)
    for x in range(1 << n):
        bits = [(x >> (n - 1 - v)) & 1 for v in range(n)]
        off, s = 0, 0.0
        for C in cl:
            y = 0
            for v in C:
                y = 2 * y + bits[v]
            s += theta[off + y]
            off += 1 << len(C)
        out[x] = beta * s
    return out


@pytest.mark.parametrize("unary", [False, True])
def test_table_lnz_and_postselected(unary):
    n, beta = 7, 0.8
    cl, theta = model(n, 3, unary)
    m = ref.PairwiseMRF(cl, torch.tensor(theta), n, beta)
    want = brute(cl, theta, n, beta)
    table = m.table()
    assert np.allclose(table.numpy(), want, atol=1e-12)
    q, delta = m.postselected(table)
    assert math.isclose(delta, np.exp(want).sum() / 2 ** n, rel_tol=1e-12)
    assert np.allclose(q.numpy(), np.exp(want) / 2 ** n, atol=1e-15)


def test_conditionals_marginals_and_map():
    n, beta = 6, 1.0
    cl, theta = model(n, 5, unary=True)
    m = ref.PairwiseMRF(cl, torch.tensor(theta), n, beta)
    want = brute(cl, theta, n, beta)
    table = m.table()
    evidence = {1: 1, 4: 0}
    ok = [x for x in range(1 << n)
          if all((x >> (n - 1 - v)) & 1 == b for v, b in evidence.items())]
    _, sub = m.condition(table, evidence)
    assert math.isclose(float(sub.logsumexp(0)),
                        math.log(np.exp(want[ok]).sum()), rel_tol=1e-12)
    p = np.exp(want[ok]) / np.exp(want[ok]).sum()
    mu = m.conditional_marginals(table, evidence).numpy()
    off = 0
    for C in cl:
        for y in range(1 << len(C)):
            hit = [all((x >> (n - 1 - v)) & 1 == (y >> (len(C) - 1 - i)) & 1
                       for i, v in enumerate(C)) for x in ok]
            assert math.isclose(mu[off + y], p[hit].sum(), abs_tol=1e-12)
        off += 1 << len(C)
    sid, val = m.map_state(table, evidence)
    assert sid == ok[int(np.argmax(want[ok]))]
    assert math.isclose(val, want[sid], abs_tol=1e-12)


def test_train_reference_first_gradient_is_autograds():
    n, beta = 5, 1.0
    cl, theta0 = model(n, 9)
    data = torch.tensor([3, 7, 8, 21, 30, 31, 0, 12, 19, 25])
    out = ref.train_reference(cl, n, beta, torch.tensor(theta0), data, 2,
                              0.05)
    raw = out["raw0"].clone().requires_grad_()
    logp = torch.tensor(0.0, dtype=torch.float64)
    theta = -torch.nn.functional.softplus(raw)
    table = torch.zeros(1 << n, dtype=torch.float64)
    for x in range(1 << n):
        off, s = 0, torch.tensor(0.0, dtype=torch.float64)
        for C in cl:
            y = sum(((x >> (n - 1 - v)) & 1) << (len(C) - 1 - i)
                    for i, v in enumerate(C))
            s = s + theta[off + y]
            off += 1 << len(C)
        table[x] = beta * s
    logp = table.logsumexp(0) - table[data].mean()
    logp.backward()
    assert torch.allclose(out["grad1"], raw.grad, atol=1e-12)
    assert math.isclose(out["losses"][0], logp.item(), rel_tol=1e-12)


def test_sample_ids_are_distinct_and_follow_the_law():
    n = 6
    cl, theta = model(n, 2)
    m = ref.PairwiseMRF(cl, torch.tensor(theta), n)
    table = m.table()
    g = torch.Generator().manual_seed(4)
    ids = ref.sample_ids(table - table.logsumexp(0), 40, g)
    assert len(set(ids.tolist())) == 40
    draws = ref.sample_ids(table, 64, torch.Generator().manual_seed(1))
    # the most probable states come first more often than the least
    order = torch.argsort(table, descending=True)
    top = set(order[:16].tolist())
    assert sum(int(x) in top for x in draws[:16]) >= 4


def test_leaf_norm_gap_is_the_worst_leafs_gap_of_norms():
    ref_ = torch.tensor([3.0, 4.0, 0.0, 1e-9, 1.0, 0.0])
    prog = torch.tensor([-3.0, 4.0, 0.0, 0.0, 0.0, 1.1])
    # leaves [3, 4] (norm 5, same), [0, 1e-9] (median-scaled), [1, 0]
    gap = ref.leaf_norm_gap(prog, ref_, [2, 2, 2])
    assert math.isclose(gap, 0.1, rel_tol=1e-6)
    # the third left out: the second's gap over the kept leaves' (lower)
    # median norm, its own
    skip = torch.tensor([False, False, True])
    assert math.isclose(ref.leaf_norm_gap(prog, ref_, [2, 2, 2], skip), 1.0,
                        rel_tol=1e-6)
