"""The roofline arithmetic gives the bound column of the port's kernel
table at its shapes."""

import pytest

from benchmark import harness, inputs
from benchmark.metrics import _counts

K27 = [(i, j) for i in range(27) for j in range(i + 1, 27)]


def test_sampler_bound_at_the_n20_grid():
    cl = inputs.cliques(harness.load_json(
        harness.ROOT / "benchmark" / "configs" / "grid20.json"))
    assert len(cl) == 31
    assert _counts.philox_ops(31) == 784
    assert _counts.lookup_ops(cl) == 280
    ms = _counts.bound_seconds(ops=_counts.sampler_ops(cl) * 2 ** 27) * 1e3
    assert round(ms, 3) == 2.131


def test_lse_bound_at_k27():
    assert _counts.monomials(K27) == 379
    assert _counts.split_bits(27) == 12
    ms = _counts.bound_seconds(ops=_counts.split_ops(K27, 27)) * 1e3
    assert round(ms, 4) == 0.0224


def test_pass_bytes_at_width_28():
    ms = _counts.bound_seconds(nbytes=_counts.pass_bytes(28)) * 1e3
    assert round(ms, 3) == 1.282
    assert _counts.outcome_bytes(30) == 4 << 30


@pytest.mark.parametrize("n", [6, 8, 10, 12, 20, 23, 27])
def test_split_counts_equal_the_ports_plan_today(n):
    # the frozen copy agrees with the program's plan at the parent commit
    from qcmrf_tpu_torch.ops import kernels

    cl = tuple((i, j) for i in range(n) for j in range(i + 1, n))
    L = kernels.split_bits(n)
    assert _counts.split_bits(n) == L
    plan = kernels.split_plan(cl, n, L)
    assert _counts.monomials(cl) == len(plan.hm)
    assert sum(1 << len(C) for C in cl) == len(plan.coef_index)


def test_reduced_pairwise_keeps_free_pairs_and_unaries():
    cl, k = _counts.reduced_pairwise(K27, 27, {3: 1, 5: 0})
    assert k == 25
    assert sum(len(C) == 2 for C in cl) == 25 * 24 // 2
    assert sorted(C for C in cl if len(C) == 1) == [(v,) for v in range(25)]
    assert _counts.split_ops(cl, k) > 0
