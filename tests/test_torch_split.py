"""The block-invariant split of the streaming lnZ sweeps (TPU rows 4 and
7 on the card: ``lse_kernel`` and ``lnz_moments_kernel``), on the CPU
through its plain versions: :func:`kernels.split_plan`,
:func:`kernels.split_log_potentials_reference`, the two transforms and
the superset-sum moment rule, against the log-potential table, brute
force, JAX's ``_split_logpot`` and the fused sweep's plain version; and the
streaming marginals' route through the fused sweep.

Tolerances: the split's values within rtol 1e-6, atol 1e-6 of the table
(float32 sums in another order), within 1e-5 of JAX's split; the moment
rule's sums within 1e-5 relative to max(1, sum)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402

from qcmrf_tpu_torch.models import moments  # noqa: E402
from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from qcmrf_tpu_torch.utils import moebius  # noqa: E402
from test_torch_moments import models  # noqa: E402


def _grid(rows, cols):
    cl = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                cl.append([v, v + 1])
            if r + 1 < rows:
                cl.append([v, v + cols])
    return cl


def _ring(n):
    """A ring of 3-, 4- and 5-variable cliques over n variables."""
    cl, v, i = [], 0, 0
    while v < n - 1:
        c = (3, 4, 5)[i % 3]
        cl.append([u % n for u in range(v, v + c)])
        v, i = v + c - 1, i + 1
    return cl


#: (cliques, n, L or None for split_bits(n)); "crossing": 4- and
#: 5-cliques straddling the cut at L = 5 with two or more low and two or
#: more high slots
CASES = {
    "chain": ([[i, i + 1] for i in range(15)], 16, None),
    "grid4x5": (_grid(4, 5), 20, None),
    "K12": ([[i, j] for i in range(12) for j in range(i + 1, 12)], 12, None),
    "ring345": (_ring(14), 14, None),
    "crossing": ([[3, 4, 5, 6], [2, 4, 6, 8, 9], [0, 9], [1, 5, 7, 8]], 10,
                 5),
    "n_below_L": ([[0, 1], [1, 2, 3], [3, 4], [4, 5, 6], [6, 7, 8]], 9, None),
    "n3": ([[0, 1], [1, 2]], 3, None),
    "n_equals_L": ([[i, i + 1] for i in range(11)] + [[0, 5, 11]], 12, 12),
}


def _coef(cliques, n, rows=1, seed=7, scale=0.4):
    d = sum(1 << len(C) for C in cliques)
    thetas = -np.abs(np.random.RandomState(seed).randn(rows, d)) * scale
    cl = tuple(tuple(C) for C in cliques)
    return cl, kernels.coefficient_table(
        cl, n, torch.tensor(thetas, dtype=torch.float32))


def test_split_bits():
    got = {n: kernels.split_bits(n) for n in (1, 3, 9, 10, 21, 22, 23, 24,
                                              27, 32, 47)}
    assert got == {1: 1, 3: 3, 9: 9, 10: 10, 21: 10, 22: 10, 23: 11,
                   24: 12, 27: 12, 32: 12, 47: 12}
    for n in (10, 23, 24, 40):
        assert kernels.lse_geometry(1 << n)[1] % (1 << kernels.split_bits(
            n)) == 0
    with pytest.raises(ValueError, match="outside"):
        kernels.split_plan(((0, 1),), 2, 3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_plan_covers_each_entry_once(name):
    cliques, n, L = CASES[name]
    cl = tuple(tuple(C) for C in cliques)
    L = L or kernels.split_bits(n)
    plan = kernels.split_plan(cl, n, L)
    cmax = max(len(C) for C in cl)
    want = sorted((k << cmax) | s for k, C in enumerate(cl)
                  for s in range(1 << len(C)))
    assert sorted(plan.coef_index.tolist()) == want
    U = moebius.monomial_layout(cl).m
    assert len(plan.hm) == len(plan.target) == U
    assert np.all(np.diff(plan.target) >= 0)
    assert plan.targets.tolist() == sorted(set(plan.target.tolist()))
    for items, heads, total in ((plan.c_items, plan.c_heads, len(want)),
                                (plan.m_items, plan.m_heads, U)):
        assert items[0] == 0 and items[-1] == total and heads[-1] == len(
            items) - 1
        for g in range(len(heads) - 1):
            size = items[heads[g + 1]] - items[heads[g]]
            longest = max(np.diff(items[heads[g]:heads[g + 1] + 1]))
            assert longest <= int(np.ceil(np.sqrt(size)))
    # every monomial's masks rebuild its id bits
    masks = moebius.monomial_masks(cl, n)
    got = sorted((int(h) << L) | int(t) for h, t in zip(plan.hm,
                                                        plan.target))
    assert got == sorted(masks.tolist())


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_values_match_the_table(name):
    cliques, n, L = CASES[name]
    rows = 3 if name in ("grid4x5", "ring345", "crossing") else 1
    cl, coef = _coef(cliques, n, rows)
    L = L or kernels.split_bits(n)
    plan = kernels.split_plan(cl, n, L)
    got = kernels.split_log_potentials_reference(plan, coef, 1.3,
                                                 range(1 << (n - L)))
    assert got.dtype == torch.float32
    assert got.shape == (rows, 1 << (n - L), 1 << L)
    want = kernels.logpot_table_reference(cl, n, coef, 1.3)
    torch.testing.assert_close(got.reshape(want.shape), want, rtol=1e-6,
                               atol=1e-6)


def test_split_values_past_2_31():
    """A 34-variable chain on sub-blocks whose ids lie past 2^31, the
    last one included, against the chain evaluator at those ids."""
    n = 34
    cl, coef = _coef([[i, i + 1] for i in range(n - 1)], n, seed=3,
                     scale=0.3)
    L = kernels.split_bits(n)
    plan = kernels.split_plan(cl, n, L)
    subs = [1 << (31 - L), (1 << (31 - L)) + 12345, (1 << (n - L)) - 1]
    got = kernels.split_log_potentials_reference(plan, coef, 0.9, subs)
    for i, h in enumerate(subs):
        x = h * (1 << L) + torch.arange(1 << L)
        want = kernels._clique_sum(cl, n, coef, x) * 0.9
        assert int(x[0]) >= 1 << 31
        torch.testing.assert_close(got[:, i], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L", [7, 10])
@pytest.mark.parametrize("name", ["size5", "size34", "K12"])
def test_split_values_match_jax_split_logpot(name, L):
    # theta at 0.2 keeps |beta theta^T phi| below 16, where a float32 ulp
    # is at most 1e-6: both splits sum in their own order
    jm, m = models(name, scale=0.2)
    n = m.n
    offset = jnp.arange(1 << L, dtype=jnp.int32)
    inv, vary = jkernels._split_logpot(
        offset, jkernels._moebius_coefficients(jm), jm.cliques, n, L)
    plan = kernels.split_plan(m.cliques, n, L)
    coef = kernels.moebius_coefficients(m)[None]
    last = (1 << (n - L)) - 1
    subs = sorted({0, 1, last // 2, last})
    got = kernels.split_log_potentials_reference(plan, coef, 1.0, subs)[0]
    for i, h in enumerate(subs):
        want = np.asarray(vary(jnp.int32(h), inv))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("L", [1, 3, 6])
def test_transforms_are_the_subset_and_superset_sums(L):
    a = torch.tensor(np.random.RandomState(L).randn(2, 1 << L))
    x = torch.arange(1 << L)
    sub = ((x[:, None] & x[None, :]) == x[None, :]).double()  # [x, t]: t <= x
    torch.testing.assert_close(kernels.subset_sum(a, L), a @ sub.T,
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(kernels.superset_sum(a, L), a @ sub,
                               rtol=0, atol=1e-12)
    inv = kernels.subset_sum(torch.zeros(1 << L).index_fill_(0, x[-1:], 1.0),
                             L)
    assert float(inv.sum()) == 1.0  # only the full set holds the top state


def _block_subs(p, per_part, L):
    return range(p * (per_part >> L), (p + 1) * (per_part >> L))


@pytest.mark.parametrize("name", ["chain14", "size5", "wide4"])
def test_superset_rule_gives_the_fused_partials(name):
    """Per block of ``lse_geometry``: the weights of its sub-blocks (L = 7,
    so several a block), the superset sums and one test a monomial a
    sub-block give ``lnz_moments_partials_reference``'s ``S_b``, from the
    table's weights and from the split's values."""
    _, m = models(name, scale=0.05 if name == "wide4" else 0.4, beta=0.7)
    cl, n, beta = m.cliques, m.n, m.beta
    coef = kernels.moebius_coefficients(m)[None]
    masks = torch.from_numpy(moebius.monomial_masks(cl, n))
    M, S = kernels.lnz_moments_partials_reference(cl, n, coef, beta, masks)
    parts, per_part = kernels.lse_geometry(1 << n)
    L = 7
    plan = kernels.split_plan(cl, n, L)
    table = kernels.logpot_table_reference(cl, n, coef, beta)
    for p in sorted({0, parts // 2, parts - 1}):
        subs = _block_subs(p, per_part, L)
        want = S[0, p].double()
        tab = table[:, p * per_part:(p + 1) * per_part].reshape(
            1, len(subs), 1 << L).double()
        vals = kernels.split_log_potentials_reference(plan, coef, beta, subs)
        top = float(M[0, p])
        assert abs(float(vals.max()) - top) <= 1e-6 + 1e-6 * abs(top)
        for v in (tab, vals.double()):
            w = torch.exp(v - float(M[0, p]))
            got = kernels.split_moment_sums_reference(w, L, subs, masks)[0]
            assert torch.all((got - want).abs()
                             <= 1e-5 * torch.clamp(want, min=1.0))


def test_lnz_moments_reserve_fits_k27_in_one_launch():
    """K27 (bench.py's wide model): its plan and 379 monomials fit one
    block's shared memory, so a training step is one launch."""
    cl = tuple((i, j) for i in range(27) for j in range(i + 1, 27))
    plan = kernels.split_plan(cl, 27, kernels.split_bits(27))
    assert plan.L == 12 and len(plan.hm) == 379 and len(plan.targets) == 79
    step = kernels.moments_per_launch(len(cl), 2, reserve=(
        kernels.lnz_moments_reserve(cl, 27)))
    assert step >= 379
    need = kernels.split_shared_bytes(plan, 379) + kernels._LNZ_STATIC_BYTES
    assert need <= 227 * 1024


def _count(monkeypatch, *names):
    calls = {k: 0 for k in names}
    for k in names:
        plain = getattr(kernels, k)

        def counted(*args, _k=k, _plain=plain):
            calls[_k] += 1
            return _plain(*args)

        monkeypatch.setattr(kernels, k, counted)
    return calls


@pytest.mark.parametrize("evidence", [None, {0: 1, 3: 0}])
def test_streaming_marginals_take_one_fused_sweep(monkeypatch, evidence):
    """``clique_moments_streaming`` with no lnZ (and the clamped marginals
    through it) makes one fused lnZ + moments sweep, no lse and no
    moments sweep; with lnZ given it makes one moments sweep. The answer
    is the two sweeps' within 1e-6."""
    _, m = models("size34")
    want = (moments.clique_marginals_clamped_streaming(m, evidence)
            if evidence else moments.clique_moments_streaming(
                m, lnZ=kernels.log_partition(m)))
    calls = _count(monkeypatch, "lnz_moments_partials", "lse_partials",
                   "monomial_moments")
    got = (moments.clique_marginals_clamped_streaming(m, evidence)
           if evidence else moments.clique_moments_streaming(m))
    assert calls == {"lnz_moments_partials": 1, "lse_partials": 0,
                     "monomial_moments": 0}
    assert got.dtype == m.theta.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    if evidence is None:
        moments.clique_moments_streaming(m, lnZ=kernels.log_partition(m))
        assert calls == {"lnz_moments_partials": 1, "lse_partials": 1,
                         "monomial_moments": 1}


def test_streaming_marginals_refuse_a_lost_gradient():
    """As before the route changed: a theta that requires grad is refused
    under grad mode (the marginals have no backward) and passes under
    no_grad."""
    _, m = models("K10")
    live = m.with_theta(m.theta.clone().requires_grad_())
    with pytest.raises(ValueError, match="no backward"):
        moments.clique_moments_streaming(live)
    with torch.no_grad():
        got = moments.clique_moments_streaming(live)
    np.testing.assert_allclose(got.numpy(), moments.clique_moments_streaming(
        m).numpy(), rtol=0, atol=0)
