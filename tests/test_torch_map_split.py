"""The streaming argmax of ``map_kernel`` (TPU row 5 on the card) on the
CPU through its plain versions: the split screens the states, the chain
decides among those within :func:`kernels.map_tolerance` of the running
maximum. :func:`kernels.map_partials_split_reference` must equal
:func:`kernels.map_partials_reference`, the function's plain version,
exactly (values and ids, ties to the earliest id), and the tolerance must
bound the split's distance from the chain on every state. The MAP answers
against the JAX package's on its models."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402

from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from test_torch_moments import models  # noqa: E402
from test_torch_split import _grid, _ring  # noqa: E402

#: (cliques, n): with the kernel's L = split_bits(n), n = 9 and 10 are one
#: block and one sub-block (L = n), n = 12-20 cut at L = 10; the 16-
#: variable "crossing" cliques straddle that cut with two or more variables
#: on each side
CASES = {
    "chain": ([[i, i + 1] for i in range(15)], 16),
    "grid4x5": (_grid(4, 5), 20),
    "K12": ([[i, j] for i in range(12) for j in range(i + 1, 12)], 12),
    "ring345": (_ring(14), 14),
    "crossing": ([[3, 4, 8, 9], [2, 5, 7, 11, 12], [0, 15], [1, 6, 10, 14],
                  [4, 13]], 16),
    "n9": ([[0, 1], [1, 2, 3], [3, 4], [4, 5, 6], [6, 7, 8]], 9),
    "n10": ([[i, i + 1] for i in range(9)] + [[0, 5, 9]], 10),
}


def _coef(cliques, n, rows=1, seed=7, scale=0.4, theta=None):
    d = sum(1 << len(C) for C in cliques)
    if theta is None:
        theta = -np.abs(np.random.RandomState(seed).randn(rows, d)) * scale
    cl = tuple(tuple(C) for C in cliques)
    return cl, kernels.coefficient_table(
        cl, n, torch.tensor(theta, dtype=torch.float32))


def _check_equal(cl, n, coef, beta, L=None):
    parts = kernels.lse_geometry(1 << n)[0]
    cand = torch.zeros((coef.shape[0], parts), dtype=torch.int64)
    v, x = kernels.map_partials_split_reference(cl, n, coef, beta,
                                                candidates=cand, L=L)
    wv, wx = kernels.map_partials_reference(cl, n, coef, beta)
    assert torch.equal(x, wx) and torch.equal(v, wv)
    assert bool((cand >= 1).all())
    return cand


@pytest.mark.parametrize("L", [None, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_argmax_equals_the_chain_argmax(name, L):
    """Three rows of random theta; at L = 4 every block holds several
    sub-blocks, so the running maximum rises inside a block."""
    cliques, n = CASES[name]
    cl, coef = _coef(cliques, n, rows=3)
    cand = _check_equal(cl, n, coef, 1.3, L)
    # generic theta: a few candidates a block, far fewer than the states
    assert int(cand.sum()) < 3 << (n - 2)


@pytest.mark.parametrize("name", ["chain", "K12", "n9"])
def test_split_argmax_at_theta_zero(name):
    """theta = 0: every state ties and is a candidate; the earliest id of
    each block wins."""
    cliques, n = CASES[name]
    d = sum(1 << len(C) for C in cliques)
    cl, coef = _coef(cliques, n, theta=np.zeros((1, d)))
    for L in (None, 3):
        cand = _check_equal(cl, n, coef, 1.0, L)
        assert int(cand.sum()) == 1 << n


@pytest.mark.parametrize("n", [8, 12, 14])
def test_split_argmax_keeps_the_dyadic_tie(n):
    """The tie chain (two alternating states at exactly 0): the earliest
    one wins in every block that holds both, and in the combine."""
    cl = tuple((i, i + 1) for i in range(n - 1))
    cl, coef = _coef(cl, n, theta=np.tile([-0.5, 0.0, 0.0, -0.5],
                                          n - 1)[None])
    for L in (None, 2):
        _check_equal(cl, n, coef, 1.0, L)
    v, x = kernels.combine_map(*kernels.map_partials_split_reference(
        cl, n, coef, 1.0))
    assert int(x[0]) == int("01" * (n // 2), 2) and float(v[0]) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_split_argmax_with_large_cancelling_entries(seed):
    """Entries of +-10^3 that cancel to small values: the chain and the
    split round them differently by far more than their spread, the
    tolerance grows with sum |coef|, and the answer stays exact."""
    cliques, n = CASES["ring345"]
    d = sum(1 << len(C) for C in cliques)
    rng = np.random.RandomState(seed)
    base = 1e3 * rng.choice([-1.0, 1.0], d)
    theta = np.stack([base + 1e-3 * rng.randn(d),
                      -np.abs(base) + 1e-4 * rng.randn(d)])
    cl, coef = _coef(cliques, n, theta=theta)
    _check_equal(cl, n, coef, 0.7)
    _check_equal(cl, n, coef, 0.7, L=3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_map_tolerance_bounds_split_minus_chain(name):
    """Half the tolerance bounds |split - chain| on every state, for every
    row (beta negative too)."""
    cliques, n = CASES[name]
    cl, coef = _coef(cliques, n, rows=3, scale=2.0)
    beta = -1.7
    plan = kernels.split_plan(cl, n, kernels.split_bits(n))
    split = kernels.split_log_potentials_reference(
        plan, coef, beta, range(1 << (n - plan.L))).reshape(3, -1)
    chain = kernels.logpot_table_reference(cl, n, coef, beta)
    tol = kernels.map_tolerance(coef, beta)
    assert bool(((split - chain).abs().amax(dim=-1) <= tol / 2).all())
    assert bool((tol > 0).all())


def test_split_argmax_past_2_31():
    """A 34-variable chain on blocks past 2^31 (int64 ids): the split's
    answer equals the chain's argmax over each block's states."""
    n = 34
    cl, coef = _coef([[i, i + 1] for i in range(n - 1)], n, seed=3)
    parts, per_part = kernels.lse_geometry(1 << n)
    chosen = [parts // 2, parts - 1]
    v, x = kernels.map_partials_split_reference(cl, n, coef, 1.1,
                                                parts=chosen)
    for j, p in enumerate(chosen):
        ids = torch.arange(p * per_part, (p + 1) * per_part)
        lp = kernels._clique_sum(cl, n, coef, ids)[0] * 1.1
        best = lp.max()
        assert float(v[0, j]) == float(best)
        assert int(x[0, j]) == int(ids[lp == best].min())
        assert int(x[0, j]) >= 1 << 31


@pytest.mark.parametrize("name", ["small", "K10", "K12", "chain14", "size34",
                                  "size5", "isolated"])
def test_split_argmax_matches_jax_map(name):
    """The MAP state of the split algorithm, combined over blocks, is the
    JAX package's streaming MAP, its value within 1e-5."""
    jm, m = models(name, scale=0.6)
    want_id, want_val = jkernels.map_state_streaming(jm)
    coef = kernels.moebius_coefficients(m)[None]
    v, x = kernels.combine_map(*kernels.map_partials_split_reference(
        m.cliques, m.n, coef, m.beta))
    assert int(x[0]) == want_id and abs(float(v[0]) - want_val) <= 1e-5
    assert want_id == int(jnp.argmax(jm.all_log_potentials()))


def test_map_partials_counts_candidates_on_the_cpu():
    """``candidates`` makes the CPU wrapper run the split algorithm: the
    same answer, and the counts filled in."""
    cliques, n = CASES["K12"]
    cl, coef = _coef(cliques, n, rows=2)
    cand = torch.zeros((2, kernels.lse_geometry(1 << n)[0]),
                       dtype=torch.int64)
    v, x = kernels.map_partials(cl, n, coef, 1.0, cand)
    wv, wx = kernels.map_partials(cl, n, coef, 1.0)
    assert torch.equal(v, wv) and torch.equal(x, wx)
    assert bool((cand >= 1).all())
