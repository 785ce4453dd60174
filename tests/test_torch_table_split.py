"""The log-potential table and the given-lnZ moments on the block-invariant
split (TPU rows 2-3 and 6 on the card: ``logpot_kernel`` and
``lnz_moments_kernel`` with lnZ given), on the CPU through their plain
versions: :func:`kernels.logpot_table_split_reference` and
:func:`kernels.monomial_moments_split_reference`, against the chain's
plain versions, JAX's split ``_split_logpot``, JAX's ``all_log_potentials``
(its per-state kernel, interpreted) and JAX's
``clique_moments_streaming(mrf, lnZ)``.

Tolerances: a table value within ``kernels.split_gap`` (``2 e_b``, ``e_b =
gamma_{N+1} |beta| sum |coef_b|``) of the chain's and of JAX's, each
being within ``e_b`` of the exact sum of the same float32 entries (the two
packages' coefficients are equal bit for bit); the amplitudes within that
gap relative, plus an ulp for the exp; moments within 1e-6 (float32
weights summed in another order)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models import moments as jmoments  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402

from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from qcmrf_tpu_torch.utils import moebius  # noqa: E402


def _ring(n):
    """A ring of 3-, 4- and 5-variable cliques over n variables."""
    cl, v, i = [], 0, 0
    while v < n - 1:
        c = (3, 4, 5)[i % 3]
        cl.append([u % n for u in range(v, v + c)])
        v, i = v + c - 1, i + 1
    return cl


#: name -> cliques (n = 1 + the largest variable); n = 1 and 5 lie below
#: L's 8 lane and warp bits, n = 9 and 10 are one sub-block (n = L), 12
#: and 14 several sub-blocks a block of lse_geometry at L = 10
STRUCTURES = {
    "n1": [[0]],
    "n5": [[0, 1, 2], [2, 3], [3, 4], [4, 0]],
    "n9_crossing": [[0, 1], [1, 2, 3], [3, 4], [4, 5, 6, 7], [7, 8], [0, 8]],
    "K10": [[i, j] for i in range(10) for j in range(i + 1, 10)],
    "ring12": _ring(12),
    "chain14": [[i, i + 1] for i in range(13)] + [[0, 13], [2, 9]],
}


def _models(name, seed=3, scale=0.4, beta=1.0, rows=1):
    """(JAX model, port model, coefficient rows (rows, N)): theta = -|randn|
    * scale from numpy, further rows at 0.5 and -1 times it."""
    cl = STRUCTURES[name]
    n = 1 + max(v for C in cl for v in C)
    d = sum(1 << len(C) for C in cl)
    theta = (-np.abs(np.random.RandomState(seed).randn(d))
             * scale).astype(np.float32)
    jm = JMRF.create(cl, theta=jnp.asarray(theta), beta=beta, n=n)
    m = MRF.create(cl, theta=theta, beta=beta, n=n, device="cpu")
    thetas = torch.stack([m.theta, 0.5 * m.theta, -m.theta])[:rows]
    return jm, m, kernels.coefficient_table(m.cliques, n, thetas)


def _within_gap(a, b, coef, beta):
    gap = kernels.split_gap(coef, beta)
    return bool(((a - b).abs().amax(dim=-1) <= gap).all())


@pytest.mark.parametrize("beta", [1.0, -0.7])
@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_split_table_within_gap_of_the_chain(name, beta):
    """Three coefficient rows: every value of the split's table within
    ``split_gap`` of the chain's, the amplitudes within that gap relative
    (and an ulp), float32 ``(B, 2^n)``."""
    _, m, coef = _models(name, rows=3)
    got = kernels.logpot_table_split_reference(m.cliques, m.n, coef, beta)
    want = kernels.logpot_table_reference(m.cliques, m.n, coef, beta)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _within_gap(got, want, coef, beta)
    amp = kernels.logpot_table_split_reference(m.cliques, m.n, coef, beta,
                                               True)
    amp_want = kernels.logpot_table_reference(m.cliques, m.n, coef, beta,
                                              True)
    rel = float(kernels.split_gap(coef, beta).max()) + 2.0 ** -22
    torch.testing.assert_close(amp, amp_want, rtol=rel, atol=0)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_split_table_at_theta_zero_is_exact(name):
    """theta = 0: every value 0 (and every amplitude 2^(-n/2)), in both
    orders."""
    _, m, coef = _models(name, scale=0.0)
    got = kernels.logpot_table_split_reference(m.cliques, m.n, coef, 1.3)
    assert bool((got == 0).all())
    amp = kernels.logpot_table_split_reference(m.cliques, m.n, coef, 1.3,
                                               True)
    assert bool((amp == np.float32(2.0 ** (-0.5 * m.n))).all())
    assert torch.equal(got, kernels.logpot_table_reference(
        m.cliques, m.n, coef, 1.3))


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_split_table_matches_jax_all_log_potentials(name):
    """Against the JAX package's table (its per-state kernel, interpreted
    on the CPU), from the same float32 coefficients: within
    ``split_gap``."""
    jm, m, coef = _models(name, beta=0.8)
    want = torch.tensor(np.asarray(jkernels.all_log_potentials(jm)))
    got = kernels.logpot_table_split_reference(m.cliques, m.n, coef, 0.8)[0]
    assert _within_gap(got[None], want[None], coef, 0.8)


@pytest.mark.parametrize("name", ["n9_crossing", "K10", "ring12",
                                  "chain14"])
def test_split_table_matches_jax_split_logpot(name):
    """Against JAX's split (``_split_logpot``, the loop kernel's
    evaluator) at the port's L, sub-block by sub-block: within
    ``split_gap``."""
    jm, m, coef = _models(name)
    n = m.n
    L = kernels.split_bits(n)
    inv, vary = jkernels._split_logpot(
        jnp.arange(1 << L, dtype=jnp.int32),
        jkernels._moebius_coefficients(jm), jm.cliques, n, L)
    got = kernels.logpot_table_split_reference(m.cliques, n, coef, 1.0)
    got = got.reshape(1 << (n - L), 1 << L)
    want = torch.stack([torch.from_numpy(np.asarray(
        vary(jnp.int32(h), inv))) for h in range(1 << (n - L))])
    assert _within_gap(got.reshape(1, -1), want.reshape(1, -1), coef, 1.0)


@pytest.mark.parametrize("L", [1, 5, 8, 9, 12])
def test_kernel_stage_order_is_the_transform(L):
    """The kernels' stage orders (warp bits first for the subset sums,
    last for the superset sums) give the same transforms."""
    a = torch.tensor(np.random.RandomState(L).randn(2, 1 << L))
    for superset, plain in ((False, kernels.subset_sum),
                            (True, kernels.superset_sum)):
        stages = kernels._kernel_stages(L, superset)
        assert sorted(stages) == list(range(L))
        torch.testing.assert_close(
            kernels._transform(a, L, stages, superset), plain(a, L),
            rtol=0, atol=1e-12)
    assert kernels._kernel_stages(9, False) == [5, 6, 7, 0, 1, 2, 3, 4, 8]
    assert kernels._kernel_stages(9, True) == [0, 1, 2, 3, 4, 8, 5, 6, 7]


def test_ordered_sums_run_left_to_right():
    """Each run summed from 0 in order, ragged runs padded with exact
    zeros: the kernels' fixed order on any device."""
    v = torch.tensor([[1e8, 1.0, -1e8, 3.0, 0.5]], dtype=torch.float32)
    got = kernels._ordered_sums(v, np.array([0, 3, 4, 5]))
    want = [((0.0 + np.float32(1e8)) + np.float32(1.0)) - np.float32(1e8),
            3.0, 0.5]
    assert got.tolist() == [[float(np.float32(w)) for w in want]]


def _moments_args(m, coef):
    masks = torch.from_numpy(moebius.monomial_masks(m.cliques, m.n))
    lnz = kernels.combine_lse(*kernels.lse_partials_reference(
        m.cliques, m.n, coef, m.beta)).float()
    return m.cliques, m.n, coef, m.beta, lnz, masks


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_split_moments_match_the_chain(name):
    """Three rows: the given-lnZ moments through the split, its weights
    and its superset sums within 1e-6 of the chain's table summed in
    float64; the empty monomial gives 1. Theta at 0.2 keeps |beta theta^T
    phi| below 16, where a float32 ulp is at most 1e-6 (as in
    tests/test_torch_split.py)."""
    _, m, coef = _models(name, scale=0.2, beta=0.9, rows=3)
    args = _moments_args(m, coef)
    got = kernels.monomial_moments_split_reference(*args)
    want = kernels.monomial_moments_reference(*args)
    assert got.dtype == torch.float64 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got[:, 0], torch.ones(3, dtype=got.dtype),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_split_moments_match_jax_clique_moments_streaming(name):
    """The clique marginals from the split's moments at JAX's lnZ against
    JAX's ``clique_moments_streaming(mrf, lnZ)`` (its moments kernel or
    XLA sweep, on the CPU): within 1e-6."""
    jm, m, coef = _models(name)
    lnz = float(jmoments.log_partition_streaming(jm))
    want = np.asarray(jmoments.clique_moments_streaming(jm, lnZ=lnz))
    masks = torch.from_numpy(moebius.monomial_masks(m.cliques, m.n))
    mono = kernels.monomial_moments_split_reference(
        m.cliques, m.n, coef, m.beta, torch.tensor([lnz]), masks)[0]
    got = moebius.masks_from_monomials(mono, m.cliques).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_split_moments_per_block_sums():
    """With ``per_part``, the moment rule's sums start anew every block of
    sub-blocks, and the blocks add up to the whole sweep's sums."""
    _, m, coef = _models("chain14")
    cl, n, _, beta, lnz, masks = _moments_args(m, coef)
    L = 7
    subs = range(1 << (n - L))
    v = kernels.split_log_potentials_reference(kernels.split_plan(cl, n, L),
                                               coef, beta, subs)
    w = torch.exp(v - lnz[:, None, None]).double()
    blocks = kernels.split_moment_sums_reference(w, L, subs, masks, 16)
    whole = kernels.split_moment_sums_reference(w, L, subs, masks)
    assert blocks.shape == (1, len(subs) // 16, masks.numel())
    torch.testing.assert_close(blocks.sum(dim=1), whole, rtol=1e-12,
                               atol=0)


def _wide_cliques(n, seed, draws=700, scale=0.05):
    """Random 4-variable cliques over n variables (hundreds of them),
    theta = -|randn| * scale: |theta^T phi| near 30, where a float32 ulp is
    2e-6."""
    rng = np.random.RandomState(seed)
    cl = sorted({tuple(sorted(rng.choice(n, 4, replace=False).tolist()))
                 for _ in range(draws)})
    theta = -np.abs(np.random.RandomState(seed + 1).randn(16 * len(cl)))
    return MRF.create([list(C) for C in cl], theta=theta * scale, n=n,
                      device="cpu")


@pytest.mark.parametrize("seed", [4, 9])
def test_split_moments_hold_the_float64_chain_on_wide_cliques(seed):
    """The split's sums of the monomial coefficients and of P run in
    float64, so the error of a table value common to a sub-block stays
    below an ulp: at |theta^T phi| near 30 the given-lnZ moments lie within
    1e-6 of the chain's in float64 on the same float32 coefficients, and
    the table's mean error under p within 1e-7 (float32 sums there leave
    about 2e-6 in both)."""
    m = _wide_cliques(16, seed)
    cl, n, beta = m.cliques, m.n, m.beta
    coef = kernels.moebius_coefficients(m)[None]
    exact = kernels.logpot_table_reference(cl, n, coef.double(), beta)
    split = kernels.logpot_table_split_reference(cl, n, coef, beta)
    assert exact.dtype == torch.float64 and float(exact.abs().max()) > 16
    p = torch.softmax(exact, dim=-1)
    assert abs(float((p * (split.double() - exact)).sum())) <= 1e-7
    lnz = torch.logsumexp(split.double(), dim=-1).float()
    masks = torch.from_numpy(moebius.monomial_masks(cl, n))
    got = kernels.monomial_moments_split_reference(cl, n, coef, beta, lnz,
                                                   masks)
    want = kernels.monomial_moments_reference(cl, n, coef.double(), beta,
                                              lnz, masks)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
