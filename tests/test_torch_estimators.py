"""Port parity of the shot-based estimators
(``evaluation/estimators.py``) against the JAX package's, on the CPU: the
counts and parts estimators equal on the same inputs, the exact clique
marginals within 1e-5 of JAX's autodiff form, and the circuit estimator
within its shot noise of JAX's exact values."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.evaluation import estimators as jest  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.models.mrf import grid_mrf as jgrid_mrf  # noqa: E402

from qcmrf_tpu_torch.evaluation import estimators  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402


def random_counts(rng, n, width, keys):
    """A counts dict of ``keys`` distinct ``width``-bit keys, some with
    ancilla bits set."""
    ids = rng.choice(1 << width, size=keys, replace=False)
    return {format(int(k), f"0{width}b"): float(rng.randint(1, 500))
            for k in ids}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_and_parts_estimators_equal_jax(seed):
    rng = np.random.RandomState(seed)
    n = 3 + seed
    counts = random_counts(rng, n, n + 4, 40)
    assert (estimators.success_rate_from_counts(counts, n)
            == jest.success_rate_from_counts(counts, n))
    assert (estimators.log_partition_from_counts(counts, n)
            == jest.log_partition_from_counts(counts, n))
    a = rng.randint(0, 4, size=1000) * (rng.rand(1000) < 0.5)
    assert (estimators.log_partition_from_parts(a, n)
            == jest.log_partition_from_parts(a, n))
    assert (estimators.log_partition_from_parts(torch.from_numpy(a), n)
            == jest.log_partition_from_parts(a, n))


def test_empty_acceptance_edge_cases():
    assert estimators.success_rate_from_counts({}, 2) == 0.0
    assert estimators.log_partition_from_counts({"1100": 5}, 2) == \
        float("-inf")
    assert estimators.log_partition_from_parts(np.array([1, 2, 3]), 4) == \
        float("-inf")


MODELS = {
    "chain3": ([[0, 1], [1, 2]], 1, 1.0, 1.0),
    "mixed8": ([[0, 1, 2], [2, 3], [3, 4, 5, 6], [6, 7], [7, 0]], 3, 0.5,
               1.3),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_clique_marginals_exact_equal_jax(name):
    cl, seed, scale, beta = MODELS[name]
    d = sum(1 << len(C) for C in cl)
    theta = (-np.abs(np.random.RandomState(seed).randn(d))
             * scale).astype(np.float32)
    got = estimators.clique_marginals_exact(
        MRF.create(cl, theta=theta, beta=beta, device="cpu"))
    want = np.asarray(jest.clique_marginals_exact(
        JMRF.create(cl, theta=theta, beta=beta)))
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_clique_marginals_exact_n20_equal_jax():
    """The 4 x 5 grid (n = 20, JAX's chunked path): within 1e-5, each
    clique's block summing to 1."""
    rng = np.random.RandomState(2)
    jm = jgrid_mrf(4, 5)
    theta = (-np.abs(rng.randn(jm.dimension)) * 0.1).astype(np.float32)
    jm = jm.with_theta(theta)
    got = estimators.clique_marginals_exact(
        MRF.create(jm.cliques, theta=theta, device="cpu")).numpy()
    np.testing.assert_allclose(got, np.asarray(jest.clique_marginals_exact(
        jm)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.reshape(-1, 4).sum(axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("cliques", [[[0, 1, 2]], [[0, 1, 2, 3]]])
def test_estimate_from_circuit(cliques):
    """JAX's BASELINE config-2 test: 200 000 shots give lnZ within 0.01,
    delta within 0.005 and the marginals within 0.01 of JAX's exact
    values."""
    d = sum(1 << len(C) for C in cliques)
    theta = (-np.abs(np.random.RandomState(0).randn(d)) * 0.25).astype(
        np.float32)
    jm = JMRF.create(cliques, theta=theta)
    lnz, marg, delta = estimators.estimate_from_circuit(
        1, MRF.create(cliques, theta=theta, device="cpu"), 200_000)
    assert abs(lnz - float(jm.log_partition())) <= 0.01
    assert abs(delta - float(jm.success_rate())) <= 0.005
    assert marg.shape == (d,) and marg.dtype == np.float64
    np.testing.assert_allclose(marg, np.asarray(
        jest.clique_marginals_exact(jm)), atol=0.01)


def test_clique_marginals_from_samples_equal_jax():
    rng = np.random.RandomState(4)
    cl = [[0, 1], [1, 2, 3]]
    theta = -np.abs(rng.randn(12)).astype(np.float32)
    x = rng.randint(0, 16, size=300)
    acc = rng.rand(300) < 0.7
    got = estimators.clique_marginals_from_samples(
        MRF.create(cl, theta=theta, device="cpu"), x, acc)
    want = jest.clique_marginals_from_samples(JMRF.create(cl, theta=theta),
                                              x, acc)
    np.testing.assert_array_equal(got.numpy(), want)
