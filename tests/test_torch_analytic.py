"""Port parity of the closed-form outcome law (``sim/analytic.py``) against
``qcmrf_tpu``, and the statistics of the port's sampler, mirroring
tests/test_sampler_kernel.py. On the CPU the sampler is its plain version,
which draws the same words as the CUDA kernel."""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.sim import analytic as janalytic  # noqa: E402

from qcmrf_tpu_torch.models.mrf import MRF, grid_mrf  # noqa: E402
from qcmrf_tpu_torch.ops import sampler_kernel  # noqa: E402
from qcmrf_tpu_torch.sim import analytic, batch  # noqa: E402


def port(jm) -> MRF:
    return MRF.from_numpy(jm.cliques, np.asarray(jm.theta), float(jm.beta),
                          jm.n, device="cpu")


@functools.lru_cache(maxsize=None)
def suite_models(scale):
    s = jsuite.generate_suite(scale)
    return [JMRF.create(C, theta=t) for j, C in enumerate(s.graphs)
            for t in s.thetas[j]]


@pytest.mark.parametrize("scale", [0.1, 0.25, 0.5])
def test_postselected_probs_all_suite_models(scale):
    for jm in suite_models(scale):
        p, delta = analytic.postselected_probs(port(jm))
        jp, jdelta = janalytic.postselected_probs(jm)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(float(delta), float(jdelta), rtol=1e-5)


def test_joint_outcome_probs_match():
    for jm in suite_models(0.5)[::3]:
        got = analytic.joint_outcome_probs(port(jm)).numpy()
        want = np.asarray(janalytic.joint_outcome_probs(jm))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert abs(got.sum() - 1.0) < 1e-5


def test_keep_probs_and_fast_log_potentials_match():
    rng = np.random.RandomState(8)
    jm = JMRF.create([[0, 1, 2], [2, 3], [4], [1, 4]],
                     theta=-np.abs(rng.randn(18)) * 0.6, beta=1.7)
    m = port(jm)
    x = np.arange(jm.num_states)
    want = np.asarray(janalytic.clique_keep_probs(jm, jnp.asarray(x)))
    for fn in (analytic.clique_keep_probs, analytic.clique_keep_probs_fast):
        np.testing.assert_allclose(fn(m, torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        analytic.log_potentials_fast(m, torch.from_numpy(x)).numpy(),
        np.asarray(janalytic.log_potentials_fast(jm, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    idx, shifts, cmax = analytic._moebius_layout(m.cliques, m.n)
    jidx, jshifts, jcmax = janalytic._moebius_layout(jm.cliques, jm.n)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(shifts, jshifts)
    assert cmax == jcmax


def test_theta_domain_guard():
    m = MRF.create([[0, 1]], theta=[0.1, -0.2, -0.3, -0.4], device="cpu")
    for fn in (analytic.postselected_probs, analytic.joint_outcome_probs):
        with pytest.raises(ValueError):
            fn(m)
    with pytest.raises(ValueError):
        analytic.sample_outcome_parts(0, m, 128)
    with pytest.raises(ValueError):
        batch.batched_sample_outcomes([[0, 1]], [[0.1, 0, 0, 0]], 0, 16,
                                      device="cpu")


def _two_edge_model(seed, scale=0.4):
    rng = np.random.RandomState(seed)
    return MRF.create([[0, 1], [1, 2]], theta=-np.abs(rng.randn(8)) * scale,
                      device="cpu")


def test_sampler_statistics():
    mrf = _two_edge_model(0)
    x, a = analytic.sample_outcome_parts(7, mrf, 1 << 16)
    assert x.dtype == torch.int32 and a.dtype == torch.int32
    x, a = x.numpy(), a.numpy()
    # acceptance ~ Z/2^n
    assert np.isclose((a == 0).mean(), float(mrf.success_rate()), atol=0.02)
    # accepted x ~ Gibbs
    acc = a == 0
    emp = np.bincount(x[acc], minlength=mrf.num_states) / acc.sum()
    np.testing.assert_allclose(emp, mrf.gibbs_probs().numpy(), atol=0.02)
    # unconditional x uniform
    u = np.bincount(x, minlength=mrf.num_states) / len(x)
    np.testing.assert_allclose(u, 1.0 / mrf.num_states, atol=0.01)
    # each ancilla fires with probability 1 - c2_k(x)
    c2 = analytic.clique_keep_probs(mrf, torch.from_numpy(x)).numpy()
    for k in range(mrf.num_cliques):
        assert abs(((a >> k) & 1).mean() - (1 - c2[:, k]).mean()) < 0.01


def test_sampler_deterministic_per_seed_and_stream():
    mrf = MRF.create([[0, 1]], theta=[-0.3] * 4, device="cpu")
    x1, a1 = analytic.sample_outcome_parts(42, mrf, 512)
    x2, a2 = analytic.sample_outcome_parts(42, mrf, 512)
    assert torch.equal(x1, x2) and torch.equal(a1, a2)
    x3, _ = analytic.sample_outcome_parts(43, mrf, 512)
    x4, _ = analytic.sample_outcome_parts(42, mrf, 512, stream=1)
    assert not torch.equal(x1, x3) and not torch.equal(x1, x4)


def test_sampler_seed_streams_disjoint():
    """No shot range of one seed repeats a shot range of the next."""
    mrf = MRF.create([[0, 1]], theta=[-0.3] * 4, device="cpu")
    shots = 1 << 14
    x0, _ = analytic.sample_outcome_parts(0, mrf, shots)
    x1, _ = analytic.sample_outcome_parts(1, mrf, shots)
    half = shots // 2
    assert not torch.equal(x0[half:], x1[:half])
    assert not torch.equal(x0, x1)


def test_accept_flags_match_postselected():
    mrf = _two_edge_model(2)
    _x, acc = analytic.sample_postselected(11, mrf, 1 << 13)
    flags = sampler_kernel.sample_accept_flags(11, mrf, 1 << 13)
    assert acc.dtype == torch.bool and torch.equal(acc, flags)
    x, a = sampler_kernel.sample_outcome_parts(11, mrf, 1 << 13)
    assert torch.equal(x, _x) and torch.equal(a == 0, acc)


@pytest.mark.parametrize("shots", [1 << 14, (1 << 14) - 128, 384, 1000, 1])
def test_accept_count_matches_flags_sum(shots):
    rng = np.random.RandomState(3)
    mrf = grid_mrf(3, 3, device="cpu").with_theta(
        -np.abs(rng.randn(48)).astype(np.float32) * 0.3)
    flags = sampler_kernel.sample_accept_flags(11, mrf, shots)
    cnt = sampler_kernel.sample_accept_count(11, mrf, shots)
    assert flags.shape == (shots,) and cnt.dtype == torch.int64
    assert int(cnt) == int(flags.sum())


def test_mask_bit_31_reads_unsigned():
    """32 cliques: the last ancilla lands on the int32 sign bit."""
    cliques = [[i] for i in range(31)] + [[0]]
    theta = np.full(64, -0.05, np.float32)
    theta[62:] = -3.0  # clique 31 fires ~95% of shots
    mrf = MRF.create(cliques, theta=theta, device="cpu")
    x, a = analytic.sample_outcome_parts(5, mrf, 4096)
    bit31 = (a.numpy().view(np.uint32) >> 31) & 1
    assert 0.9 < bit31.mean() < 0.99
    assert int(x.max()) < (1 << 31)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampler_table_against_the_chain_arithmetic(seed):
    """The sampler reads c2 from the keep-probability table; the JAX
    kernel evaluates it as a Moebius chain, rounded otherwise. On the same
    Philox words: x equal, and the ancilla bits equal except on shots
    whose u lies within 2 ulp of c2. Mixed clique sizes: a smaller
    clique's unused slots read id bit 31, which is 0."""
    rng = np.random.RandomState(seed)
    cliques = [[0, 1, 2], [2, 3], [4], [1, 4], [0, 3, 4, 5]]
    d = sum(1 << len(C) for C in cliques)
    mrf = MRF.create(cliques, theta=-np.abs(rng.randn(d)) * 0.7, beta=1.3,
                     device="cpu")
    shots = 1 << 15
    x, a = sampler_kernel.sample_outcome_parts(seed, mrf, shots, seed)
    wx, uniforms = sampler_kernel.shot_uniforms(seed, mrf.n, len(cliques),
                                                shots, stream0=seed)
    assert torch.equal(x, wx[0].to(torch.int32))
    chain = analytic.clique_keep_probs_fast(mrf, wx[0])
    for k, u in enumerate(uniforms):
        c2 = chain[:, k]
        differ = ((a >> k) & 1).bool() != (u[0] >= c2)
        ulp = torch.nextafter(c2, torch.full_like(c2, 2.0)) - c2
        assert bool(((u[0] - c2).abs() <= 2 * ulp)[differ].all())


def test_sample_outcomes_follow_joint_law():
    rng = np.random.RandomState(4)
    mrf = MRF.create([[0, 1], [1, 2]], theta=-np.abs(rng.randn(8)) * 0.8,
                     device="cpu")
    keys = analytic.sample_outcomes(9, mrf, 1 << 16).numpy()
    x, a = analytic.sample_outcome_parts(9, mrf, 1 << 16)
    np.testing.assert_array_equal(keys, (x + (a << 4)).numpy())
    width = mrf.n + mrf.num_cliques + 1
    emp = np.bincount(keys, minlength=1 << width) / keys.size
    np.testing.assert_allclose(
        emp, analytic.joint_outcome_probs(mrf).numpy(), atol=0.01)


def test_batch_helpers_match_jax():
    from qcmrf_tpu.sim import batch as jbatch

    s = jsuite.generate_suite(0.25)
    C, thetas = s.graphs[2], s.thetas[2]
    np.testing.assert_allclose(
        batch.batched_joint_probs(C, thetas, device="cpu").numpy(),
        np.asarray(jbatch.batched_joint_probs(C, np.asarray(thetas))),
        rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        batch.batched_gibbs_probs(C, thetas, beta=1.5, device="cpu").numpy(),
        np.asarray(jbatch.batched_gibbs_probs(C, np.asarray(thetas), 1.5)),
        rtol=1e-5, atol=1e-8)
    p, lnz = batch.batched_gibbs_log_partition(C, thetas, beta=1.5,
                                               device="cpu")
    np.testing.assert_array_equal(
        p.numpy(),
        batch.batched_gibbs_probs(C, thetas, beta=1.5, device="cpu").numpy())
    want = [float(JMRF.create(C, theta=t, beta=1.5).log_partition())
            for t in thetas]
    np.testing.assert_allclose(lnz.numpy(), want, rtol=1e-6)
    got = batch.run_suite_probs(s, device="cpu")
    ref = jbatch.run_suite_probs(s)
    assert len(got) == len(ref) == 70
    for g, r in zip(got[::9], ref[::9]):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-7)


def test_shot_sampling_helpers():
    from qcmrf_tpu.sim import sampler as jsampler
    from qcmrf_tpu_torch.sim import sampler

    probs = torch.tensor([0.1, 0.0, 0.6, 0.3])
    s = sampler.sample_from_probs(3, probs, 20000)
    assert s.dtype == torch.int32 and torch.equal(
        s, sampler.sample_from_probs(3, probs, 20000))
    h = sampler.histogram(s, 4)
    assert int(h[1]) == 0 and int(h.sum()) == 20000
    np.testing.assert_allclose(h.numpy() / 20000, probs.numpy(), atol=0.015)
    counts = sampler.sample_counts(3, probs, 20000, 5)
    assert counts == sampler.counts_from_samples(s, 5)
    assert counts == jsampler.counts_from_samples(s.numpy(), 5)
    np.testing.assert_array_equal(sampler.counts_to_probs(counts, 5),
                                  jsampler.counts_to_probs(counts, 5))


def test_metrics_match_jax():
    from qcmrf_tpu.evaluation import metrics as jmetrics
    from qcmrf_tpu_torch.evaluation import metrics

    rng = np.random.RandomState(6)
    P = rng.dirichlet(np.ones(16))
    Q = rng.dirichlet(np.ones(16))
    Q[3] = -0.01  # quasi-probability entries are skipped
    for fn in ("fidelity", "kl"):
        want = float(getattr(jmetrics, fn)(P, Q))
        assert abs(float(getattr(metrics, fn)(P, Q)) - want) < 1e-12
        got_t = getattr(metrics, fn)(torch.from_numpy(P), torch.from_numpy(Q))
        assert isinstance(got_t, torch.Tensor)
        assert abs(float(got_t) - want) < 1e-12
    R = {"0001": 30, "0011": 10, "1001": 60}
    got = metrics.extract_probs(R, 2, 2)
    want = jmetrics.extract_probs(R, 2, 2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    q, Z = metrics.postselect_dense(torch.tensor([0.2, 0.2, 0.1, 0.5]), 1)
    np.testing.assert_allclose(q.numpy(), [0.5, 0.5])
    assert abs(float(Z) - 0.4) < 1e-7
    assert metrics.success_bound_check(0.5, np.log(2.0), 2, tol=0.01)
    assert not metrics.success_bound_check(0.9, np.log(2.0), 2, tol=0.01)
