"""Port parity of exact-MLE training: the fused lnZ + moments sweep (TPU
row 7's plain version), the differentiable lnZ (``kernels.log_partition``),
``models/train.py``'s steps and fits, the exact sampler and the
no-silent-gradient-loss guard, against the JAX package on the same
numpy-seeded inputs (its Pallas kernels interpreted on the CPU).

Tolerances: lnZ, moments and gradients within 1e-5 (float32 sweeps summed
in another order); SGD steps within 1e-5 on ``raw``; Adam's loss
trajectory within 1e-5 and ``raw`` within 1e-4 after 20 steps (Adam
divides by sqrt(v) + eps, so float32 differences in near-zero gradient
entries grow)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from qcmrf_tpu.evaluation import estimators as jestimators  # noqa: E402
from qcmrf_tpu.models import moments as jmoments  # noqa: E402
from qcmrf_tpu.models import sample as jsample  # noqa: E402
from qcmrf_tpu.models import train as jtrain  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402

from qcmrf_tpu_torch.evaluation import estimators  # noqa: E402
from qcmrf_tpu_torch.models import capability, moments, sample  # noqa: E402
from qcmrf_tpu_torch.models import train  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.ops import kernels, sampler_kernel  # noqa: E402
from qcmrf_tpu_torch.utils import moebius  # noqa: E402
from test_torch_moments import models  # noqa: E402

TOL = 1e-5


def _scale(name):
    # wide4 sums 219 cliques: a smaller theta keeps its spread near the
    # other structures' (as in test_torch_moments)
    return 0.05 if name == "wide4" else 0.4


def _sweep_args(m):
    coef = kernels.moebius_coefficients(m)[None]
    masks = torch.from_numpy(moebius.monomial_masks(m.cliques, m.n))
    return m.cliques, m.n, coef, m.beta, masks


# ---- row 7: the fused lnZ + moments sweep ----------------------------------


@pytest.mark.parametrize("name", ["K10", "K12", "chain14", "size34", "size5",
                                  "wide4"])
def test_fused_sweep_matches_jax(name):
    jm, m = models(name, scale=_scale(name), beta=1.3)
    want_lnz, want_mu = jmoments.lnz_and_moments_streaming(jm)
    lnz, mu = moments.lnz_and_moments_streaming(m)
    assert lnz.dtype == mu.dtype == torch.float32
    assert abs(float(lnz) - float(want_lnz)) <= TOL
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", ["K10", "size34", "size5", "isolated"])
def test_fused_sweep_matches_the_two_sweeps(name):
    """The fused plain version against the lse and monomial-moments plain
    versions: lnZ within 1e-5, every monomial moment within 1e-6."""
    _, m = models(name, beta=0.7)
    cl, n, coef, beta, masks = _sweep_args(m)
    M, S = kernels.lnz_moments_partials(cl, n, coef, beta, masks)
    lnz, mono = kernels.combine_lnz_moments(M, S)
    assert lnz.dtype == mono.dtype == torch.float64
    want_lnz = kernels.combine_lse(*kernels.lse_partials_reference(
        cl, n, coef, beta))
    assert abs(float(lnz[0]) - float(want_lnz[0])) <= TOL
    want = kernels.monomial_moments_reference(cl, n, coef, beta,
                                              want_lnz.float(), masks)
    np.testing.assert_allclose(mono.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)
    assert float(mono[0, 0]) == 1.0


def test_fused_partials_per_block():
    """Block b's partial is its own max and its weights exp(v - M_b)
    summed over each monomial's states of the block."""
    _, m = models("chain14")
    cl, n, coef, beta, masks = _sweep_args(m)
    M, S = kernels.lnz_moments_partials_reference(cl, n, coef, beta, masks)
    parts, per_part = kernels.lse_geometry(1 << n)
    assert M.shape == (1, parts) and S.shape == (1, parts, masks.numel())
    lp = kernels.logpot_table_reference(cl, n, coef, beta)[0].double()
    x = torch.arange(1 << n)
    for p in (0, parts // 2, parts - 1):
        sl = slice(p * per_part, (p + 1) * per_part)
        assert float(M[0, p]) == float(lp[sl].max())
        w = torch.exp(lp[sl] - float(M[0, p]))
        for g in (0, 3, masks.numel() - 1):
            mk = int(masks[g])
            want = float(w[(x[sl] & mk) == mk].sum())
            assert abs(float(S[0, p, g]) - want) <= 1e-5 * max(1.0, want)


def test_combine_ignores_empty_blocks():
    M = torch.tensor([[0.5, -float("inf"), 2.0]])
    S = torch.tensor([[[3.0, 1.0], [0.0, 0.0], [1.0, 0.5]]])
    lnz, mono = kernels.combine_lnz_moments(M, S)
    z = 3.0 * np.exp(0.5) + np.exp(2.0)
    assert abs(float(lnz[0]) - np.log(z)) < 1e-12
    assert abs(float(mono[0, 1]) - (np.exp(0.5) + 0.5 * np.exp(2.0)) / z) \
        < 1e-12


@pytest.mark.parametrize("step", [50, 200, 600])
def test_fused_split_over_launches_matches_one_launch(monkeypatch, step):
    """A mask list split over launches (each with mask 0, scaled by its own
    Z) gives what one launch gives."""
    _, m = models("wide4", scale=0.05)
    args = _sweep_args(m)
    want = kernels.combine_lnz_moments(*kernels.lnz_moments_partials(*args))
    calls = []
    plain = kernels.lnz_moments_partials_reference

    def counted(cl, n, coef, beta, masks, *sweep_range):
        calls.append(masks.numel())
        assert int(masks[0]) == 0
        return plain(cl, n, coef, beta, masks, *sweep_range)

    monkeypatch.setattr(kernels, "lnz_moments_partials_reference", counted)
    monkeypatch.setattr(kernels, "moments_per_launch",
                        lambda cliques, n: step)
    got = kernels.combine_lnz_moments(*kernels.lnz_moments_partials(*args))
    m_total = args[4].numel()
    assert len(calls) == 1 + -(-(m_total - step) // (step - 1))
    assert all(c <= step for c in calls)
    assert abs(float(got[0][0]) - float(want[0][0])) <= 1e-12
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0,
                               atol=1e-7)


def test_fused_wrapper_needs_the_empty_monomial():
    cl, n, coef, beta, masks = _sweep_args(models("K10")[1])
    with pytest.raises(ValueError, match="empty monomial"):
        kernels.lnz_moments_partials(cl, n, coef, beta, masks[1:])


# ---- the differentiable lnZ --------------------------------------------------


@pytest.mark.parametrize("name", ["K10", "size5", "isolated"])
def test_lnz_gradient_matches_jax(name):
    jm, m = models(name, beta=1.3)
    want = np.asarray(jax.grad(lambda t: jmoments.log_partition_streaming(
        jm.with_theta(t)))(jm.theta))
    want_table = np.asarray(jax.grad(
        lambda t: jm.with_theta(t).log_partition())(jm.theta))
    theta = m.theta.clone().requires_grad_()
    (got,) = torch.autograd.grad(
        moments.log_partition_streaming(m.with_theta(theta)), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    (got,) = torch.autograd.grad(m.with_theta(theta).log_partition(), theta)
    np.testing.assert_allclose(got.numpy(), want_table, rtol=0, atol=TOL)
    assert abs(float(m.with_theta(theta).log_partition().detach())
               - float(jm.log_partition())) <= TOL


def test_value_only_lnz_takes_the_lse_sweep(monkeypatch):
    """Grad mode off, or theta not requiring grad: one lse sweep and no
    fused sweep; under differentiation the fused sweep alone."""
    _, m = models("K10")
    want = float(kernels.log_partition(m))

    def no(*args, **kwargs):
        raise AssertionError("wrong sweep")

    theta = m.theta.clone().requires_grad_()
    with monkeypatch.context() as mp:
        mp.setattr(kernels, "lnz_moments_partials", no)
        assert float(moments.log_partition_streaming(m)) == want
        with torch.no_grad():
            assert float(m.with_theta(theta).log_partition()) == want
    monkeypatch.setattr(kernels, "lse_partials", no)
    lnz = m.with_theta(theta).log_partition()
    assert lnz.requires_grad and abs(float(lnz.detach()) - want) <= TOL


def test_nll_gradient_is_the_moment_gap():
    """``MRF.nll(x).backward()`` gives beta * (E_p[phi] - E_data[phi])."""
    jm, m = models("size34", beta=0.8)
    x = np.random.RandomState(5).randint(0, 1 << m.n, 500)
    theta = m.theta.clone().requires_grad_()
    m.with_theta(theta).nll(x).backward()
    mu = moments.clique_moments_streaming(m)
    emp = estimators.clique_marginals_from_samples(m, x).float()
    np.testing.assert_allclose(theta.grad.numpy(),
                               (m.beta * (mu - emp)).numpy(), rtol=0,
                               atol=TOL)
    assert abs(float(m.nll(x)) - float(jm.nll(jnp.asarray(x)))) <= TOL


def _wrapper_calls():
    cl, n = ((0, 1), (1, 2)), 3
    coef = kernels.coefficient_table(cl, n, torch.full((8,), -0.3))[None]
    masks = torch.tensor([0, 1, 3])
    lnz = torch.zeros(1)
    return {
        "logpot_table": lambda c: kernels.logpot_table(cl, n, c, 1.0),
        "lse_partials": lambda c: kernels.lse_partials(cl, n, c, 1.0),
        "map_partials": lambda c: kernels.map_partials(cl, n, c, 1.0),
        "monomial_moments": lambda c: kernels.monomial_moments(
            cl, n, c, 1.0, lnz, masks),
        "lnz_moments_partials": lambda c: kernels.lnz_moments_partials(
            cl, n, c, 1.0, masks),
        # the sampler takes keep probabilities, exp of the table's entries
        "sample_call": lambda c: sampler_kernel.sample_call(
            0, cl, n, torch.exp(c), 16, "flags"),
    }, coef


@pytest.mark.parametrize("wrapper", sorted(_wrapper_calls()[0]))
def test_kernel_wrappers_refuse_a_lost_gradient(wrapper):
    """No kernel has a backward: coefficients that require grad raise
    under grad mode (on every device), and pass under no_grad or
    detached."""
    calls, coef = _wrapper_calls()
    call = calls[wrapper]
    live = coef.clone().requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        call(live)
    with torch.no_grad():
        call(live)
    call(live.detach())


# ---- train steps ---------------------------------------------------------------


def _problem(cliques, n=None, seed=0, samples=401):
    """A random start and random data. No gradient entry is 0 by symmetry
    (a constant theta with a data count of exactly a quarter would give
    one, and Adam's first step would then follow the sign of rounding
    noise)."""
    d = sum(1 << len(C) for C in cliques)
    n = n or 1 + max(v for C in cliques for v in C)
    rng = np.random.RandomState(seed)
    theta0 = (-0.1 - 0.5 * np.abs(rng.randn(d))).astype(np.float32)
    data = rng.randint(0, 1 << n, samples).astype(np.int32)
    jm = JMRF.create(cliques, theta=jnp.asarray(theta0), n=n)
    m = MRF.create(cliques, theta=theta0, n=n, device="cpu")
    return jm, m, data


def _grid(rows, cols):
    from qcmrf_tpu_torch.models.mrf import grid_cliques

    return grid_cliques(rows, cols)


ROUTES = {"table": _grid(3, 4), "elimination": [[i, i + 1] for i in
                                                range(23)]}


def _run_jax(jm, jopt, data, steps, moment=None):
    raw = jtrain._from_theta(jm.theta, True)
    state = jopt.init(raw)
    step = (jtrain.make_train_step(jm, jopt) if moment is None
            else jtrain.make_moment_train_step(jm, jopt, moment))
    losses = []
    for _ in range(steps):
        if moment is None:
            raw, state, loss = step(raw, state, jnp.asarray(data))
        else:
            raw, state, loss = step(raw, state)
        losses.append(float(loss))
    return np.asarray(raw), state, losses


def _run_port(m, opt_fn, data, steps, moment=None):
    raw = train._from_theta(m.theta, True).requires_grad_()
    opt = opt_fn([raw])
    step = (train.make_train_step(m, opt) if moment is None
            else train.make_moment_train_step(m, opt, moment))
    losses = [float(step(data)) for _ in range(steps)]
    return raw.detach().numpy(), losses


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_step_sgd_matches_jax(route):
    jm, m, data = _problem(ROUTES[route])
    want_raw, _, want = _run_jax(jm, optax.sgd(0.1), data, 3)
    got_raw, got = _run_port(m, lambda p: torch.optim.SGD(p, lr=0.1), data, 3)
    # a loss near 17 carries float32 rounding of ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=TOL)
    np.testing.assert_allclose(got_raw, want_raw, rtol=0, atol=TOL)


def test_train_step_adam_matches_jax():
    jm, m, data = _problem(_grid(3, 4), seed=1)
    want_raw, _, want = _run_jax(jm, optax.adam(0.05), data, 20)
    got_raw, got = _run_port(m, lambda p: train.adam(p, 0.05), data, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_raw, want_raw, rtol=0, atol=1e-4)


@pytest.mark.parametrize("route", ["elimination", "streaming"])
def test_moment_train_step_matches_jax(route, monkeypatch):
    """The big-n step on the sufficient statistics: elimination, or the
    streaming fused sweep forced in both packages by a width cap of 1
    (JAX's Gram kernel interpreted at n = 10)."""
    if route == "streaming":
        cliques = [[i, j] for i in range(10) for j in range(i + 1, 10)]
        monkeypatch.setattr(jtrain, "_ELIM_WIDTH_CAP", 1)
        monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    else:
        cliques = ROUTES["elimination"]
    jm, m, _ = _problem(cliques)
    mu = np.random.RandomState(3).uniform(0.1, 0.5, m.dimension).astype(
        np.float32)
    want_raw, _, want = _run_jax(jm, optax.sgd(0.1), None, 3, moment=mu)
    launches = []
    if route == "streaming":
        plain = kernels.lnz_moments_partials

        def fused(*args):
            launches.append(1)
            return plain(*args)

        monkeypatch.setattr(kernels, "lnz_moments_partials", fused)
    got_raw, got = _run_port(m, lambda p: torch.optim.SGD(p, lr=0.1), None,
                             3, moment=mu)
    assert len(launches) == (3 if route == "streaming" else 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_raw, want_raw, rtol=0, atol=TOL)


def test_adam_from_numpy_continues_a_jax_run():
    """Five JAX Adam steps, the state carried across, then five more in
    each package."""
    jm, m, data = _problem(_grid(3, 4), seed=2)
    jopt = optax.adam(0.05)
    raw, state, _ = _run_jax(jm, jopt, data, 5)
    adam_state = state[0]
    jraw = jnp.asarray(raw)
    step = jtrain.make_train_step(jm, jopt)
    want = []
    for _ in range(5):
        jraw, state, loss = step(jraw, state, jnp.asarray(data))
        want.append(float(loss))
    traw, opt = train.adam_from_numpy(
        raw, np.asarray(adam_state.mu), np.asarray(adam_state.nu),
        int(adam_state.count), 0.05, device="cpu")
    st = opt.state_dict()["state"][0]
    assert float(st["step"]) == 5.0
    np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                  np.asarray(adam_state.mu))
    tstep = train.make_train_step(m, opt)
    got = [float(tstep(data)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(traw.detach().numpy(), np.asarray(jraw),
                               rtol=0, atol=1e-4)


def test_reparameterisation_matches_jax():
    theta = np.array([-3.0, -0.5, -1e-5, 0.0, -20.0], np.float32)
    raw = train._from_theta(torch.from_numpy(theta), True)
    want = np.asarray(jtrain._from_theta(jnp.asarray(theta), True))
    np.testing.assert_allclose(raw.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        train._to_theta(raw, True).numpy(),
        np.asarray(jtrain._to_theta(jnp.asarray(want), True)), rtol=1e-6)
    assert torch.equal(train._from_theta(torch.from_numpy(theta), False),
                       torch.from_numpy(theta))


# ---- convergence (mirrors tests/test_train.py) --------------------------------


def _jax_problem(seed):
    rng = np.random.RandomState(seed)
    theta = (-np.abs(rng.randn(8)) * 0.8).astype(np.float32)
    true = JMRF.create([[0, 1], [1, 2]], theta=theta)
    data = np.array(jsample.sample_exact(jax.random.PRNGKey(seed), true,
                                         20_000))
    return MRF.create([[0, 1], [1, 2]], theta=theta, device="cpu"), data


def test_fit_recovers_distribution():
    true, data = _jax_problem(1)
    init = true.with_theta(torch.full((8,), -0.5))
    fitted, loss = train.fit_mle(init, data, steps=400, learning_rate=0.05)
    np.testing.assert_allclose(fitted.gibbs_probs().numpy(),
                               true.gibbs_probs().numpy(), atol=0.01)
    assert float(loss) < float(init.nll(data))
    assert not fitted.theta.requires_grad


def test_nonpositive_constraint_held():
    true, data = _jax_problem(2)
    fitted, _ = train.fit_mle(true.with_theta(torch.full((8,), -0.5)), data,
                              steps=100)
    assert bool((fitted.theta <= 0).all())


def test_fit_mle_shots_converges():
    """Quantum-in-the-loop MLE: the model moments come only from
    post-selected shots of the sampler (its plain version here)."""
    true, data = _jax_problem(0)
    init = true.with_theta(torch.full((8,), -0.5))
    fitted, delta = train.fit_mle_shots(init, data, seed=2, steps=150,
                                        shots=1 << 13, learning_rate=0.1)
    p = true.gibbs_probs().double().numpy()
    q = fitted.gibbs_probs().double().numpy()
    assert 0.0 < delta <= 1.0
    assert float(np.sum(p * np.log(p / q))) < 0.02


def test_shots_step_is_a_function_of_its_key():
    true, data = _jax_problem(3)
    marg = estimators.clique_marginals_from_samples(true, data)
    raws = []
    for _ in range(2):
        raw = train._from_theta(true.theta, True).requires_grad_()
        step = train.make_shots_train_step(
            true, torch.optim.SGD([raw], lr=0.1), 2048, marg)
        deltas = [step(7, s) for s in range(3)]
        raws.append(raw.detach().clone())
    assert torch.equal(raws[0], raws[1]) and 0 < deltas[-1] <= 1


# ---- data moments ---------------------------------------------------------------


def test_empirical_moments_from_bits_equal_jax():
    rng = np.random.RandomState(0)
    cliques = [[0, 1], [1, 2, 3], [3, 4], [0, 4]]
    jm = JMRF.create(cliques)
    m = MRF.create(cliques, device="cpu")
    bits = (rng.rand(777, 5) < 0.4).astype(np.uint8)
    got = train.empirical_moments_from_bits(m, bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtrain.empirical_moments_from_bits(jm, bits)))
    with pytest.raises(ValueError, match="samples, n=5"):
        train.empirical_moments_from_bits(m, bits[:, :4])
    with pytest.raises(ValueError, match="0/1"):
        train.empirical_moments_from_bits(m, bits * 2)


def test_clique_marginals_from_samples_equal_jax():
    rng = np.random.RandomState(1)
    cliques = [[0, 1], [1, 2, 3], [3, 4]]
    jm = JMRF.create(cliques)
    m = MRF.create(cliques, device="cpu")
    x = rng.randint(0, 32, 1000)
    acc = rng.rand(1000) < 0.6
    for a in (None, acc):
        got = estimators.clique_marginals_from_samples(m, x, a)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(
            got.numpy(), jestimators.clique_marginals_from_samples(jm, x, a))


# ---- the exact sampler ------------------------------------------------------------


@pytest.mark.parametrize("two_stage", [False, True])
def test_sample_exact_follows_the_gibbs_distribution(monkeypatch, two_stage):
    if two_stage:
        monkeypatch.setattr(sample, "_CATEGORICAL_BUDGET", 1 << 10)
    _, m = models("small", scale=0.6)
    x = sample.sample_exact(3, m, 40_000)
    assert x.dtype == torch.int32 and x.shape == (40_000,)
    freq = np.bincount(x.numpy(), minlength=1 << m.n) / 40_000
    p = m.gibbs_probs().double().numpy()
    # 5 binomial sigma per state
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / 40_000)
                  + 1e-9)
    again = sample.sample_exact(torch.Generator().manual_seed(3), m, 40_000)
    assert torch.equal(x, again)


def test_sample_exact_two_stage_moments_at_n12(monkeypatch):
    monkeypatch.setattr(sample, "_CATEGORICAL_BUDGET", 1 << 20)
    _, m = models("K12", scale=0.2)
    x = sample.sample_exact(5, m, 5000)  # 5000 * 2^12 > 2^20: two stages
    assert int(x.min()) >= 0 and int(x.max()) < 1 << 12
    emp = estimators.clique_marginals_from_samples(m, x).float()
    np.testing.assert_allclose(emp.numpy(),
                               moments.clique_moments_streaming(m).numpy(),
                               atol=0.03)


# ---- unported routes ---------------------------------------------------------------


def test_unported_routes_name_their_slices():
    """The sharded routes of slices 6a and 6b run. A mesh whose size
    divides no shot count or is not a power of two is refused, by the
    gate-level sharded engine too."""
    from qcmrf_tpu_torch.circuits.ir import Circuit
    from qcmrf_tpu_torch.parallel import sharded

    raw = torch.zeros(4, requires_grad=True)
    m = MRF.create([[0, 1]], device="cpu")
    mesh3 = sharded.Mesh((torch.device("cpu"),) * 3)
    wall = Circuit(4)
    wall.h(0)
    for fn in (sharded.run_statevector_sharded,
               sharded.sharded_outcome_probs):
        with pytest.raises(ValueError, match="power-of-two mesh"):
            fn(wall, mesh3)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        train.make_shots_train_step(m, torch.optim.SGD([raw], lr=0.1), 8,
                                    np.zeros(4), mesh=mesh3)(0)
    with pytest.raises(ValueError, match="power-of-two mesh"):
        train.make_lnz_fn(_wide(), mesh=mesh3)(_wide().theta)


def _wide():
    """K27's structure at zero theta: width 27 > 25, the streaming branch."""
    cl = [[i, j] for i in range(27) for j in range(i + 1, 27)]
    return MRF.create(cl, device="cpu")


def test_lnz_router_refuses_past_both_caps(monkeypatch):
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    m = MRF.create([[i, i + 1] for i in range(48)], device="cpu")
    with pytest.raises(ValueError, match="no exact lnZ"):
        train.make_lnz_fn(m)
