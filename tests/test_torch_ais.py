"""Port parity of annealed importance sampling (``models/ais.py``, the chain
kernel's AIS mode's plain version, ``make_ais_train_step``, ``train --grad
ais`` and ``infer --method ais``) against the JAX package on the CPU.

The deterministic parts agree with JAX exactly or within 1e-6: the
log-potential of bit arrays, the float32 linear schedule (bit for bit),
and the pooling of given log-weights and states into ln Z, ESS, stderr,
event probabilities and clique marginals. The chains draw from Philox
where JAX splits keys, so the estimators are held, each on its own draws,
to the exact answers at the JAX tests' own settings and bars."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models import ais as jais  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.runners import infer_cli as jinfer  # noqa: E402

from qcmrf_tpu_torch.models import ais, capability, elimination  # noqa: E402
from qcmrf_tpu_torch.models import sample as msample  # noqa: E402
from qcmrf_tpu_torch.models import train as mtrain  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf, grid_mrf  # noqa: E402
from qcmrf_tpu_torch.ops import gibbs_kernel  # noqa: E402
from qcmrf_tpu_torch.parallel import sharded  # noqa: E402
from qcmrf_tpu_torch.runners import infer_cli, train_cli  # noqa: E402


def seeded(template, seed, scale):
    rng = np.random.RandomState(seed)
    return template.with_theta(
        -np.abs(rng.randn(template.dimension)).astype(np.float32) * scale)


def both(cliques, seed, scale, n=None):
    """The same model in both packages (port on the CPU)."""
    m = seeded(MRF.create(cliques, n=n, device="cpu"), seed, scale)
    return m, JMRF.create(cliques, theta=m.theta.numpy(), n=n)


# ---- deterministic parts, against JAX ---------------------------------


@pytest.mark.parametrize("which", ["grid3x3", "chain80"])
def test_logpot_bits_matches_jax(which):
    cl = (grid_mrf(3, 3, device="cpu").cliques if which == "grid3x3"
          else [[i, i + 1] for i in range(79)])
    m, jm = both([list(C) for C in cl], 3, 1.0)
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 2, size=(16, m.n)).astype(np.int32)
    got = ais.logpot_bits(m, torch.from_numpy(rows)).numpy()
    want = np.asarray([jais.logpot_bits(jm, jnp.asarray(r)) for r in rows])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # one row, as JAX takes it; the kernel's warp-order sum within rounding
    assert abs(float(ais.logpot_bits(m, rows[0])) - want[0]) <= 1e-6
    warp = gibbs_kernel.rung_logpots(m.cliques, m.theta,
                                     torch.from_numpy(rows))
    np.testing.assert_allclose(warp.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("T", [1, 6, 7, 24, 64, 96, 128, 1000])
def test_schedule_is_jnp_linspace_bit_for_bit(T):
    want = np.asarray(jnp.linspace(0.0, 1.0, T + 1))
    got = gibbs_kernel.ais_betas(T).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    sched = gibbs_kernel.ais_schedule(T, 0.7).numpy()
    b = np.float32(0.7)
    np.testing.assert_array_equal(sched[0], want[1:] * b)
    np.testing.assert_array_equal(sched[1], (want[1:] - want[:-1]) * b)


def test_pooling_matches_jax(monkeypatch):
    """Given the same log-weights and final states, both packages pool them
    into the same ln Z, ESS, stderr, event probability and clique
    marginals."""
    cl = [[0, 1], [1, 2, 3], [3, 4], [0, 4]]
    m, jm = both(cl, 7, 0.5)
    rng = np.random.RandomState(1)
    M = 96
    logw = (rng.randn(M) * 1.5).astype(np.float32)
    bits = rng.randint(0, 2, size=(M, m.n))
    monkeypatch.setattr(jais, "_run_any", lambda *a: (
        jnp.asarray(logw), jnp.asarray(bits, jnp.int32)))
    monkeypatch.setattr(ais, "_run", lambda *a: (
        torch.from_numpy(logw), torch.from_numpy(bits.astype(np.int8))))
    key = jax.random.PRNGKey(0)
    lnz, d = ais.ais_log_partition(0, m, M, return_diagnostics=True)
    jlnz, jd = jais.ais_log_partition(key, jm, M, return_diagnostics=True)
    assert abs(float(lnz) - float(jlnz)) <= 1e-6
    for k in ("ess", "stderr"):
        assert abs(float(d[k]) - float(jd[k])) <= 1e-6 * max(
            1.0, abs(float(jd[k]))), k
    for v, b in ((2, 1), (4, 0)):
        p, dp = ais.ais_event_prob(0, m, v, b, M, return_diagnostics=True)
        jp = jais.ais_event_prob(key, jm, v, b, M)
        assert abs(float(p) - float(jp)) <= 1e-6
    mu, dm = ais.ais_clique_marginals(0, m, M, return_diagnostics=True)
    jmu = jais.ais_clique_marginals(key, jm, M)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0,
                               atol=1e-6)
    assert abs(float(dp["ess"]) - float(jd["ess"])) <= 1e-6 * float(jd["ess"])
    assert dm["log_weights"] is not None


def test_plain_version_is_the_gibbs_chain_at_one_rung():
    """One rung at scale beta is a Gibbs chain: the same initial state,
    Philox words and thresholds, so the final states equal the chain's
    after sweeps_per_temp sweeps; the log-weight is fl(beta * theta^T
    phi(x0)) of the initial state, summed in the warp's order."""
    m = seeded(MRF.create([[0, 1, 2], [2, 3], [3, 4, 5], [5, 0], [6]],
                          device="cpu"), 2, 0.6)
    logw, bits = gibbs_kernel.ais_chains(5, m.cliques, m.n, m.theta, 0.8,
                                         12, 1, 7, chain_ids=range(4, 16))
    thetas = m.theta[None].expand(12, -1).contiguous()
    chain = gibbs_kernel.gibbs_chains_reference(
        5, m.cliques, m.n, thetas, 0.8, 1, 1, 6, chain_ids=range(4, 16))
    assert torch.equal(bits, chain[:, 0])
    x0 = gibbs_kernel.initial_bits(5, torch.arange(4, 16), m.n)
    w = gibbs_kernel.rung_logpots(m.cliques, m.theta, x0) * torch.tensor(
        0.8, dtype=torch.float32)
    assert torch.equal(logw, w)
    # the estimators' stream s: chain c keyed s * M + c
    lw1, b1 = ais._run(5, m, 12, 1, 7, 1, None)
    lw2, b2 = gibbs_kernel.ais_chains(5, m.cliques, m.n, m.theta, m.beta,
                                      12, 1, 7, chain_ids=range(12, 24))
    assert torch.equal(b1, b2) and torch.equal(lw1, lw2)


def test_plain_version_weight_steps():
    """Over T rungs the log-weight is the float32 sum, rung by rung, of
    w_t * theta^T phi(x) at the state before rung t's sweeps."""
    m = seeded(chain_mrf(6, device="cpu"), 4, 0.5)
    T, spt = 5, 2
    logw, _ = gibbs_kernel.ais_chains(3, m.cliques, m.n, m.theta, 1.0, 8, T,
                                      spt)
    sched = gibbs_kernel.ais_schedule(T, 1.0)
    thetas = m.theta[None].expand(8, -1).contiguous()
    bits = gibbs_kernel.initial_bits(3, torch.arange(8), m.n)
    want = torch.zeros(8)
    s = 0
    for t in range(T):
        want = want + sched[1, t] * gibbs_kernel.rung_logpots(
            m.cliques, m.theta, bits)
        for _ in range(spt):
            thr = gibbs_kernel.site_thresholds(3, torch.arange(8), s, m.n)
            for v in range(m.n):
                x = gibbs_kernel.site_deltas(m.cliques, m.n, thetas, bits,
                                             v) * sched[0, t]
                bits[:, v] = (x >= thr[:, v]).long()
            s += 1
    assert torch.equal(logw, want)


def test_partings_name_each_chains_first_near_decision(monkeypatch):
    """``ais_chains_reference(near=True)`` runs the same chains and names
    each one's first decision within 2 ulp of p1; ``ais_partings`` maps it
    to the rows of ``got`` that differ. At beta 0 every p1 is 0.5: the
    uniforms are set to 0.5 at sweep key % 3, site 1 of each chain, and
    nowhere else near it."""
    m = seeded(chain_mrf(5, device="cpu"), 1, 0.5)
    ids = torch.arange(7, 13)
    plain = gibbs_kernel.site_uniforms

    def uniforms(seed, keys, sweep, n):
        u = plain(seed, keys, sweep, n)
        u[(keys % 3) == sweep, 1] = 0.5
        return u

    monkeypatch.setattr(gibbs_kernel, "site_uniforms", uniforms)
    args = (4, m.cliques, m.n, m.theta, 0.0, 6, 2, 2)
    lw, b = gibbs_kernel.ais_chains_reference(*args, chain_ids=ids)
    lw2, b2, first = gibbs_kernel.ais_chains_reference(*args, chain_ids=ids,
                                                       near=True)
    assert torch.equal(lw, lw2) and torch.equal(b, b2)
    assert first == [(int(k) % 3, 1, 0.5, 0.5) for k in ids]
    got = b.clone()
    got[[1, 4], 0] ^= 1
    parts = gibbs_kernel.ais_partings(4, m.cliques, m.n, m.theta, 0.0, 2, 2,
                                      got, b, chain_ids=ids)
    assert parts == [(1, 8 % 3, 1, 0.5, 0.5), (4, 11 % 3, 1, 0.5, 0.5)]
    assert all(gibbs_kernel.within_ulps(u, p1) for *_, u, p1 in parts)
    assert gibbs_kernel.ais_partings(4, m.cliques, m.n, m.theta, 0.0, 2, 2,
                                     b, b, chain_ids=ids) == []


def test_arguments_are_checked():
    m = chain_mrf(3, device="cpu")
    with pytest.raises(ValueError, match="at least 1 rung"):
        gibbs_kernel.ais_betas(0)
    with pytest.raises(ValueError, match=">= 1"):
        gibbs_kernel.ais_chains(0, m.cliques, 3, m.theta, 1.0, 0, 4, 1)
    with pytest.raises(ValueError, match="shape"):
        gibbs_kernel.ais_chains(0, m.cliques, 3, m.theta[:4], 1.0, 4, 4, 1)
    # the chains must divide over a mesh (JAX's rule)
    with pytest.raises(ValueError, match="must divide over the 4-device"):
        ais.ais_log_partition(0, m, 6, 4, mesh=sharded.make_mesh(
            4, device="cpu"))
    with pytest.raises(ValueError, match="card"):
        gibbs_kernel.ais_resident_blocks(m.cliques, 3, "cpu")


# ---- the estimator, in distribution -----------------------------------


def test_ais_matches_exact_small():
    m, _ = both(grid_mrf(3, 3, device="cpu").cliques, 1, 0.4)
    exact = float(m.log_partition())
    lnz, diag = ais.ais_log_partition(0, m, num_chains=256, num_temps=128,
                                      return_diagnostics=True)
    assert abs(float(lnz) - exact) < max(4 * float(diag["stderr"]), 0.02)
    assert 1.0 < float(diag["ess"]) <= 256.0
    assert diag["log_weights"].shape == (256,)


def test_ais_matches_elimination_large_chain():
    m = seeded(chain_mrf(40, device="cpu"), 2, 0.3)
    exact = float(elimination.log_partition(m))
    lnz, diag = ais.ais_log_partition(1, m, num_chains=128, num_temps=96,
                                      return_diagnostics=True)
    assert abs(float(lnz) - exact) < max(4 * float(diag["stderr"]), 0.05)


def test_ais_beta_zero_is_n_ln2():
    m = chain_mrf(6, beta=0.0, device="cpu")
    m = m.with_theta(torch.full((m.dimension,), -1.0))
    lnz = ais.ais_log_partition(0, m, num_chains=16, num_temps=8)
    assert float(lnz) == pytest.approx(6 * np.log(2.0), abs=1e-6)


def test_ais_marginals_match_exact():
    m, _ = both(grid_mrf(3, 3, device="cpu").cliques, 5, 0.4)
    exact = elimination.clique_marginals(m).numpy()
    mu, diag = ais.ais_clique_marginals(0, m, num_chains=512, num_temps=96,
                                        return_diagnostics=True)
    mu = mu.numpy()
    np.testing.assert_allclose(mu.reshape(-1, 4).sum(1), 1.0, atol=1e-5)
    assert float(diag["ess"]) > 64
    assert np.max(np.abs(mu - exact)) < 0.08
    assert np.mean(np.abs(mu - exact)) < 0.02


def test_ais_event_prob_matches_exact():
    cl = [[i, i + 1] for i in range(5)] + [[0, 3]]
    m = seeded(MRF.create(cl, device="cpu"), 8, 0.4)
    p, diag = ais.ais_event_prob(0, m, 2, 1, num_chains=512, num_temps=64,
                                 return_diagnostics=True)
    exact = float(elimination.conditional_prob(m, 2, 1, {}))
    assert float(diag["ess"]) > 51.2
    assert abs(float(p) - exact) < 0.05


# ---- infer --method ais ------------------------------------------------


@pytest.fixture
def chain6(tmp_path):
    def write(seed):
        rng = np.random.RandomState(seed)
        cl = [[i, i + 1] for i in range(5)]
        theta = (-np.abs(rng.randn(20)) * 0.3).tolist()
        path = tmp_path / f"m{seed}.json"
        path.write_text(json.dumps({"cliques": cl, "theta": theta}))
        return ["--model", str(path)]
    return write


def assert_keys_equal(got, want):
    assert set(got) == set(want)
    assert set(got["ais"]) == set(want["ais"])
    assert got["backend"] == want["backend"] == "ais"


def test_infer_cli_ais_lnz(chain6):
    model = chain6(4)
    cpu = ["--platform", "cpu"]
    ais_args = ["--method", "ais", "--ais-chains", "128", "--ais-temps", "64"]
    exact = infer_cli.main(model + ["--query", "lnz"] + cpu)
    r = infer_cli.main(model + ["--query", "lnz"] + ais_args + cpu)
    assert_keys_equal(r, jinfer.main(model + ["--query", "lnz"] + ais_args
                                     + cpu))
    assert abs(r["lnz"] - exact["lnz"]) < max(4 * r["ais"]["stderr"], 0.05)
    assert r["ais"]["ess"] > 16
    assert r["ais"] == {**r["ais"], "chains": 128, "temps": 64, "seed": 0}
    ev = ["--evidence", "0=1"]
    re_ = infer_cli.main(model + ["--query", "lnz"] + ev + ais_args + cpu)
    ex_ = infer_cli.main(model + ["--query", "lnz"] + ev + cpu)
    assert abs(re_["log_mass"] - ex_["log_mass"]) < max(
        4 * re_["ais"]["stderr"], 0.05)
    assert_keys_equal(re_, jinfer.main(model + ["--query", "lnz"] + ev
                                       + ais_args + cpu))
    # every variable observed: the clamped constant, no chain run
    ev_all = ["--evidence", ",".join(f"{v}=1" for v in range(6))]
    fa = infer_cli.main(model + ["--query", "lnz", "--method", "ais"]
                        + ev_all + cpu)
    fe = infer_cli.main(model + ["--query", "lnz"] + ev_all + cpu)
    assert fa["log_mass"] == pytest.approx(fe["log_mass"], abs=1e-5)
    assert fa["ais"]["stderr"] == 0.0 and fa["ais"]["ess"] == 256.0


def test_infer_cli_ais_marginals(chain6):
    model = chain6(6)
    cpu = ["--platform", "cpu"]
    q = ["--query", "marginals", "--evidence", "0=1,1=0"]
    ais_args = ["--method", "ais", "--ais-chains", "512", "--ais-temps", "64"]
    ex = infer_cli.main(model + q + cpu)
    r = infer_cli.main(model + q + ais_args + cpu)
    assert_keys_equal(r, jinfer.main(model + q + ais_args + cpu))
    a, e = np.asarray(r["marginals"]), np.asarray(ex["marginals"])
    assert np.max(np.abs(a - e)) < 0.08
    # the evidence's zeros and one-hots re-embedded exactly
    assert np.any(e == 0) and np.any(e == 1)
    assert np.all(a[e == 0] == 0) and np.all(a[e == 1] == 1)
    r = infer_cli.main(model + ["--query", "marginals", "--method", "ais",
                                "--ais-chains", "64", "--ais-temps", "8"]
                       + cpu)
    assert len(r["marginals"]) == 20 and r["backend"] == "ais"


def test_infer_cli_ais_prob(chain6):
    model = chain6(9)
    cpu = ["--platform", "cpu"]
    q = ["--query", "prob", "--of", "3=1", "--evidence", "0=1"]
    ais_args = ["--method", "ais", "--ais-chains", "512", "--ais-temps", "64"]
    r = infer_cli.main(model + q + ais_args + cpu)
    assert_keys_equal(r, jinfer.main(model + q + ais_args + cpu))
    assert r["ais"]["ess"] > 51.2
    exact = infer_cli.main(model + q + cpu)["prob"]
    assert abs(r["prob"] - exact) < 0.05
    # a queried variable that is observed answers exactly, no chain run
    r = infer_cli.main(model + ["--query", "prob", "--of", "0=1",
                                "--evidence", "0=1", "--method", "ais"]
                       + cpu)
    assert r["prob"] == 1.0 and r["backend"] == "ais"
    r = infer_cli.main(model + ["--query", "prob", "--of", "2=1",
                                "--method", "ais", "--ais-chains", "32",
                                "--ais-temps", "8"] + cpu)
    assert r["backend"] == "ais" and 0.0 <= r["prob"] <= 1.0


def test_infer_cli_ais_past_both_caps(tmp_path, monkeypatch):
    """Where both exact backends refuse, --method ais answers, in batch
    specs too; theta = 0 gives n ln 2 exactly; explain selects ais."""
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    monkeypatch.setattr(capability, "STREAMING_MAX_N", 6)
    cl = [[i, j] for i in range(5) for j in range(i + 1, 5)]
    cl += [[i, i + 1] for i in range(4, 9)]
    path = tmp_path / "wide.json"
    path.write_text(json.dumps({"cliques": cl,
                                "theta": [0.0] * (4 * len(cl))}))
    base = ["--model", str(path), "--platform", "cpu"]
    with pytest.raises(SystemExit, match="caps at n=6"):
        infer_cli.main(base + ["--query", "lnz"])
    r = infer_cli.main(base + ["--query", "lnz", "--method", "ais",
                               "--ais-chains", "8", "--ais-temps", "4"])
    assert r["lnz"] == pytest.approx(10 * np.log(2.0), abs=1e-5)
    queries = tmp_path / "q.jsonl"
    queries.write_text("\n".join(json.dumps(q) for q in (
        {"query": "marginals", "method": "ais"},
        {"query": "prob", "of": "9=1", "method": "ais"})) + "\n")
    out = infer_cli.main(base + ["--queries", str(queries), "--ais-chains",
                                 "16", "--ais-temps", "4"])
    assert [o["backend"] for o in out] == ["ais", "ais"]
    assert abs(out[1]["prob"] - 0.5) < 0.4
    rep = capability.explain(cl, 10, query="lnz", method="ais")
    assert rep["selected"] == "ais" and rep["backends"]["ais"]["feasible"]
    assert capability.explain(cl, 10, query="lnz")["selected"] == "ais"
    assert capability.explain(cl, 10, query="map")["selected"] is None
    monkeypatch.undo()
    assert capability.explain(cl, 10, query="prob",
                              method="ais")["selected"] == "ais"
    assert capability.explain(cl, 10, query="prob")["selected"] == (
        "elimination")


# ---- training ------------------------------------------------------------


def test_ais_step_converges_to_moment_match():
    from qcmrf_tpu_torch.evaluation.estimators import (
        clique_marginals_from_samples)

    template = MRF.create([[i, i + 1] for i in range(4)], device="cpu")
    true = seeded(template, 0, 1.0)
    data = msample.sample_exact(0, true, 6000)
    mu_hat = clique_marginals_from_samples(template, data)
    raw = mtrain._from_theta(torch.full((template.dimension,), -0.5),
                             True).requires_grad_()
    opt = mtrain.adam([raw], 0.1)
    step = mtrain.make_ais_train_step(template, opt, mu_hat, num_chains=128,
                                      num_temps=24)
    for s in range(80):
        info = step(1, s)
    assert not info["skipped"] and info["ess"] > 12.8
    fitted = template.with_theta(mtrain._to_theta(raw, True).detach())
    mu_fit = elimination.clique_marginals(fitted).numpy()
    assert np.abs(mu_fit - mu_hat.numpy()).max() < 0.06


def test_ais_step_ess_gate_skips(monkeypatch):
    template = MRF.create([[0, 1], [1, 2]], device="cpu")
    raw = mtrain._from_theta(torch.full((template.dimension,), -0.5),
                             True).requires_grad_()
    opt = mtrain.adam([raw], 0.1)
    before = raw.detach().clone()

    def collapsed(seed, m, **kw):
        return (torch.full((m.dimension,), 0.5),
                {"ess": torch.tensor(1.0), "log_weights": None})

    monkeypatch.setattr(ais, "ais_clique_marginals", collapsed)
    step = mtrain.make_ais_train_step(template, opt,
                                      np.full(template.dimension, 0.25),
                                      num_chains=100, num_temps=8,
                                      ess_min_frac=0.1)
    info = step(0)
    assert info["skipped"] and info["ess"] == 1.0
    assert torch.equal(raw.detach(), before) and not opt.state
    monkeypatch.undo()
    with pytest.raises(ValueError, match="must divide over the 4-device"):
        mtrain.make_ais_train_step(template, opt, np.zeros(8), num_chains=6,
                                   mesh=sharded.make_mesh(4, device="cpu"))(0)


@pytest.fixture()
def past_both_caps(monkeypatch, tmp_path):
    """The past-both-caps regime at toy size: width cap 1 (every pairwise
    model is wide), streaming cap n = 6, big-n path past n = 5; chain:8 has
    no exact training backend. Returns a --data file of 1 500 bit rows
    drawn exactly from the ground truth the CLI would draw."""
    monkeypatch.setenv("QCMRF_BIG_N_THRESHOLD", "5")
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    monkeypatch.setattr(capability, "STREAMING_MAX_N", 6)
    true = seeded(chain_mrf(8, device="cpu"), 0, 1.0)
    ids = msample.sample_exact(0, true, 1500)
    bits = (ids[:, None] >> torch.arange(7, -1, -1)) & 1
    path = tmp_path / "data.json"
    path.write_text(json.dumps(bits.tolist()))
    return ["--graph", "chain:8", "--data", str(path), "--platform", "cpu"]


def test_cli_past_caps_refusal_points_to_ais(past_both_caps, tmp_path):
    with pytest.raises(SystemExit) as e:
        train_cli.main(past_both_caps + ["--steps", "2", "--outdir",
                                         str(tmp_path / "o")])
    assert "--grad ais" in str(e.value)


def test_cli_grad_ais_trains_past_caps(past_both_caps, tmp_path):
    out = train_cli.main(past_both_caps + [
        "--steps", "25", "--lr", "0.1", "--grad", "ais", "--ais-chains",
        "96", "--ais-temps", "16", "--outdir", str(tmp_path / "o")])
    doc = json.load(open(out))
    assert "final_nll" not in doc and doc["final_ess"] > 9.6
    assert doc["ais_skipped_steps"] == 0
    data = np.asarray(json.load(open(past_both_caps[3])))
    template = MRF.create(doc["cliques"], device="cpu")
    mu_hat = mtrain.empirical_moments_from_bits(template, data).numpy()
    fit = elimination.clique_marginals(template.with_theta(
        np.asarray(doc["theta"], np.float32))).numpy()
    init = elimination.clique_marginals(template.with_theta(
        np.full(template.dimension, -0.5, np.float32))).numpy()
    assert np.abs(fit - mu_hat).max() < 0.5 * np.abs(init - mu_hat).max()


def test_cli_grad_ais_resume_continues_the_stream(past_both_caps, tmp_path):
    """Step s draws on Philox (data_seed + 2, s): 2 steps resumed for 2
    more land where 4 straight steps do (JAX replays its key stream on
    resume; the port does not)."""
    args = past_both_caps + ["--grad", "ais", "--ais-chains", "32",
                             "--ais-temps", "8", "--lr", "0.1"]
    straight = json.load(open(train_cli.main(
        args + ["--steps", "4", "--outdir", str(tmp_path / "a")])))
    train_cli.main(args + ["--steps", "2", "--outdir", str(tmp_path / "b")])
    resumed = json.load(open(train_cli.main(
        args + ["--steps", "4", "--resume", "--outdir",
                str(tmp_path / "b")])))
    np.testing.assert_array_equal(resumed["theta"], straight["theta"])
