"""Port parity of the classical samplers (``models/sample.py``,
elimination's samplers, the chain kernel's plain version) and of the
sampling CLIs (``infer --query sample``, ``eval --mode gibbs|pam``,
``train``'s synthetic data), on the CPU with the JAX package as the oracle.

The port's draws come from ``torch.Generator`` and Philox streams where
JAX's come from its keys, so draws are held to the JAX package's laws
(exact probabilities, elimination's conditionals, its harness's
fidelities) within the stated tolerances, and bit for bit only between
two routes of the port that share a generator state."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from qcmrf_tpu.evaluation import harness as jharness  # noqa: E402
from qcmrf_tpu.models import elimination as jelim  # noqa: E402
from qcmrf_tpu.models import sample as jsample  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.runners import infer_cli as jinfer  # noqa: E402

from qcmrf_tpu_torch.evaluation import harness  # noqa: E402
from qcmrf_tpu_torch.models import capability, elimination  # noqa: E402
from qcmrf_tpu_torch.models import moments, sample  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.ops import gibbs_kernel  # noqa: E402
from qcmrf_tpu_torch.runners import eval as run_eval  # noqa: E402
from qcmrf_tpu_torch.runners import infer_cli, train_cli  # noqa: E402


def pair(cliques, seed, scale=1.0, beta=1.0, n=None):
    """(JAX model, port model) on theta = -|randn(RandomState(seed))| *
    scale, as the JAX package's sampler tests draw it."""
    d = sum(1 << len(C) for C in cliques)
    theta = (-np.abs(np.random.RandomState(seed).randn(d))
             * scale).astype(np.float32)
    return (JMRF.create(cliques, theta=theta, beta=beta, n=n),
            MRF.create(cliques, theta=theta, beta=beta, n=n, device="cpu"))


def exact_law(jm) -> np.ndarray:
    logits = np.asarray(jm.beta * jm.all_log_potentials(), np.float64)
    p = np.exp(logits - logits.max())
    return p / p.sum()


def tv(ids, p) -> float:
    emp = np.bincount(np.asarray(ids).reshape(-1),
                      minlength=len(p)) / np.asarray(ids).size
    return 0.5 * float(np.abs(emp - p).sum())


def ids_of(bits) -> np.ndarray:
    b = np.asarray(bits, np.int64)
    return (b << (b.shape[-1] - 1 - np.arange(b.shape[-1]))).sum(axis=-1)


# JAX's 3-variable model of test_mrf.py::test_sample_gibbs_distribution and
# 5-variable model of ::test_sample_gibbs_bits_distribution
CHAIN_MODELS = {"3-variable": ([[0, 1], [1, 2]], 6, 1.0),
                "5-variable": ([[0, 1], [1, 2, 3], [3, 4], [2, 0]], 13, 1.2)}


# ---- the chain kernel's plain version ----------------------------------------


@pytest.mark.parametrize("name", sorted(CHAIN_MODELS))
def test_gibbs_chains_reference_samples_the_exact_law(name):
    """1024 short chains (burn 50, 20 samples at thin 5): the pooled
    histogram within total variation 0.03 of JAX's exact law."""
    cl, seed, beta = CHAIN_MODELS[name]
    jm, m = pair(cl, seed, beta=beta)
    C = 1024
    bits = gibbs_kernel.gibbs_chains(
        7, m.cliques, m.n, m.theta.reshape(1, -1).repeat(C, 1), m.beta,
        num_samples=20, thin=5, burn=50)
    assert bits.shape == (C, 20, m.n) and bits.dtype == torch.int8
    assert tv(ids_of(bits.numpy()), exact_law(jm)) < 0.03


def test_gibbs_chain_streams_and_evidence():
    """A chain's draws depend on its seed and id only, not on its launch;
    a clamped site keeps its bit; the first sweep follows the stated
    Philox words and float32 arithmetic."""
    _, m = pair([[0, 1], [1, 2, 3], [3, 4], [2, 0]], 13, beta=1.2)
    rng = np.random.RandomState(0)
    thetas = torch.from_numpy(
        -np.abs(rng.randn(4, m.dimension)).astype(np.float32))
    both = gibbs_kernel.gibbs_chains(3, m.cliques, m.n, thetas, m.beta, 6, 2,
                                     4, chain_ids=[10, 11, 12, 13])
    for c in range(4):
        one = gibbs_kernel.gibbs_chains(3, m.cliques, m.n, thetas[c:c + 1],
                                        m.beta, 6, 2, 4, chain_ids=[10 + c])
        assert torch.equal(one[0], both[c])
    ev = torch.tensor([-1, 1, -1, 0, -1], dtype=torch.int8)
    clamped = gibbs_kernel.gibbs_chains(3, m.cliques, m.n, thetas, m.beta, 6,
                                        2, 4, evidence_mask=ev)
    assert bool((clamped[..., 1] == 1).all() and (clamped[..., 3] == 0).all())
    # one sweep by hand: the site thresholds and deltas in order
    keys = torch.arange(4)
    bits = gibbs_kernel.initial_bits(3, keys, m.n)
    t = gibbs_kernel.site_thresholds(3, keys, 0, m.n)
    for v in range(m.n):
        delta = gibbs_kernel.site_deltas(m.cliques, m.n, thetas, bits, v)
        bits[:, v] = (delta * m.beta >= t[:, v]).long()
    first = gibbs_kernel.gibbs_chains(3, m.cliques, m.n, thetas, m.beta, 1,
                                      1, 0)
    assert torch.equal(first[:, 0].long(), bits)


def test_chain_rows_are_the_states_after_burn_plus_i_thin():
    """JAX's xs[burn::thin]: sample i is the state after sweep burn + i *
    thin; partings finds nothing between equal runs and refuses rows taken
    one sweep early."""
    _, m = pair([[0, 1], [1, 2, 3], [3, 4], [2, 0]], 13, beta=1.2)
    thetas = m.theta[None].repeat(3, 1)
    args = (5, m.cliques, m.n, thetas, m.beta)
    rows = gibbs_kernel.gibbs_chains_reference(*args, 6, 3, 5)
    every = gibbs_kernel.gibbs_chains_reference(*args, 5 + 5 * 3 + 1, 1, 0)
    assert torch.equal(rows, every[:, 5::3])
    assert gibbs_kernel.partings(*args, 6, 3, 5, rows, rows) == []
    with pytest.raises(AssertionError, match="after sweeps"):
        gibbs_kernel.partings(*args, 6, 3, 5, every[:, 4:20:3], rows)


def test_first_decisions_start_from_the_clamped_state():
    """Two runs that part at sweep 0 are rebuilt from the clamped initial
    bits: the reported p1 is the clamped state's, not the free draw's."""
    cl = ((0, 1), (1, 2))
    th = torch.from_numpy(np.random.RandomState(1).randn(1, 8)
                          .astype(np.float32))
    free = gibbs_kernel.initial_bits(4, torch.arange(1), 3)[0]
    ev = torch.tensor([1 - int(free[0]), -1, 1 - int(free[2])],
                      dtype=torch.int8)
    want = gibbs_kernel.gibbs_chains_reference(4, cl, 3, th, 1.0, 3, 1, 0,
                                               evidence_mask=ev)
    got = want.clone()
    got[0, 0, 1] ^= 1
    [(c, s, v, u, p1)] = gibbs_kernel.first_decisions(
        4, cl, 3, th, 1.0, got, want, evidence_mask=ev)
    state = ev.long().clamp(min=0)[None]
    clamped = gibbs_kernel.site_probabilities(cl, 3, th, 1.0, state, 1)
    unclamped = gibbs_kernel.site_probabilities(cl, 3, th, 1.0, free[None], 1)
    assert (c, s, v) == (0, 0, 1) and p1 == float(clamped[0])
    assert p1 != float(unclamped[0])


def test_site_probabilities_equal_the_conditional():
    """p1 at every site and state is JAX's conditional p(x_v = 1 | rest),
    from its bits_site_delta_fn, within float32 rounding."""
    jm, m = pair([[0, 1], [1, 2, 3], [3, 4], [2, 0]], 13, beta=1.2)
    delta = jsample.bits_site_delta_fn(jm)
    states = torch.from_numpy(np.array(
        [[(x >> (m.n - 1 - v)) & 1 for v in range(m.n)]
         for x in range(1 << m.n)], np.int64))
    thetas = m.theta.reshape(1, -1).repeat(len(states), 1)
    for v in range(m.n):
        got = gibbs_kernel.site_probabilities(m.cliques, m.n, thetas, m.beta,
                                              states, v).numpy()
        want = [float(jax.nn.sigmoid(jm.beta * delta(
            v, jax.numpy.asarray(s, jax.numpy.int32))))
            for s in states.numpy()]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bits_site_delta_fn_equals_jax():
    """The local energy at every site and state equals JAX's
    bits_site_delta_fn within float32 rounding, for one state or a
    batch."""
    cl = [[0, 1], [1, 2, 3], [3, 4], [2, 0], [4, 0, 2]]
    jm, m = pair(cl, 17, scale=0.7, beta=1.3)
    jdelta = jsample.bits_site_delta_fn(jm)
    delta = sample.bits_site_delta_fn(m)
    states = np.array([[(x >> (m.n - 1 - v)) & 1 for v in range(m.n)]
                       for x in range(1 << m.n)], np.int32)
    for v in range(m.n):
        want = [float(jdelta(v, jax.numpy.asarray(s))) for s in states]
        got = delta(v, states)
        assert got.shape == (1 << m.n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert float(delta(v, states[5])) == float(got[5])


def test_sample_gibbs_is_one_chain():
    """The public samplers: one short run each, the C = 1 chain of the
    plain version on the seed, ids with variable 0 the most significant
    bit."""
    _, m = pair([[0, 1], [1, 2]], 6)
    ids = sample.sample_gibbs(5, m, 40, thin=2, burn=3)
    bits = sample.sample_gibbs_bits(5, m, 40, thin=2, burn=3)
    want = gibbs_kernel.gibbs_chains_reference(
        5, m.cliques, m.n, m.theta.reshape(1, -1), m.beta, 40, 2, 3)[0]
    assert ids.dtype == torch.int32 and ids.shape == (40,)
    assert bits.dtype == torch.int32 and bits.shape == (40, 3)
    assert torch.equal(bits, want.int())
    assert torch.equal(ids.long(), gibbs_kernel.ids_from_bits(bits))
    with pytest.raises(ValueError, match="n = 30"):
        sample.sample_gibbs(0, MRF.create([[0, 31]], device="cpu"), 2)


# ---- perturb-and-MAP ----------------------------------------------------------


def test_sample_pam_table_and_streaming_are_equal():
    """One generator state gives the same samples in both forms, on JAX's
    14-variable chain with two chords and on a 3-variable chain."""
    cl = [[i, i + 1] for i in range(13)] + [[0, 6], [3, 10]]
    for cliques, seed, num in ((cl, 11, 6), ([[0, 1], [1, 2]], 11, 12)):
        _, m = pair(cliques, seed, scale=0.6, beta=1.3)
        ids = sample.sample_pam(7, m, num)
        got = sample.sample_pam_streaming(7, m, num)
        want = (ids.long()[:, None] >> (m.n - 1 - torch.arange(m.n))) & 1
        assert ids.dtype == torch.int32 and got.dtype == torch.int32
        assert torch.equal(got, want.int())


def test_sample_pam_mode_is_the_map():
    """As test_mrf.py: PAM concentrates on the exact MAP state."""
    jm, m = pair([[0, 1], [1, 2]], 8, scale=2.0)
    s = sample.sample_pam(2, m, 4000).numpy()
    assert np.argmax(np.bincount(s, minlength=8)) == np.argmax(exact_law(jm))
    assert int(sample.map_state(m)) == int(np.argmax(exact_law(jm)))


def test_sample_pam_law_matches_jax():
    """At a large scale (JAX's 5-variable model, theta * 2, beta 0.6): the
    histogram of 40 000 PAM draws of the port within total variation 0.04
    of 40 000 of JAX's sample_pam on the same theta, while a PAM that
    leaves beta out (beta 1) or doubles its noise (beta 0.3, the same law)
    lies beyond that bound."""
    cl = CHAIN_MODELS["5-variable"][0]
    jm, m = pair(cl, 13, scale=2.0, beta=0.6)
    num = 40_000
    want = np.bincount(np.asarray(jsample.sample_pam(
        jax.random.PRNGKey(0), jm, num)), minlength=32) / num
    assert tv(sample.sample_pam(1, m, num).numpy(), want) < 0.04
    for beta in (1.0, 0.3):
        wrong = MRF.create(cl, theta=m.theta, beta=beta, device="cpu")
        assert tv(sample.sample_pam(1, wrong, num).numpy(), want) > 0.04


def test_elimination_pam_equals_the_table_form():
    """Max-product elimination and the table take the same Gumbel draws
    from one generator state, so they give the same samples."""
    _, m = pair([[i, i + 1] for i in range(7)] + [[0, 3]], 4, beta=1.3)
    got = elimination.sample_pam(9, m, 300)
    assert torch.equal(got, sample.sample_pam_streaming(9, m, 300))


def test_elimination_pam_chunked_equals_unchunked():
    """As test_elimination.py: the sample chunks do not change the draws;
    at n = 30 the samples are bits of the right shape."""
    _, m = pair([[i, i + 1] for i in range(7)], 4)
    full = elimination.sample_pam(5, m, 9)
    for cap in (1 << 2, 1 << 3):
        assert torch.equal(full, elimination.sample_pam(
            5, m, 9, _max_chunk_states=cap))
    _, m30 = pair([[i, i + 1] for i in range(29)], 8, scale=2.0)
    S = elimination.sample_pam(1, m30, 200)
    assert S.shape == (200, 30) and S.dtype == torch.int32
    assert set(np.unique(S.numpy())) <= {0, 1}


# ---- forward filtering, backward sampling --------------------------------------


def test_sample_exact_elim_matches_the_law():
    """test_elimination.py's model: 120 000 draws within total variation
    0.02 of JAX's exact law."""
    jm, m = pair([[0, 1], [1, 2, 3], [3, 4], [2, 5], [0, 4]], 5, beta=1.3)
    S = elimination.sample_exact_elim(7, m, 120_000)
    assert S.shape == (120_000, 6) and S.dtype == torch.int32
    assert tv(ids_of(S.numpy()), exact_law(jm)) < 0.02


def test_sample_exact_elim_chain30_marginals():
    """n = 30 with variable 29 in no clique: per-variable means within
    0.02 of JAX elimination's conditional_prob, the isolated one 1/2."""
    n = 30
    jm, m = pair([[i, i + 1] for i in range(n - 2)], 6, n=n)
    S = elimination.sample_exact_elim(2, m, 40_000).numpy()
    assert S.shape == (40_000, n)
    for v in (0, 1, 14, 28, 29):
        true = float(jelim.conditional_prob(jm, v, 1))
        assert abs(S[:, v].mean() - true) < 0.02, (v, true)


def test_sample_exact_elim_refuses_past_the_stored_floats():
    _, m = pair([[i, i + 1] for i in range(9)], 3)
    assert elimination.plan_table_floats(m.cliques, m.n) == 4 * 9 + 2
    with pytest.raises(ValueError, match="stores every elimination"):
        elimination.sample_exact_elim(0, m, 4, table_floats_cap=10)
    assert elimination.sample_exact_elim(0, m, 4).shape == (4, 10)


# ---- sample_conditional ----------------------------------------------------------


def cond_pair():
    """test_mrf.py's conditional model and evidence."""
    cl = [[i, i + 1] for i in range(7)] + [[0, 3, 6]]
    return pair(cl, 5, beta=1.3) + ({1: 1, 4: 0},)


def test_sample_conditional_exact_and_gibbs_laws():
    jm, m, ev = cond_pair()
    bits = sample.sample_conditional(0, m, 20_000, ev).numpy()
    assert (bits[:, 1] == 1).all() and (bits[:, 4] == 0).all()
    for v in (0, 3, 7):
        true = float(jelim.conditional_prob(jm, v, 1, ev))
        assert abs(bits[:, v].mean() - true) < 0.015, v
    g = sample.sample_conditional(1, m, 500, ev, method="gibbs").numpy()
    assert (g[:, 1] == 1).all() and (g[:, 4] == 0).all()
    true0 = float(jelim.conditional_prob(jm, 0, 1, ev))
    assert abs(g[:, 0].mean() - true0) < 0.05


def test_sample_conditional_pam_reembeds_and_clamps():
    """PAM re-embeds the reduced model's streaming samples bit for bit
    from one generator state; all-evidence rows are the evidence; an
    unknown method raises."""
    _, m, ev = cond_pair()
    red, _ = moments.reduce_evidence(m, ev)
    rb = sample.sample_pam_streaming(2, red, 8)
    pb = sample.sample_conditional(2, m, 8, ev, method="pam")
    free = [v for v in range(m.n) if v not in ev]
    assert torch.equal(pb[:, free], rb)
    assert bool((pb[:, 1] == 1).all() and (pb[:, 4] == 0).all())
    all_ev = {v: v % 2 for v in range(m.n)}
    ab = sample.sample_conditional(3, m, 3, all_ev)
    assert torch.equal(ab, torch.tensor([[v % 2 for v in range(m.n)]] * 3,
                                        dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown method"):
        sample.sample_conditional(0, m, 4, ev, method="bogus")


@pytest.mark.parametrize("method", ["exact", "gibbs", "pam"])
def test_sample_conditional_isolated_variable(method):
    """A variable in no clique draws an independent uniform bit under
    every method, the evidence clamped."""
    m = MRF.create([[0], [2]], theta=[-0.4, 0.0, -0.2, 0.0], n=3,
                   device="cpu")
    bits = sample.sample_conditional(3, m, 400, {2: 1}, method=method).numpy()
    assert (bits[:, 2] == 1).all()
    assert 0.4 < bits[:, 1].mean() < 0.6
    assert (bits[:, 0] != bits[:, 1]).any()
    if method == "pam":
        pb = sample.sample_conditional(4, m, 600, {0: 0, 2: 1},
                                       method="pam").numpy()
        assert (pb[:, 0] == 0).all() and (pb[:, 2] == 1).all()
        assert 0.4 < pb[:, 1].mean() < 0.6


def wide_and_large():
    cliques = [list(range(18))] + [[i, i + 1] for i in range(17, 49)]
    d = sum(1 << len(C) for C in cliques)
    return MRF.create(cliques, theta=-0.01 * np.ones(d), device="cpu")


def test_sample_conditional_wide_and_large():
    """n = 50 with an 18-variable clique: the chain serves it with the
    evidence clamped; PAM refuses with the limits spelled out."""
    m = wide_and_large()
    assert m.n == 50 and m.n > capability.STREAMING_MAX_N
    bits = sample.sample_conditional(1, m, 5, {0: 1, 30: 0},
                                     method="gibbs").numpy()
    assert bits.shape == (5, 50)
    assert (bits[:, 0] == 1).all() and (bits[:, 30] == 0).all()
    assert set(np.unique(bits)) <= {0, 1}
    with pytest.raises(ValueError, match="streaming argmax sweep"):
        sample.sample_conditional(0, m, 2, {}, method="pam")


def test_sample_conditional_exact_routes(monkeypatch):
    """Past 20 free variables exact draws come from elimination (n = 30,
    marginals within 0.02 of JAX's conditionals); a wide structure falls
    back to the table up to the hard cap and raises past it."""
    n = 30
    jm, m = pair([[i, i + 1] for i in range(n - 1)], 11)
    ev = {0: 1, 13: 0, 29: 1}
    bits = sample.sample_conditional(5, m, 30_000, ev).numpy()
    assert (bits[:, 0] == 1).all() and (bits[:, 13] == 0).all() \
        and (bits[:, 29] == 1).all()
    for v in (1, 7, 14, 28):
        true = float(jelim.conditional_prob(jm, v, 1, ev))
        assert abs(bits[:, v].mean() - true) < 0.02, (v, true)
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    _, m22 = pair([[i, i + 1] for i in range(21)], 12)
    assert sample.sample_conditional(0, m22, 8, {}).shape == (8, 22)
    _, m28 = pair([[i, i + 1] for i in range(27)], 12)
    with pytest.raises(ValueError, match="ancestral"):
        sample.sample_conditional(0, m28, 2, {})


# ---- infer --query sample ---------------------------------------------------------


def infer_both(argv):
    got = infer_cli.main(argv + ["--platform", "cpu"])
    want = jinfer.main(argv + ["--platform", "cpu"])
    for key in ("query", "n", "evidence", "backend", "method"):
        assert got[key] == want[key], key
    assert got.get("note") == want.get("note")
    assert np.shape(got["samples"]) == np.shape(want["samples"])
    return got


@pytest.mark.parametrize("method", ["exact", "gibbs", "pam"])
def test_infer_sample_methods(method):
    """Each method on a 12-variable chain with evidence: the same method,
    backend and shape as JAX's CLI, the evidence columns clamped."""
    r = infer_both(["--graph", "chain:12", "--theta-scale", "0.5",
                    "--query", "sample", "--method", method,
                    "--num-samples", "6", "--evidence", "2=1,7=0"])
    s = np.asarray(r["samples"])
    assert (s[:, 2] == 1).all() and (s[:, 7] == 0).all()


def test_infer_sample_routes_by_feasibility(monkeypatch):
    """test_infer_cli.py's routing cases: exact past the table cap stays
    exact on bounded reduced width (chain:48 with evidence, chain:40);
    with the width cap at 1 it goes to pam, with JAX's note."""
    from qcmrf_tpu.models import train as jtrain

    r = infer_both(["--graph", "chain:48", "--query", "sample", "--method",
                    "exact", "--num-samples", "3", "--evidence", "0=1"])
    assert r["method"] == "exact" and "note" not in r
    assert all(s[0] == 1 for s in r["samples"])
    r = infer_both(["--graph", "chain:40", "--query", "sample",
                    "--num-samples", "3"])
    assert r["method"] == "exact" and len(r["samples"][0]) == 40
    monkeypatch.setattr(jtrain, "_ELIM_WIDTH_CAP", 1)
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    r = infer_both(["--graph", "chain:40", "--query", "sample",
                    "--num-samples", "3"])
    assert r["method"] == "pam" and "routed to 'pam'" in r["note"]


def test_infer_sample_batch(tmp_path):
    """The batch form takes sample lines (JAX's allowed keys)."""
    path = tmp_path / "q.jsonl"
    path.write_text("".join(json.dumps(q) + "\n" for q in (
        {"query": "sample", "method": "gibbs", "num_samples": 3,
         "sample_seed": 2},
        {"query": "sample", "method": "pam", "evidence": {"0": 1},
         "num_samples": 4},
        {"query": "lnz"})))
    out = infer_cli.main(["--graph", "chain:6", "--theta-scale", "0.3",
                          "--platform", "cpu", "--queries", str(path)])
    assert [r["index"] for r in out] == [0, 1, 2]
    assert np.shape(out[0]["samples"]) == (3, 6) and out[0]["method"] == \
        "gibbs"
    assert all(s[0] == 1 for s in out[1]["samples"])


@pytest.mark.parametrize("ev", [{}, {0: 1}, {1: 0, 4: 1}, {0: 1, 1: 0, 2: 1},
                                {0: 0, 1: 1, 2: 0, 3: 1, 4: 0}, dict.fromkeys(
                                    range(6), 1)])
def test_reduce_structure_is_the_reduced_models(ev):
    """capability's structure (which explain and sample_method route on)
    is the structure of moments.reduce_evidence's model: fully observed
    cliques dropped, the isolated variable 5 kept by one [[0]] clique."""
    _, m = pair([[0, 1], [1, 2, 3], [3, 4], [2, 0]], 13, n=6)
    _, want = capability.reduce_structure(m.cliques, m.n, ev)
    red, _ = moments.reduce_evidence(m, ev)
    if red is None:
        assert want is None
    else:
        assert want == (tuple(tuple(C) for C in red.cliques), red.n)


@pytest.mark.parametrize("method", ["exact", "gibbs", "pam"])
def test_explain_selects_the_sampler_the_cli_runs(method, monkeypatch,
                                                 tmp_path):
    """``explain(...)["selected"]`` is ``sampler:<the CLI's method>``: it
    honours --method, and judges the evidence-reduced model (a K4 whose
    evidence leaves a K3, past the table cap but within the width cap,
    stays exact; without evidence exact goes to pam)."""
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 3)
    monkeypatch.setattr(capability, "EXACT_TABLE_HARD_N", 8)
    cl = [[i, j] for i in range(4) for j in range(i + 1, 4)] + \
        [[i, i + 1] for i in range(3, 12)]
    graph = tmp_path / "g.json"
    graph.write_text(json.dumps(cl))
    for ev in ("0=1", ""):
        argv = ["--graph", str(graph), "--theta-scale", "0.4", "--query",
                "sample", "--method", method, "--num-samples", "4",
                "--evidence", ev, "--platform", "cpu"]
        sel = infer_cli.main(argv + ["--explain"])["selected"]
        assert sel == "sampler:" + infer_cli.main(argv)["method"], (ev, sel)
        if method == "exact":
            assert sel == ("sampler:exact" if ev else "sampler:pam")


# ---- eval --mode gibbs|pam and train's synthetic data ----------------------------


def test_eval_pam_fidelity_matches_jax():
    """The scale-0.1 suite at 2 000 PAM samples a model: per-graph mean
    fidelity within 0.02 of JAX's harness; the success column is the
    reference's fixed norm (2 000 / 10 000)."""
    got = run_eval.main(["--mode", "pam", "--scale", "0.1", "--platform",
                         "cpu", "--num-samples", "2000"])
    want = jharness.evaluate_suite(jsuite.generate_suite(0.1), mode="pam",
                                   key=jax.random.PRNGKey(0),
                                   num_samples=2000)
    for g, w in zip(got, want):
        assert g.graph == w.graph
        assert abs(g.mean_f - w.mean_f) <= 0.02, (g.graph, g.mean_f, w.mean_f)
        assert g.successes == w.successes == [0.2] * 10


def test_eval_gibbs_keeps_the_fixed_norm():
    """Short chains (30 samples): delta-hat is 30 / 10 000, as the JAX
    harness prints it, and every fidelity lies in [0, 1]."""
    got = run_eval.main(["--mode", "gibbs", "--scale", "0.1", "--platform",
                         "cpu", "--num-samples", "30"])
    one = jsuite.ModelSuite(graphs=[jsuite.GRAPHS[2]],
                            thetas={0: jsuite.generate_suite(0.1).thetas[2]},
                            scale=0.1)
    want = jharness.evaluate_suite(one, mode="gibbs", num_samples=30)
    assert want[0].successes == got[2].successes == [0.003] * 10
    for r in got:
        assert len(r.fidelities) == 10
        assert all(0.0 <= f <= 1.0 for f in r.fidelities)


def test_eval_gibbs_samples_the_suite():
    """harness.evaluate_suite's gibbs mode: a graph's reps in one chain
    call, each rep's chain keyed by its suite index (so its draws do not
    depend on the batch); fidelity >= 0.97 at 300 samples on the suite's
    pair and triangle."""
    full = generate_suite(0.1)
    two = type(full)(graphs=[full.graphs[1], full.graphs[4]],
                     thetas={0: full.thetas[1], 1: full.thetas[4]},
                     scale=0.1)
    for r in harness.evaluate_suite(two, mode="gibbs", num_samples=300,
                                    seed=3, device="cpu"):
        assert r.mean_f >= 0.97, (r.graph, r.mean_f)
    th = torch.tensor(np.asarray(full.thetas[3], np.float32))
    C = tuple(tuple(c) for c in full.graphs[3])
    alone = gibbs_kernel.gibbs_chains(3, C, 5, th[4:5], 1.0, 40, 10, 10,
                                      chain_ids=[34])
    batch = gibbs_kernel.gibbs_chains(3, C, 5, th, 1.0, 40, 10, 10,
                                      chain_ids=range(30, 40))
    assert torch.equal(alone[0], batch[4])


def test_train_synthetic_data_past_n22(tmp_path, monkeypatch):
    """No --data: n = 24 draws ids from one Gibbs chain, and past the
    big-n threshold the bits come from elimination's PAM (bounded width)
    or the chain (wide)."""
    train_cli.main(["--graph", "chain:24", "--samples", "40", "--steps",
                    "1", "--platform", "cpu", "--outdir",
                    str(tmp_path / "a")])
    ids = json.loads((tmp_path / "a" / "data.json").read_text())
    assert len(ids) == 40 and all(0 <= x < 1 << 24 for x in ids)
    monkeypatch.setenv("QCMRF_BIG_N_THRESHOLD", "5")
    for name, graph in (("b", "chain:7"), ("c", "grid:2x4")):
        if name == "c":
            monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
        train_cli.main(["--graph", graph, "--samples", "30", "--steps", "1",
                        "--platform", "cpu", "--outdir", str(tmp_path / name)])
        bits = np.asarray(json.loads((tmp_path / name / "data.json")
                                     .read_text()))
        assert bits.shape[0] == 30 and set(np.unique(bits)) <= {0, 1}


@pytest.mark.parametrize("items", [1, 7, 32, 45, 70])
def test_warp_sum_is_the_kernels_order(items):
    """The plain version sums a site's differences as the kernel's warp
    does: lane l adds entries l, l + 32, ... in turn, then the 32 lane
    sums pairwise, halves first (numpy float32, written out)."""
    x = np.random.RandomState(items).randn(3, items).astype(np.float32)
    lanes = np.zeros((3, 32), np.float32)
    for i in range(items):
        lanes[:, i % 32] = lanes[:, i % 32] + x[:, i]
    while lanes.shape[1] > 1:
        half = lanes.shape[1] // 2
        lanes = lanes[:, :half] + lanes[:, half:]
    got = gibbs_kernel.warp_sum(torch.from_numpy(x))
    assert torch.equal(got, torch.from_numpy(lanes[:, 0]))


# ---- the chain kernel's decision rule, tables and butterfly ----------------


def _neighbours(t: torch.Tensor, steps: int) -> torch.Tensor:
    """float32 ``t`` moved ``steps`` floats up (or down, steps < 0)."""
    to = torch.full_like(t, float("inf") if steps > 0 else float("-inf"))
    for _ in range(abs(steps)):
        t = torch.nextafter(t, to)
    return t


@pytest.mark.parametrize("beta", [0.0, 0.6, 1.0, 2.5])
def test_threshold_rule_agrees_with_p1_within_2_ulp(beta):
    """x = beta * delta >= T(u) against the float32 test u < 1 / (1 +
    exp(-x)), over u = k * 2^-24 (k = 0, the smallest, the largest, 0.5
    and random) and x at T(u) and its neighbours, 0, -0, past 88 (where
    exp overflows) and the float32 extremes: the two differ only where u
    lies within 2 ulp of p1; at beta = 0 the rule is u < 0.5 exactly."""
    rng = np.random.RandomState(int(beta * 10))
    ks = np.unique(np.concatenate([
        np.arange(0, 64), (1 << 24) - 1 - np.arange(64),
        [1 << 23, (1 << 23) - 1, (1 << 23) + 1],
        rng.randint(0, 1 << 24, 4000)]))
    k = torch.from_numpy(ks.astype(np.int64))
    T = gibbs_kernel.thresholds_of(k)
    u = k.to(torch.float32) * 2.0 ** -24
    fixed = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 16.6, -16.6, 17.0,
                          -17.0, 87.9, -87.9, 88.8, -88.8, 100.0, -100.0,
                          1e30, -1e30, 3.4028235e38, -3.4028235e38])
    xs = [fixed[None].expand(len(k), -1)]
    if beta:
        xs += [(_neighbours(T, s) / beta)[:, None] for s in range(-3, 4)]
    x = torch.cat(xs, dim=1)
    xb = x * beta
    new = xb >= T[:, None]
    p1 = torch.reciprocal(1 + torch.exp(-xb))
    old = u[:, None] < p1
    for i, j in torch.nonzero(new != old).tolist():
        assert gibbs_kernel.within_ulps(float(u[i]), float(p1[i, j])), (
            int(k[i]), float(x[i, j]), float(p1[i, j]))
    assert bool(torch.isfinite(T).all()) and float(T[0]) < -3e38
    if beta == 0.0:
        assert torch.equal(new, (u < 0.5)[:, None].expand_as(new))
    else:
        # the rule is x > logit(u) exactly: T(u) and the float below it
        assert bool(((_neighbours(T, -1) * 1.0) < T).all())
        assert bool((T.double() > torch.log(k.double())
                     - torch.log(((1 << 24) - k).double())).all())


def _suite_models():
    suite = generate_suite(0.1)
    return [(tuple(tuple(int(v) for v in c) for c in C),
             max(v for c in C for v in c) + 1,
             torch.tensor(np.asarray(suite.thetas[j], np.float32)))
            for j, C in enumerate(suite.graphs)]


def _wide_models():
    """Past 64 variables (the state in shared memory), clamped sites, an
    item of 7 other slots and a site of 40 items; and a complete graph
    whose sites hold 11 items (not a power of 2)."""
    rng = np.random.RandomState(5)
    cl = (tuple((i, i + 1) for i in range(69)) + ((1, 30, 50, 66, 67, 68,
                                                   69, 2),)
          + tuple((7, v) for v in range(20, 59)))
    d = sum(1 << len(c) for c in cl)
    ev = [-1] * 70
    ev[10], ev[61] = 1, 0
    k12 = tuple((i, j) for i in range(12) for j in range(i + 1, 12))
    return [(cl, 70, torch.from_numpy(
                (rng.randn(3, d) * 0.4).astype(np.float32)), ev),
            (k12, 12, torch.from_numpy(
                (rng.randn(2, 4 * len(k12)) * 0.3).astype(np.float32)))]


@pytest.mark.parametrize("case", ["suite", "wide"])
def test_multi_reference_equals_the_per_structure_references(case):
    """gibbs_chains_multi of several structures on CPU tensors equals each
    structure's plain version (gibbs_chains_reference) row for row, each
    chain keyed by its index over the launch, and the evidence of each
    structure clamps its own sites."""
    models = _suite_models() if case == "suite" else _wide_models()
    rows = gibbs_kernel.gibbs_chains_multi(9, models, 1.1, 3, 2, 2)
    c0 = 0
    for m, got in zip(models, rows):
        C = m[2].shape[0]
        want = gibbs_kernel.gibbs_chains_reference(
            9, m[0], m[1], m[2], 1.1, 3, 2, 2,
            evidence_mask=m[3] if len(m) > 3 else None,
            chain_ids=range(c0, c0 + C))
        assert got.shape == want.shape and torch.equal(got, want)
        c0 += C
    if case == "wide":
        assert not gibbs_kernel.chain_pack(
            ((models[0][0], 70, tuple(models[0][3])),)).reg_state
        assert bool((rows[0][..., 10] == 1).all()
                    and (rows[0][..., 61] == 0).all())


def test_chain_pack_tables():
    """The packed tables of the suite's triangle pair [[0,1,2],[2,3,4]]:
    a meta row a free site with its butterfly levels, one record an item
    with its D entries, the other slots by increasing bit in the slot
    word, packed 6 bits each on the word path; the fast loop's lane
    table."""
    cl = ((0, 1, 2), (2, 3, 4))
    pack = gibbs_kernel.chain_pack(((cl, 5, (-1, -1, -1, 1, -1)),))
    assert pack.reg_state
    assert pack.structs[0].tolist() == [5, 4, 0, 20, 0, 0, 5, 0,
                                        1 | 2 << 4 | 1 << 8, 0, 0, 0]
    sites = [(int(r), int(t) & 0xFFFFFF, int(t) >> 24)
             for r, t in pack.meta[:5]]
    assert sites == [(0, 0, 0), (1, 1, 0), (2, 2, 1), (4, 4, 0), (5, 0, 0)]
    # site 2's items: slot 2 of (0, 1, 2), then slot 0 of (2, 3, 4)
    x, off, z, w = pack.records[2].tolist()
    assert (x, off, z & 0xFF, z >> 8 & 0xFF, w) == (8, 0, 2, 0, 1 | 0 << 6)
    x, off, z, w = pack.records[3].tolist()
    assert (x, off, z & 0xFF, z >> 8 & 0xFF, w) == (12, 8, 2, 2, 4 | 3 << 6)
    # the fast loop's lane table (K = 1, C = 2): lane l takes item l mod 2
    # of a site, the zero entry past its items, and the site's bit; the 4
    # free sites repeated for the 8 sweeps of a threshold group
    lanes = pack.lanes.reshape(32, 32, 4)
    assert np.array_equal(lanes, np.tile(lanes[:4], (8, 1, 1)))
    assert lanes[2, ::2].tolist() == [[8, 1 | 0 << 6, 4, 0]] * 16
    assert lanes[2, 1::2].tolist() == [[12, 4 | 3 << 6, 4, 0]] * 16
    assert lanes[0, 1::2].tolist() == [[20, 63 | 63 << 6, 1, 0]] * 16


@pytest.mark.parametrize("items", [0, 1, 2, 3, 5, 11, 16, 17, 26, 32, 33,
                                   45, 70])
def test_shallow_butterfly_equals_warp_sum(items):
    """The kernel's lane sum (item l mod 2^k on lane l, k levels) equals
    warp_sum, the full 5-level butterfly, to the bit."""
    x = torch.from_numpy(np.random.RandomState(items).randn(
        5, items).astype(np.float32))
    x[:, :items // 3] *= 1e-6
    assert torch.equal(gibbs_kernel.lane_sum(x), gibbs_kernel.warp_sum(x))


def test_eval_gibbs_is_one_chain_call(monkeypatch):
    """evaluate_suite's gibbs mode runs the suite's 70 chains in one
    gibbs_chains_multi call, each keyed by its suite index: its counts
    equal the per-graph route's (each graph's reps through the plain
    version with chain ids idx .. idx + reps), at 12 samples."""
    calls = []
    real = gibbs_kernel.gibbs_chains_multi

    def spy(*args, **kwargs):
        calls.append(len(args[1]))
        return real(*args, **kwargs)

    monkeypatch.setattr(gibbs_kernel, "gibbs_chains_multi", spy)
    suite = generate_suite(0.1)
    res = harness.evaluate_suite(suite, mode="gibbs", num_samples=12,
                                 seed=4, device="cpu")
    assert calls == [7] and len(res) == 7
    got = harness._gibbs_counts(suite, 12, 4, "cpu")
    idx = 0
    for (cl, n, th), counts in zip(_suite_models(), got):
        bits = gibbs_kernel.gibbs_chains_reference(
            4, cl, n, th, 1.0, 12, 10, 10,
            chain_ids=range(idx, idx + th.shape[0]))
        ids = gibbs_kernel.ids_from_bits(bits).numpy()
        want = np.stack([np.bincount(r, minlength=1 << n) for r in ids])
        assert np.array_equal(counts, want)
        idx += th.shape[0]
