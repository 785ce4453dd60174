"""Port parity of the bounded-width backend and the capability matrix: the
port's ``models/elimination.py`` and ``models/capability.py`` against the
JAX package's on the same numpy-seeded models, on the CPU. Planner numbers
are equal; log-domain values agree within 1e-5 (float32 factor tables
summed in another order); MAP bits are equal."""

import json

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.models import capability as jcapability  # noqa: E402
from qcmrf_tpu.models import elimination as jelim  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402

from qcmrf_tpu_torch.models import capability, elimination  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.runners import infer_cli  # noqa: E402

TOL = 1e-5


def _complete(n):
    return [[i, j] for i in range(n) for j in range(i + 1, n)]


STRUCTURES = {
    "chain8": [[i, i + 1] for i in range(7)],
    "grid3x4": [[0, 1], [0, 4], [1, 2], [1, 5], [2, 3], [2, 6], [3, 7],
                [4, 5], [4, 8], [5, 6], [5, 9], [6, 7], [6, 10], [7, 11],
                [8, 9], [9, 10], [10, 11]],
    "K7": _complete(7),
    "star9": [[0, v] for v in range(1, 9)],
    "size3": [[0, 1, 2], [2, 3, 4], [4, 5, 0], [1, 3, 5], [5, 6, 7]],
    "mixed": [[0, 1, 2], [2, 3, 4, 5], [5, 6, 7, 8, 9], [9, 0], [3, 7]],
}
EVIDENCE = ({}, {0: 1}, {1: 0, 3: 1})


def models(name, seed=3, beta=1.3):
    """(JAX model, port model) on one numpy-seeded theta of mixed sign."""
    cliques = STRUCTURES[name]
    d = sum(1 << len(C) for C in cliques)
    theta = (np.random.RandomState(seed).randn(d) * 0.5).astype(np.float32)
    return (JMRF.create(cliques, theta=theta, beta=beta),
            MRF.create(cliques, theta=theta, beta=beta, device="cpu"))


def n_of(cliques):
    return 1 + max(v for C in cliques for v in C)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_planner_numbers_are_equal(name):
    cl = STRUCTURES[name]
    n = n_of(cl)
    assert elimination.induced_width(cl, n) == jelim.induced_width(cl, n)
    assert (elimination.plan_table_floats(cl, n)
            == jelim.plan_table_floats(cl, n))
    assert elimination.min_degree_order(cl, n) == jelim.min_degree_order(cl,
                                                                        n)
    for mv in ([0], [0, 1, 2], list(range(1, n, 2))):
        for ev in EVIDENCE:
            assert (elimination.mmap_width(cl, n, mv, ev)
                    == jelim.mmap_width(cl, n, mv, ev)), (mv, ev)


def test_complete_graph_width_routes_to_streaming():
    """K27's width 27 passes the cap of 25; the port keeps JAX's caps."""
    cl = _complete(27)
    assert elimination.induced_width(cl, 27) == 27
    for cap in ("ELIM_WIDTH_CAP", "STREAMING_MAX_N", "MMAP_WIDTH_CAP",
                "MMAP_ENUM_MAX_VARS", "EXACT_TABLE_HARD_N",
                "SAMPLER_TABLE_FLOATS_CAP", "CIRCUIT_SAMPLER_MAX_N"):
        assert getattr(capability, cap) == getattr(jcapability, cap), cap


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_values_match_jax(name):
    jm, m = models(name)
    np.testing.assert_allclose(float(elimination.log_partition(m)),
                               float(jelim.log_partition(jm)), atol=TOL)
    for ev in EVIDENCE:
        np.testing.assert_allclose(
            float(elimination.log_partition_clamped(m, ev)),
            float(jelim.log_partition_clamped(jm, ev)), atol=TOL)
        for v, b in ((2, 1), (1, 0)):
            np.testing.assert_allclose(
                float(elimination.conditional_prob(m, v, b, ev)),
                float(jelim.conditional_prob(jm, v, b, ev)), atol=TOL)
    np.testing.assert_allclose(elimination.clique_marginals(m).numpy(),
                               np.asarray(jelim.clique_marginals(jm)),
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_map_and_marginal_map_match_jax(name):
    jm, m = models(name, seed=7)
    np.testing.assert_array_equal(elimination.map_state_bits(m).numpy(),
                                  np.asarray(jelim.map_state_bits(jm)))
    for mv in ([0, 1, 2], [1, 4], [2]):
        for ev in EVIDENCE:
            got, gval = elimination.marginal_map(m, mv, ev)
            want, wval = jelim.marginal_map(jm, mv, ev)
            assert got == want, (mv, ev)
            assert abs(gval - wval) <= TOL, (mv, ev)


def test_marginals_sum_to_one_per_clique_and_grad_is_clean():
    _, m = models("mixed")
    mu = elimination.clique_marginals(m)
    off = 0
    for C in m.cliques:
        assert abs(float(mu[off: off + (1 << len(C))].sum()) - 1.0) < TOL
        off += 1 << len(C)
    assert not m.theta.requires_grad and mu.grad_fn is None


def test_errors_match_jax():
    jm, m = models("chain8")
    for bad in ({8: 1}, {0: 2}):
        with pytest.raises(ValueError):
            elimination.log_partition_clamped(m, bad)
        with pytest.raises(ValueError):
            jelim.log_partition_clamped(jm, bad)
    with pytest.raises(ValueError, match="out of range"):
        elimination.marginal_map(m, [9])
    jm, m = models("star9")
    with pytest.raises(ValueError, match="width_cap"):
        elimination.marginal_map(m, list(range(1, 9)), width_cap=4)
    with pytest.raises(ValueError, match="stores every elimination"):
        elimination.sample_exact_elim(0, m, 4, table_floats_cap=10)
    with pytest.raises(ValueError, match="stores every elimination"):
        jelim.sample_exact_elim(jax.random.PRNGKey(0), jm, 4,
                                table_floats_cap=10)


QUERIES = ("lnz", "prob", "map", "mmap", "marginals", "sample")


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_explain_equals_jax(name):
    cl = STRUCTURES[name]
    n = n_of(cl)
    for query in QUERIES:
        for ev in EVIDENCE:
            for mesh in (False, True):
                kw = dict(evidence=ev, query=query, max_vars=[0, 2, 5],
                          mesh=mesh)
                assert (capability.explain(cl, n, **kw)
                        == jcapability.explain(cl, n, **kw)), (query, ev)


@pytest.mark.parametrize("cap", [25, 1])
@pytest.mark.parametrize("name", ["star9", "K7", "size3"])
def test_explain_selects_what_the_cli_runs(name, cap, monkeypatch,
                                          tmp_path):
    """The backend ``--explain`` selects is the one the CLI reports, on
    both routes (a cap of 1 sends every structure to streaming)."""
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", cap)
    graph = tmp_path / "g.json"
    graph.write_text(json.dumps(STRUCTURES[name]))
    base = ["--graph", str(graph), "--theta-scale", "0.4", "--platform",
            "cpu", "--max-vars", "0,2,5", "--of", "2=1"]
    for query in ("lnz", "prob", "map", "mmap", "marginals"):
        for ev in ("", "1=0"):
            argv = base + ["--query", query, "--evidence", ev]
            want = infer_cli.main(argv + ["--explain"])["selected"]
            assert infer_cli.main(argv)["backend"] == want, (query, ev)


def test_explain_pam_is_selected_only_where_feasible():
    """Past both caps (width > 25 and n > 47) no sampler is feasible, and
    none is selected (the JAX package selects 'sampler:pam' there)."""
    cl = _complete(48)
    rep = capability.explain(cl, 48, query="sample")
    assert not rep["backends"]["sampler:pam"]["feasible"]
    assert not rep["backends"]["sampler:exact"]["feasible"]
    assert rep["selected"] is None
    assert jcapability.explain(cl, 48, query="sample")["selected"] == \
        "sampler:pam"
