"""The port's physical noise model, hardware engines and noise fits against
the JAX package on the CPU (slice 5). Deterministic pieces are held equal;
the emulated result files, which draw different random numbers in each
package, are held to the JAX pins' bars
(``tests/test_physical_noise.py::test_physical_subset_pin_all_combos``,
``tests/test_noise_fit.py::test_calibrated_reproduces_stored_tables``) on
the 2-graph subset (1, 4) of the scale-0.1 suite, with targets from JAX's
own emulation."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from qcmrf_tpu.evaluation import harness as jharness  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.models.suite import generate_suite as jgenerate  # noqa: E402
from qcmrf_tpu.noise import backends as jb  # noqa: E402
from qcmrf_tpu.noise import fit as jfit  # noqa: E402
from qcmrf_tpu.noise import physical as jphys  # noqa: E402

from qcmrf_tpu_torch.evaluation import harness  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.noise import backends as nb  # noqa: E402
from qcmrf_tpu_torch.noise import fit as nfit  # noqa: E402
from qcmrf_tpu_torch.noise import physical  # noqa: E402

CPU = "cpu"
COMBOS = [("torino", 0.1), ("sherbrooke", 0.1), ("ehningen", 0.1),
          ("torino", 0.25), ("torino", 0.5)]
SUBSET = (1, 4)  # edge + triangle: 4 and 5 qubits
SHOTS = 10_000


def sub_suite(suite):
    return dataclasses.replace(
        suite, graphs=[suite.graphs[j] for j in SUBSET],
        thetas={k: suite.thetas[j] for k, j in enumerate(SUBSET)})


def sub_model(model, cls):
    d = model.to_json()
    for k in ("lam", "var_drift", "anc_drift", "jitter"):
        d[k] = [d[k][j] for j in SUBSET]
    return cls.from_json(d)


def within_pin_bars(targets, got):
    """The JAX subset pin's bars, graph by graph."""
    for t, g in zip(targets, got):
        assert abs(t.mean_f - g.mean_f) <= 0.012, (t.graph, t.mean_f,
                                                   g.mean_f)
        assert abs(t.mean_delta - g.mean_delta) <= 0.03, (
            t.graph, t.mean_delta, g.mean_delta)
        assert abs(t.mean_kl - g.mean_kl) <= max(0.35 * t.mean_kl, 0.012), (
            t.graph, t.mean_kl, g.mean_kl)
        assert abs(t.std_f - g.std_f) <= max(0.6 * t.std_f, 0.008), (
            t.graph, t.std_f, g.std_f)


def both_harnesses(suite, jsuite, dists, norm=1):
    """The port's harness and JAX's on the same file: equal within 1e-6."""
    got = harness.evaluate_suite(suite, dists=dists, norm=norm, device=CPU)
    want = jharness.evaluate_suite(jsuite, dists=dists, norm=norm)
    for r, w in zip(got, want):
        for field in ("fidelities", "successes", "kls"):
            np.testing.assert_allclose(getattr(r, field), getattr(w, field),
                                       rtol=0, atol=1e-6)
    return got


@pytest.fixture(scope="module")
def subsets():
    """(port subset, JAX subset) of the scale-0.1 suite."""
    return sub_suite(generate_suite(0.1)), sub_suite(jgenerate(0.1))


@pytest.fixture(scope="module")
def synthetic(subsets):
    """A hardware file to fit: JAX's physical emulation of the subset
    under the torino 0.1 calibration, and its targets."""
    _, jsub = subsets
    jmodel = sub_model(jphys.load_physical("torino", 0.1),
                       jphys.PhysicalNoiseModel)
    out = jphys.run_physical_suite(jax.random.PRNGKey(0), jsub, jmodel,
                                   shots=SHOTS)
    targets = jharness.evaluate_suite(jsub, dists=out["quasi_dists"], norm=1)
    return out["quasi_dists"], targets


# --------------------------------------------------------------------------
# Calibrations and model mechanics
# --------------------------------------------------------------------------


def test_calibration_files_are_byte_equal_copies():
    jdir = jphys.CALIBRATION_DIR
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(physical.CALIBRATION_DIR))
    assert len(names) == 5
    for name in names:
        assert filecmp.cmp(os.path.join(jdir, name),
                           os.path.join(physical.CALIBRATION_DIR, name),
                           shallow=False), name


@pytest.mark.parametrize("backend,scale", COMBOS)
def test_stored_models_multipliers_and_errors_equal(backend, scale):
    jm = jphys.load_physical(backend, scale)
    m = physical.load_physical(backend, scale)
    assert m.to_json() == jm.to_json()
    assert physical.PhysicalNoiseModel.from_json(jm.to_json()) == m
    suite = jgenerate(scale)
    for g, C in enumerate(suite.graphs):
        mults = physical.rep_multipliers(m, g, 10)
        np.testing.assert_array_equal(mults, jphys.rep_multipliers(jm, g, 10))
        theta = suite.thetas[g][0]
        jmrf = JMRF.create(C, theta=theta)
        mrf = MRF.create(C, theta=theta, device=CPU)
        for u in (1.0, float(mults[3])):
            for fn, jfn in ((physical.true_errors, jphys.true_errors),
                            (physical.assumed_errors, jphys.assumed_errors)):
                assert [(e.e01, e.e10) for e in fn(mrf, m, g, u)] == \
                    [(e.e01, e.e10) for e in jfn(jmrf, jm, g, u)]


@pytest.mark.parametrize("g", range(7))
def test_expected_quasi_matches_jax(g):
    """The same pre-readout probabilities (JAX's density engine) through
    both pipelines, within 1e-6; and the predictive structure of the
    stored model holds on the port's lowering."""
    suite = jgenerate(0.1)
    jm, m = (jphys.load_physical("torino", 0.1),
             physical.load_physical("torino", 0.1))
    C = suite.graphs[g]
    theta = suite.thetas[g][1]
    jmrf = JMRF.create(C, theta=theta)
    mrf = MRF.create(C, theta=theta, device=CPU)
    probs = (jphys.gate_noisy_probs(jmrf, jm.lam[g] * 0.5)
             if g != 3 else np.random.RandomState(g).dirichlet(
                 np.ones(1 << 10)))
    mult = float(physical.rep_multipliers(m, g, 10)[1])
    want = jphys.expected_quasi(jmrf, jm, g, probs, mult)
    got = physical.expected_quasi(mrf, m, g, probs, mult)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    got_t = physical.expected_quasi(mrf, m, g, torch.from_numpy(probs), mult)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())
    ncx = sum(1 for x in physical.lowered_for_noise(mrf).gates
              if x.name == "cx")
    want_lam = float(np.clip(m.p2q * ncx, 0.0, physical.ANCHORS[-1]))
    assert abs(m.lam[g] - want_lam) < 1e-9
    assert physical.effective_cx_rates(suite, m, device=CPU)[g] == \
        jphys.effective_cx_rates(suite, jm)[g]


def test_model_json_roundtrip(tmp_path):
    m = physical.PhysicalNoiseModel(
        "torino", 0.1, 0.01, (1.0, 2.0), (0.1, 0.0), (-0.05, 0.2),
        (0.1, 0.0), p2q=0.02, var_e01=0.1)
    physical.save_physical(m, root=str(tmp_path))
    back = physical.load_physical("torino", 0.1, root=str(tmp_path))
    assert back == m
    jback = jphys.load_physical("torino", 0.1, root=str(tmp_path))
    assert jback.to_json() == m.to_json()
    d = m.to_json()
    del d["jitter"]
    with open(tmp_path / "old_0.25.json", "w") as f:
        json.dump(dict(d, name="old", scale=0.25), f)
    old = physical.load_physical("old", 0.25, root=str(tmp_path))
    assert old.jitter == (0.0, 0.0)
    with pytest.raises(FileNotFoundError, match="no stored physical"):
        physical.load_physical("nowhere", 0.1, root=str(tmp_path))


def test_knob_orthogonality():
    """var_drift leaves delta-hat alone, anc_drift the fidelity."""
    from qcmrf_tpu_torch.evaluation.metrics import fidelity

    theta = -np.abs(np.random.RandomState(4).randn(8)) * 0.3
    mrf = MRF.create([[0, 1], [1, 2]], theta=theta, device=CPU)
    probs = physical.gate_noisy_probs(mrf, 0.5)
    p = mrf.gibbs_probs().double().numpy()

    def stats(**kw):
        d = dict(name="t", scale=0.1, readout_sym=0.01, lam=(0.0,),
                 var_drift=(0.0,), anc_drift=(0.0,), jitter=(0.0,))
        d.update(kw)
        q = physical.expected_quasi(
            mrf, physical.PhysicalNoiseModel(**d), 0, probs).numpy()
        acc = np.clip(q[: 1 << mrf.n], 0, None)
        return (float(fidelity(p, acc / acc.sum())),
                float(q[: 1 << mrf.n].sum() / q.sum()))

    f0, d0 = stats()
    f_v, d_v = stats(var_drift=(0.2,))
    f_a, d_a = stats(anc_drift=(0.15,))
    assert f_v < f0 - 0.002 and abs(d_v - d0) < 1e-6
    assert d_a > d0 + 0.01 and abs(f_a - f0) < 1e-6


def test_surrogate_anchors_match_jax(subsets):
    """Every rep at every anchor budget in one density batch: the anchor
    tables equal JAX's within 1e-5, the interpolation within 1e-5."""
    sub, jsub = subsets
    thetas = sub.thetas[1][:3]
    surr = physical._GraphSurrogate(
        [MRF.create(sub.graphs[1], theta=t, device=CPU) for t in thetas])
    jsurr = jphys._GraphSurrogate(
        [JMRF.create(jsub.graphs[1], theta=t) for t in thetas])
    for r in range(3):
        np.testing.assert_allclose(surr.tables[r], jsurr.tables[r],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(surr.probs_one(r, 2.7),
                                   jsurr.probs_one(r, 2.7), rtol=0,
                                   atol=1e-5)
    m = sub_model(physical.load_physical("torino", 0.1),
                  physical.PhysicalNoiseModel)
    jm = sub_model(jphys.load_physical("torino", 0.1),
                   jphys.PhysicalNoiseModel)
    np.testing.assert_allclose(physical._expected_stats(surr, m, 1, 1.3),
                               jphys._expected_stats(jsurr, jm, 1, 1.3),
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# The three hardware engines on the subset, in distribution against JAX
# --------------------------------------------------------------------------

CAL = (jfit.GraphCalibration(0.12, 0.18, 0.0),
       jfit.GraphCalibration(0.07, 0.0, 0.05))


def _engine_files(engine, sub, jsub):
    if engine == "physical":
        m = sub_model(physical.load_physical("torino", 0.1),
                      physical.PhysicalNoiseModel)
        jm = sub_model(jphys.load_physical("torino", 0.1),
                       jphys.PhysicalNoiseModel)
        return (physical.run_physical_suite(17, sub, m, SHOTS, device=CPU),
                jphys.run_physical_suite(jax.random.PRNGKey(17), jsub, jm,
                                         SHOTS))
    if engine == "noisy":
        return (nb.run_noisy_suite(17, sub, nb.preset("torino"), SHOTS,
                                   device=CPU),
                jb.run_noisy_suite(jax.random.PRNGKey(17), jsub,
                                   jb.preset("torino"), SHOTS))
    cal = nfit.CalibratedNoiseModel(
        "t", 0.01, tuple(nfit.GraphCalibration(*dataclasses.astuple(c))
                         for c in CAL))
    jcal = jfit.CalibratedNoiseModel("t", 0.01, CAL)
    return (nb.run_calibrated_suite(17, sub, cal, SHOTS, device=CPU),
            jb.run_calibrated_suite(jax.random.PRNGKey(17), jsub, jcal,
                                    SHOTS))


@pytest.mark.parametrize("engine", ["physical", "noisy", "calibrated"])
def test_engine_matches_jax_in_distribution(subsets, engine):
    sub, jsub = subsets
    out, jout = _engine_files(engine, sub, jsub)
    assert set(out) == set(jout) == {"quasi_dists", "metadata"}
    assert len(out["quasi_dists"]) == 20
    assert set(out["metadata"][0]) == set(jout["metadata"][0])
    targets = jharness.evaluate_suite(jsub, dists=jout["quasi_dists"],
                                      norm=1)
    got = both_harnesses(sub, jsub, out["quasi_dists"])
    within_pin_bars(targets, got)
    again, _ = _engine_files(engine, sub, jsub)
    assert again["quasi_dists"] == out["quasi_dists"]


def test_unmitigated_preset_writes_counts(subsets):
    sub, jsub = subsets
    out = nb.run_noisy_suite(3, sub, nb.preset("depolarizing"), 2000,
                             device=CPU)
    assert isinstance(out, list) and len(out) == 20
    assert all(sum(c.values()) == 2000 for c in out)
    jout = jb.run_noisy_suite(jax.random.PRNGKey(3), jsub,
                              jb.preset("depolarizing"), 2000)
    got = both_harnesses(sub, jsub, out, norm=2000)
    want = jharness.evaluate_suite(jsub, dists=jout, norm=2000)
    for g, w in zip(got, want):
        assert abs(g.mean_delta - w.mean_delta) <= 0.03
        assert abs(g.mean_f - w.mean_f) <= 0.012


# --------------------------------------------------------------------------
# Fits
# --------------------------------------------------------------------------


def test_fit_depolarizing_rate_recovers_synthetic_rate():
    true_p = 0.0035
    suite, jsuite = generate_suite(0.1), jgenerate(0.1)
    target = nfit.expected_graph_success(suite, true_p, device=CPU)
    np.testing.assert_allclose(
        target, jfit.expected_graph_success(jsuite, true_p), rtol=0,
        atol=1e-6)
    p, rms = nfit.fit_depolarizing_rate(suite, None, 1.0, target=target,
                                        device=CPU)
    jp, jrms = jfit.fit_depolarizing_rate(jsuite, None, 1.0, target=target)
    assert abs(p - true_p) < 1e-4 and abs(jp - true_p) < 1e-4
    assert rms < 1e-4 and jrms < 1e-4


def test_fit_calibrated_reproduces_synthetic_file(subsets, synthetic):
    sub, jsub = subsets
    dists, targets = synthetic
    model = nfit.fit_calibrated("torino", sub, dists, 1.0, iters=20,
                                device=CPU)
    jmodel = jfit.fit_calibrated("torino", jsub, dists, 1.0, iters=20)
    assert len(model.graphs) == 2 and model.readout_sym == 0.01
    for c, jc in zip(model.graphs, jmodel.graphs):
        # the same targets, different refine draws: close, not equal
        assert abs(c.var_bias - jc.var_bias) < 0.05
        assert abs(c.anc_drop - jc.anc_drop) < 0.05
    out = nb.run_calibrated_suite(7, sub, model, SHOTS, device=CPU)
    got = both_harnesses(sub, jsub, out["quasi_dists"])
    for t, g in zip(targets, got):
        assert abs(t.mean_f - g.mean_f) <= 0.01, (t.mean_f, g.mean_f)
        assert abs(t.mean_delta - g.mean_delta) <= 0.03
    assert all(m["readout_mitigation_time"] > 0 for m in out["metadata"])


def test_calibrated_engine_shows_negative_quasiprobs():
    """torino's readout (0.01, inverted exactly) leaves negative
    quasi-probabilities on the suite's wide graphs in both packages (the
    subset's 16 and 32 keys all fill at these shots, in JAX's files too)."""
    graphs = (2, 3, 5)
    suite, jsuite = generate_suite(0.1), jgenerate(0.1)

    def pick(s):
        return dataclasses.replace(
            s, graphs=[s.graphs[j] for j in graphs],
            thetas={k: s.thetas[j][:3] for k, j in enumerate(graphs)})

    cal = nfit.CalibratedNoiseModel(
        "t", 0.01, (nfit.GraphCalibration(0.1, 0.2, 0.0),) * 3)
    jcal = jfit.CalibratedNoiseModel(
        "t", 0.01, (jfit.GraphCalibration(0.1, 0.2, 0.0),) * 3)
    out = nb.run_calibrated_suite(0, pick(suite), cal, SHOTS, device=CPU)
    jout = jb.run_calibrated_suite(jax.random.PRNGKey(0), pick(jsuite), jcal,
                                   SHOTS)
    for f in (out, jout):
        assert sum(v < 0 for d in f["quasi_dists"] for v in d.values()) > 0
    got = both_harnesses(pick(suite), pick(jsuite), out["quasi_dists"])
    want = jharness.evaluate_suite(pick(jsuite), dists=jout["quasi_dists"],
                                   norm=1)
    for g, w in zip(got, want):
        assert abs(g.mean_delta - w.mean_delta) <= 0.03
        assert abs(g.mean_f - w.mean_f) <= 0.012


def test_fit_physical_predictive_reproduces_synthetic_file(subsets,
                                                           synthetic):
    sub, jsub = subsets
    dists, targets = synthetic
    model = physical.fit_physical_predictive("torino", sub, dists, 1.0,
                                             device=CPU)
    jmodel = jphys.fit_physical_predictive("torino", jsub, dists, 1.0)
    # stages 1-3 see only the expected pipeline: the same fit as JAX's
    assert abs(model.p2q - jmodel.p2q) <= 1e-6 * jmodel.p2q
    np.testing.assert_allclose(model.lam, jmodel.lam, rtol=1e-6)
    assert abs(model.var_e01 - jmodel.var_e01) <= 1e-5
    assert float(np.median(np.abs(model.anc_drift))) <= 0.1
    out = physical.run_physical_suite(17, sub, model, SHOTS, device=CPU)
    got = both_harnesses(sub, jsub, out["quasi_dists"])
    within_pin_bars(targets, got)
