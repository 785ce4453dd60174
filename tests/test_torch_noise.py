"""Noise emulation of the port against the JAX package on the CPU: the
channels, mitigation, the density engine and the preset backends (slice
5). JAX is the oracle, fed the same numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.circuits.compiler import compile_qcmrf as jcompile  # noqa: E402
from qcmrf_tpu.circuits.ir import Circuit as JCircuit  # noqa: E402
from qcmrf_tpu.circuits.lower import lower as jlower  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.models.suite import generate_suite as jgenerate  # noqa: E402
from qcmrf_tpu.noise import backends as jb  # noqa: E402
from qcmrf_tpu.noise import channels as jch  # noqa: E402
from qcmrf_tpu.noise import density as jden  # noqa: E402
from qcmrf_tpu.noise import fit as jfit  # noqa: E402
from qcmrf_tpu.noise import mitigation as jmit  # noqa: E402
from qcmrf_tpu.noise import physical as jphys  # noqa: E402

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf  # noqa: E402
from qcmrf_tpu_torch.circuits.ir import Circuit  # noqa: E402
from qcmrf_tpu_torch.circuits.lower import lower  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.noise import backends as nb  # noqa: E402
from qcmrf_tpu_torch.noise import channels as ch  # noqa: E402
from qcmrf_tpu_torch.noise import density  # noqa: E402
from qcmrf_tpu_torch.noise import mitigation  # noqa: E402
from qcmrf_tpu_torch.noise import physical  # noqa: E402
from qcmrf_tpu_torch.sim import dense  # noqa: E402

CPU = "cpu"


def rand_theta(cliques, seed, scale=0.3):
    dim = sum(1 << len(C) for C in cliques)
    return -np.abs(np.random.RandomState(seed).randn(dim)) * scale


def both_mrfs(cliques, seed=0, scale=0.3):
    theta = rand_theta(cliques, seed, scale)
    return (JMRF.create(cliques, theta=theta),
            MRF.create(cliques, theta=theta, device=CPU))


ERRS = [ch.ReadoutError(0.02, 0.05), ch.ReadoutError(0.0, 0.03),
        ch.ReadoutError(0.012, 0.028), ch.ReadoutError(0.1, 0.0)]


def jerrs(errs):
    return [jch.ReadoutError(e.e01, e.e10) for e in errs]


# --------------------------------------------------------------------------
# Channels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("invert", [False, True])
def test_readout_confusion_matches_jax(dtype, tol, invert):
    rng = np.random.RandomState(0)
    p = rng.dirichlet(np.ones(32)).astype(dtype)
    bits = [0, 2, 3, 4]
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jch.apply_readout_confusion(
            jnp.asarray(p), jerrs(ERRS), 5, measured_bits=bits,
            invert=invert))
    got = ch.apply_readout_confusion(torch.from_numpy(p), ERRS, 5,
                                     measured_bits=bits, invert=invert)
    assert got.dtype == torch.from_numpy(p).dtype and want.dtype == dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(
        ch.apply_bit_matrix(torch.from_numpy(p), ERRS[0].confusion, 1,
                            5).numpy(),
        np.asarray(jch.apply_bit_matrix(jnp.asarray(p), ERRS[0].confusion,
                                        1, 5)), rtol=0, atol=1e-6)


def test_confusion_roundtrip_and_matrices():
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(16)))
    errs = [ch.ReadoutError(0.02, 0.05)] * 4
    noisy = ch.apply_readout_confusion(p, errs, 4)
    assert abs(float(noisy.sum()) - 1.0) < 1e-12
    back = ch.apply_readout_confusion(noisy, errs, 4, invert=True)
    np.testing.assert_allclose(back.numpy(), p.numpy(), atol=1e-12)
    for e in ERRS:
        je = jch.ReadoutError(e.e01, e.e10)
        assert e.confusion.dtype == np.float64
        np.testing.assert_array_equal(e.confusion, je.confusion)
        np.testing.assert_array_equal(e.inverse, je.inverse)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_depolarize_and_overhead_match_jax(dtype, tol):
    p = np.random.RandomState(1).dirichlet(np.ones(64)).astype(dtype)
    for rate, gates in ((0.0, 100), (1.0, 1), (0.01, 37), (0.002, 300)):
        with jax.enable_x64(dtype == np.float64):
            want = np.asarray(jch.depolarize(jnp.asarray(p), rate, gates))
        got = ch.depolarize(torch.from_numpy(p), rate, gates)
        assert got.dtype == torch.from_numpy(p).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    for width in (3, 6, 10):
        errs = [ch.ReadoutError(0.012, 0.028)] * width
        assert ch.mitigation_overhead(errs) == jch.mitigation_overhead(
            jerrs(errs))


# --------------------------------------------------------------------------
# Mitigation
# --------------------------------------------------------------------------


def test_mitigate_counts_matches_jax():
    rng = np.random.RandomState(2)
    width = 6
    law = rng.dirichlet(np.full(1 << (width - 1), 0.2))  # sparse support
    keys = rng.choice(1 << (width - 1), size=3000, p=law) << 1  # bit 0 = 0
    vals, cnts = np.unique(keys, return_counts=True)
    counts = {format(int(v), f"0{width}b"): int(c)
              for v, c in zip(vals, cnts)}
    bits = [1, 2, 3, 4, 5]
    errs = [ch.ReadoutError(0.012, 0.028)] * 3 + \
        [ch.ReadoutError(0.05, 0.01)] * 2
    q, meta = mitigation.mitigate_counts(counts, errs, width,
                                         measured_bits=bits)
    jq, jmeta = jmit.mitigate_counts(counts, jerrs(errs), width,
                                     measured_bits=bits)
    assert q.keys() == jq.keys()
    np.testing.assert_allclose([q[k] for k in jq], list(jq.values()),
                               rtol=0, atol=1e-12)
    assert any(v < 0 for v in q.values())
    assert abs(sum(q.values()) - 1.0) < 1e-12
    assert meta.keys() == jmeta.keys()
    for k in ("shots", "circuit_metadata", "readout_mitigation_overhead"):
        assert meta[k] == jmeta[k], k
    assert meta["readout_mitigation_time"] > 0
    assert "qcmrf_tpu_torch" in meta["warning"]
    assert mitigation.build_result_file([q], [meta]) == {
        "quasi_dists": [q], "metadata": [meta]}


# --------------------------------------------------------------------------
# Density engine
# --------------------------------------------------------------------------


def test_density_matches_statevector_noiseless():
    jm, m = both_mrfs([[0, 1], [1, 2]], seed=1)
    lc = lower(compile_qcmrf(m))
    got = density.noisy_clbit_probs(lc, 0.0, 0.0, dtype=torch.complex128,
                                    device=CPU)
    want = dense.simulate_probs(lc, device=CPU)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    jwant = jden.noisy_clbit_probs(jlower(jcompile(jm)), 0.0, 0.0,
                                   dtype=np.complex128)
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-12)


def _zoo(C):
    c = C(3, num_clbits=3)
    c.sx(0).x(1).rz(0.7, 2).cx(0, 2).sx(2).cx(2, 1).rz(-1.3, 0).x(2)
    c.h(1).sxdg(0).rz(0.4, 1).rz(0.2, 1).cx(1, 0)
    for q in range(3):
        c.measure(q, q)
    return c


@pytest.mark.parametrize("p1q,p2q", [(0.0, 0.0), (0.01, 0.05)])
def test_density_gate_zoo_matches_jax(p1q, p2q):
    """Every lowered-basis gate (x, sx, rz, cx) and h / sxdg against the
    dense engine (noiseless) and JAX's engine (noisy)."""
    c, jc = _zoo(Circuit), _zoo(JCircuit)
    got = density.noisy_clbit_probs(c, p1q, p2q, dtype=torch.complex128,
                                    device=CPU)
    want = jden.noisy_clbit_probs(jc, p1q, p2q, dtype=np.complex128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    rho = density.evolve_density(c, p1q, p2q, dtype=torch.complex128,
                                 device=CPU)
    jrho = jden.evolve_density(jc, p1q, p2q, dtype=np.complex128)
    np.testing.assert_allclose(rho.numpy(), jrho, rtol=0, atol=1e-12)
    if p2q == 0:
        sv = dense.outcome_probs(c, dense.run_statevector(
            c, dtype=torch.complex128, device=CPU))
        np.testing.assert_allclose(got.numpy(), sv.numpy(), atol=1e-7)


def test_rates_override_matches_jax():
    jm, m = both_mrfs([[0, 1]], seed=5)
    lc, jlc = lower(compile_qcmrf(m)), jlower(jcompile(jm))
    rates = {"cx": 0.03, "sx": 0.004}
    got = density.noisy_clbit_probs(lc, 0.001, 0.01, rates=rates,
                                    device=CPU)
    want = jden.noisy_clbit_probs(jlc, 0.001, 0.01, rates=rates)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_depolarize_limits_and_invariants():
    rng = np.random.RandomState(0)
    a = rng.randn(16, 16) + 1j * rng.randn(16, 16)
    rho = a @ a.conj().T
    rho /= np.trace(rho).real
    t = torch.from_numpy(rho)
    out = density.depolarize_qubits(t.clone(), [0, 3], 1.0, 4).numpy()
    assert np.isclose(np.trace(out).real, 1.0, atol=1e-12)
    v = out.reshape(2, 2, 2, 2, 2, 2, 2, 2)
    marg = np.einsum("abcdxbcy->adxy", v).reshape(4, 4)
    np.testing.assert_allclose(marg, np.eye(4) / 4, atol=1e-9)
    out0 = density.depolarize_qubits(t.clone(), [1], 0.0, 4).numpy()
    np.testing.assert_allclose(out0, rho, atol=0)
    out2 = density.depolarize_qubits(t.clone(), [1, 2], 0.37, 4).numpy()
    assert np.isclose(np.trace(out2).real, 1.0, atol=1e-12)
    np.testing.assert_allclose(out2, out2.conj().T, atol=1e-12)
    want = jden.depolarize_qubits(rho.copy(), [1, 2], 0.37, 4)
    np.testing.assert_allclose(out2, want, atol=1e-14)
    # one rate a batch row
    batch = torch.stack([t, t])
    density.depolarize_qubits(batch, [2], [0.0, 0.2], 4)
    np.testing.assert_allclose(batch[0].numpy(), rho, atol=0)
    np.testing.assert_allclose(
        batch[1].numpy(), jden.depolarize_qubits(rho.copy(), [2], 0.2, 4),
        atol=1e-14)


def test_depolarizing_lowers_purity_monotonically():
    _, m = both_mrfs([[0, 1]], seed=2)
    lc = lower(compile_qcmrf(m))
    purities = []
    for p in (0.0, 0.002, 0.01, 0.05):
        rho = density.evolve_density(lc, p1q=0.1 * p, p2q=p, device=CPU)
        purities.append(float(torch.trace(rho @ rho).real))
        np.testing.assert_allclose(rho.numpy(), rho.numpy().conj().T,
                                   atol=1e-6)
        assert abs(float(torch.trace(rho).real) - 1.0) < 1e-5
    assert all(a > b for a, b in zip(purities, purities[1:]))
    assert np.isclose(purities[0], 1.0, atol=1e-4)


def test_guards_raise_as_jax():
    c = Circuit(2, num_clbits=2)
    c.sx(0).measure(0, 0).cx(0, 1).measure(1, 1)
    jc = JCircuit(2, num_clbits=2)
    jc.sx(0).measure(0, 0).cx(0, 1).measure(1, 1)
    for fn, circ in ((density.noisy_clbit_probs, c),
                     (jden.noisy_clbit_probs, jc)):
        with pytest.raises(ValueError, match="already-measured"):
            fn(circ, 0.0, 0.001, **({"device": CPU} if circ is c else {}))
    c, jc = Circuit(2), JCircuit(2)
    c.cp(0.5, 0, 1)
    jc.cp(0.5, 0, 1)
    with pytest.raises(ValueError, match="lowered"):
        density.evolve_density(c, device=CPU)
    with pytest.raises(ValueError, match="lowered"):
        jden.evolve_density(jc)
    with pytest.raises(ValueError, match="<=13"):
        density.evolve_density(Circuit(14), device=CPU)


@pytest.mark.parametrize("invert", [False, True])
def test_confuse_bits_matches_jax(invert):
    rng = np.random.RandomState(3)
    p = rng.dirichlet(np.ones(32))
    args = ([0.02, 0.01, 0.05], [0.03, 0.0, 0.02], [0, 2, 4], 5)
    got = density.confuse_bits(torch.from_numpy(p), *args, invert=invert)
    want = jden.confuse_bits(p, *args, invert=invert)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    back = density.confuse_bits(got, *args, invert=not invert)
    np.testing.assert_allclose(back.numpy(), p, atol=1e-10)
    # a batch with one rate list a row equals the rows one at a time
    P = torch.from_numpy(rng.dirichlet(np.ones(32), size=3))
    e01 = rng.uniform(0, 0.1, (3, 3))
    e10 = rng.uniform(0, 0.1, (3, 3))
    rows = density.confuse_bits(P, e01, e10, [0, 2, 4], 5, invert=invert)
    for r in range(3):
        np.testing.assert_allclose(
            rows[r].numpy(),
            jden.confuse_bits(P[r].numpy(), e01[r], e10[r], [0, 2, 4], 5,
                              invert=invert), rtol=0, atol=1e-12)


_TORINO = jphys.load_physical("torino", 0.1)


@pytest.mark.parametrize("g", range(7))
def test_noisy_clbit_probs_on_suite_graphs_match_jax(g):
    """Every suite graph at scale 0.1 (first rep), at the torino 0.1
    calibration's budget: within 1e-5 of JAX's numpy engine."""
    suite = jgenerate(0.1)
    theta = suite.thetas[g][0]
    jm = JMRF.create(suite.graphs[g], theta=theta)
    m = MRF.create(suite.graphs[g], theta=theta, device=CPU)
    want = jphys.gate_noisy_probs(jm, _TORINO.lam[g])
    got = physical.gate_noisy_probs(m, _TORINO.lam[g])
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    lc = physical.lowered_for_noise(m)
    jlc = jphys.lowered_for_noise(jm)
    assert [(x.name, x.qubits) for x in lc.gates] == \
        [(x.name, x.qubits) for x in jlc.gates]


@pytest.mark.parametrize("g", [1, 2, 5])
def test_batched_evolution_equals_single(g):
    """A graph's 10 reps as one batch, each with its own angles and rates,
    equal the 10 evolutions one at a time within 1e-6."""
    suite = generate_suite(0.1)
    mrfs = [MRF.create(suite.graphs[g], theta=t, device=CPU)
            for t in suite.thetas[g]]
    lcs = [physical.lowered_for_noise(m) for m in mrfs]
    ncx = sum(1 for x in lcs[0].gates if x.name == "cx")
    p2 = np.linspace(0.2, 1.5, 10) / ncx
    rho = density.evolve_density_batch(lcs, 0.1 * p2, p2, device=CPU)
    for r in range(10):
        one = density.evolve_density(lcs[r], 0.1 * p2[r], p2[r], device=CPU)
        np.testing.assert_allclose(rho[r].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)
    got = physical.gate_noisy_probs_batch(mrfs, p2 * ncx)
    for r in range(10):
        np.testing.assert_allclose(
            got[r].numpy(), physical.gate_noisy_probs(mrfs[r],
                                                      p2[r] * ncx).numpy(),
            rtol=0, atol=1e-6)


def test_batch_of_different_circuits_evolves_one_at_a_time():
    a, b = _zoo(Circuit), Circuit(3, num_clbits=3)
    b.x(0).cx(0, 1).sx(2)
    for q in range(3):
        b.measure(q, q)
    both = density.noisy_clbit_probs_batch([a, b], [0.01, 0.02],
                                           [0.05, 0.0], device=CPU)
    for row, c, p1, p2 in ((0, a, 0.01, 0.05), (1, b, 0.02, 0.0)):
        np.testing.assert_allclose(
            both[row].numpy(),
            density.noisy_clbit_probs(c, p1, p2, device=CPU).numpy(),
            rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# Preset backends
# --------------------------------------------------------------------------


def test_presets_and_models_carry_over():
    for name in ("torino", "sherbrooke", "ehningen", "depolarizing",
                 "readout-only"):
        jm = jb.preset(name)
        m = nb.NoiseModel.from_json(dataclasses.asdict(jm))
        assert m == nb.preset(name)
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
        assert nb.NoiseModel.from_json(m.to_json()) == m
    with pytest.raises(ValueError, match="unknown noise preset"):
        nb.preset("nope")


@pytest.mark.parametrize("cliques", [[[0, 1], [1, 2], [2, 3]],
                                     [[0, 1, 2]], [[0]]])
@pytest.mark.parametrize("name", ["torino", "depolarizing", "readout-only"])
def test_noisy_outcome_probs_match_jax(cliques, name):
    jm, m = both_mrfs(cliques, seed=4)
    want = np.asarray(jb.noisy_outcome_probs(jm, jb.preset(name)))
    got = nb.noisy_outcome_probs(m, nb.preset(name))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert nb.measured_bits(m) == jb.measured_bits(jm)


def test_calibrated_outcome_probs_and_errors_match_jax():
    jm, m = both_mrfs([[0, 1], [1, 2]], seed=6)
    cal = jfit.GraphCalibration(var_bias=0.1, anc_drop=0.05, anc_boost=0.0)
    want = np.asarray(jb.calibrated_outcome_probs(jm, cal, 0.01))
    got = nb.calibrated_outcome_probs(m, cal, 0.01)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    boost = jfit.GraphCalibration(var_bias=0.0, anc_drop=0.0, anc_boost=0.07)
    assert nb._calibrated_mitigation_errors(m, boost, 0.01) == [
        ch.ReadoutError(e.e01, e.e10)
        for e in jb._calibrated_mitigation_errors(jm, boost, 0.01)]


def test_mitigation_produces_negative_quasiprobs():
    _, m = both_mrfs([[0, 1], [1, 2], [2, 3]], seed=1)
    width = m.n + m.num_cliques + 1
    model = nb.preset("readout-only")
    counts = nb.sample_noisy_counts(0, m, model, 10_000)
    assert sum(counts.values()) == 10_000
    quasi, meta = mitigation.mitigate_counts(counts, [model.readout] * width,
                                             width)
    assert np.isclose(sum(quasi.values()), 1.0, atol=1e-6)
    assert meta["readout_mitigation_overhead"] > 1.0
    assert any(v < 0 for v in quasi.values())
    assert nb.sample_noisy_counts(0, m, model, 500) == \
        nb.sample_noisy_counts(0, m, model, 500)
