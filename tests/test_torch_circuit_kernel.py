"""Port parity of the whole-circuit kernel's plain version: the port's
``batched_circuit_probs`` on the CPU against the JAX package's Pallas
kernel (interpret mode) and its dense engine. tests/test_torch_gpu.py
holds the CUDA kernel against the plain version on a card."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.circuits.compiler import compile_qcmrf as jcompile  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.ops import circuit_kernel as jcircuit  # noqa: E402
from qcmrf_tpu.sim import dense as jdense  # noqa: E402

from qcmrf_tpu_torch.ops import circuit_kernel  # noqa: E402


@pytest.mark.parametrize("j", range(7))
def test_suite_graphs_match_pallas(j):
    suite = jsuite.generate_suite(0.1)
    C = suite.graphs[j]
    thetas = np.asarray(suite.thetas[j][:4], np.float32)
    want = np.asarray(jcircuit.batched_circuit_probs(C, thetas))
    got = circuit_kernel.batched_circuit_probs(C, thetas, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    plain = circuit_kernel.batched_circuit_probs_reference(C, thetas,
                                                           device="cpu")
    assert torch.equal(plain, got)
    for b in range(4):
        dense = np.asarray(jdense.simulate_probs(
            jcompile(JMRF.create(C, theta=thetas[b]))))
        np.testing.assert_allclose(got[b].numpy(), dense, atol=2e-5)


def test_zero_theta_is_uniform_with_delta_one():
    cliques = [[0, 1], [1, 2]]
    probs = circuit_kernel.batched_circuit_probs(
        cliques, np.zeros((1, 8), np.float32), device="cpu")[0].numpy()
    n = 3
    np.testing.assert_allclose(probs[: 1 << n], 1.0 / (1 << n), atol=1e-6)
    assert probs[1 << n:].sum() < 1e-6


def test_beta_matches_pallas_and_dense():
    cliques = [[0, 1]]
    thetas = -np.abs(np.random.RandomState(5).randn(1, 4)).astype(np.float32)
    got = circuit_kernel.batched_circuit_probs(cliques, thetas, beta=2.0,
                                               device="cpu")[0].numpy()
    want = np.asarray(jcircuit.batched_circuit_probs(cliques, thetas,
                                                     beta=2.0))[0]
    np.testing.assert_allclose(got, want, atol=2e-5)
    mrf = JMRF.create(cliques, theta=thetas[0], beta=2.0)
    np.testing.assert_allclose(
        got, np.asarray(jdense.simulate_probs(jcompile(mrf))), atol=2e-5)


def test_guards_raise():
    wide = [[i, i + 1] for i in range(8)]  # n=9, K=8: width 18
    with pytest.raises(ValueError, match="max 16"):
        circuit_kernel.batched_circuit_probs(wide, np.zeros((1, 32)),
                                             device="cpu")
    with pytest.raises(ValueError, match="theta <= 0"):
        circuit_kernel.batched_circuit_probs([[0, 1]], [[0.5, -1, -1, -1]],
                                             device="cpu")
    # width 16 is the widest the kernel takes
    chain = [[i, i + 1] for i in range(7)]  # n=8, K=7: width 16
    p = circuit_kernel.batched_circuit_probs(chain, -0.1 * np.ones((1, 28)),
                                             device="cpu")
    assert p.shape == (1, 1 << 16)
    assert abs(float(p.double().sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("beta", [1.0, 0.7, 2.5])
def test_rotation_pairs_closed_form(beta):
    """The kernel's (cos 2 gamma, sin 2 gamma) = (exp(beta theta / 2),
    sqrt(-expm1(beta theta))) against cos and sin of 2 * theta_to_gamma
    (the JAX package's and the port's), in float64, within 1e-15, at
    theta = 0, -40 and 2000 draws with |theta| >= 0.01 (closer to 0 the
    arccos route itself loses digits: d arccos / dc grows without bound
    at c = 1)."""
    from qcmrf_tpu.circuits.params import theta_to_gamma as jgamma

    from qcmrf_tpu_torch.circuits.params import theta_to_gamma

    rng = np.random.RandomState(7)
    theta = -np.concatenate([[0.0, 40.0],
                             0.01 + 2 * np.abs(rng.randn(2000))])
    c, s = circuit_kernel.rotation_pairs(theta, beta)
    assert (c[0], s[0]) == (1.0, 0.0)
    for to_gamma in (jgamma, theta_to_gamma):
        two_g = 2.0 * np.asarray(to_gamma(theta, beta), np.float64)
        np.testing.assert_allclose(c, np.cos(two_g), rtol=0, atol=1e-15)
        np.testing.assert_allclose(s, np.sin(two_g), rtol=0, atol=1e-15)


def test_mixed_structures_in_one_call_match_pallas():
    """The seven suite graphs in one call of batched_circuits_probs (the
    CPU route: the plain version per structure) against the JAX Pallas
    kernel (interpret mode), graph by graph, within 2e-5; the
    one-structure call is the same."""
    suite = jsuite.generate_suite(0.1)
    problems = [(C, np.asarray(suite.thetas[j][:3], np.float32))
                for j, C in enumerate(suite.graphs)]
    got = circuit_kernel.batched_circuits_probs(problems, device="cpu")
    assert len(got) == 7
    for (C, thetas), g in zip(problems, got):
        want = np.asarray(jcircuit.batched_circuit_probs(C, thetas))
        assert g.dtype == torch.float32 and g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want, atol=2e-5)
        assert torch.equal(g, circuit_kernel.batched_circuit_probs(
            C, thetas, device="cpu"))
    assert circuit_kernel.batched_circuits_probs([], device="cpu") == []


def test_descriptor_packing():
    """pack_circuits: circuits numbered problem by problem, theta and
    output offsets running sums, one table per distinct structure, the
    state in the global scratch only past width 14, and the dynamic
    shared memory the widest shared-memory circuit's (state and rotation
    pairs) or a scratch circuit's pairs."""
    chain14 = [[i, i + 1] for i in range(6)]   # n=7, K=6: width 14
    chain16 = [[i, i + 1] for i in range(7)]   # n=8, K=7: width 16
    tri = [[0, 1, 2], [2, 3]]                  # n=4, K=2: width 7
    rng = np.random.RandomState(2)
    problems = [circuit_kernel._problem(C, -np.abs(rng.randn(B, d)))
                for C, B, d in ((tri, 3, 12), (chain16, 2, 28),
                                (chain14, 1, 24), (tri, 2, 12))]
    pack = circuit_kernel.pack_circuits(problems)
    c = pack.circuits
    assert c.dtype.itemsize == 32 and len(c) == 8
    assert pack.shapes == ((3, 1 << 7), (2, 1 << 16), (1, 1 << 14),
                           (2, 1 << 7))
    assert list(c["theta"]) == [0, 12, 24, 36, 64, 92, 116, 128]
    outs = [0, 128, 256, 384, 384 + (1 << 16), 384 + (2 << 16)]
    outs += [outs[-1] + (1 << 14), outs[-1] + (1 << 14) + 128]
    assert list(c["out"]) == outs
    assert pack.out_offsets == (0, 384, 384 + (2 << 16), outs[-2])
    assert pack.out_floats == outs[-1] + 128
    assert list(c["scratch"]) == [-1, -1, -1, 0, 2 << 16, -1, -1, -1]
    assert pack.scratch_floats == 4 << 16
    # two tables: tri's (used twice) first, then the chains'
    t_tri = circuit_kernel.structure_table(problems[0][0], 4)
    t16 = circuit_kernel.structure_table(problems[1][0], 8)
    assert list(c["structure"]) == [0] * 3 + [t_tri.size] * 2 + [
        t_tri.size + t16.size] + [0] * 2
    assert list(t_tri[:5]) == [4, 2, 3, 7, 12]
    assert t_tri[5] == np.float32(0.25).view(np.int32)
    assert list(t_tri[6:]) == [3, 2, 3, 2, 1, 1, 0, 0]
    assert pack.shared_bytes == max(8 << 14, 8 << 7) + 8 * 24
    blob = pack.blob
    assert np.array_equal(blob[:c.nbytes].view(c.dtype), c)
    tables = blob[pack.structures_at:pack.thetas_at].view(np.int32)
    assert np.array_equal(tables[:t_tri.size], t_tri)
    thetas = blob[pack.thetas_at:].view(np.float64)
    assert thetas.size == 140 and np.array_equal(
        thetas[92:116], problems[2][3].ravel())


def test_statevector_suite_is_one_call_with_per_graph_counts():
    """run_suite(engine="statevector") on the CPU: the counts of every
    circuit equal those drawn graph by graph from batched_circuit_probs
    with the same seeds in the same order."""
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.runners import run_experiment
    from qcmrf_tpu_torch.sim import sampler

    suite = generate_suite(0.1)
    got = run_experiment.run_suite(suite, shots=300, engine="statevector",
                                   seed=3, device="cpu")
    want = []
    for j, C in enumerate(suite.graphs):
        width = max(v for c in C for v in c) + 1 + len(C) + 1
        probs = circuit_kernel.batched_circuit_probs(C, suite.thetas[j],
                                                     device="cpu")
        for row in probs:
            want.append(sampler.sample_counts(
                run_experiment.circuit_seed(3, len(want)), row, 300, width))
    assert len(got) == 70 and got == want
