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
