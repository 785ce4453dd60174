"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked ``gpu`` and skips where PyTorch sees no CUDA
device. The file imports no JAX, so on a machine without it run it with
``python -m pytest --noconftest tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu_torch.models.mrf import MRF, grid_mrf  # noqa: E402
from qcmrf_tpu_torch.ops import kernels, sampler_kernel  # noqa: E402
from qcmrf_tpu_torch.sim import analytic, batch  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def model(dev, rows=3, cols=4, seed=1, scale=0.3):
    g = grid_mrf(rows, cols, device=dev)
    rng = np.random.RandomState(seed)
    return g.with_theta(-np.abs(rng.randn(g.dimension)).astype(np.float32)
                        * scale)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def test_sampler_kernel_matches_plain_version(dev):
    m = MRF.create([[0, 1, 2], [2, 3], [4], [1, 4]], device=dev,
                   theta=-np.abs(np.random.RandomState(2).randn(18)) * 0.5)
    kc = sampler_kernel.keep_prob_coefficients(m)[None].repeat(3, 1)
    for mode in sampler_kernel.MODES:
        for shots in (1, 1000, 4099):
            before = sampler_kernel.LAUNCHES["sampler"]
            got = sampler_kernel.sample_call(5, m.cliques, m.n, kc, shots,
                                             mode, 3)
            assert sampler_kernel.LAUNCHES["sampler"] == before + 1
            want = sampler_kernel.sample_call_reference(
                5, m.cliques, m.n, kc, shots, mode, 3)
            for g, w in zip(as_tuple(got), as_tuple(want)):
                assert g.is_cuda and torch.equal(g, w), (mode, shots)


def test_table_and_lse_kernels_match_plain_versions(dev):
    m = model(dev)
    coef = kernels.coefficient_table(
        m.cliques, m.n, torch.stack([m.theta, 0.5 * m.theta]))
    for fuse_amp in (False, True):
        torch.testing.assert_close(
            kernels.logpot_table(m.cliques, m.n, coef, 1.7, fuse_amp),
            kernels.logpot_table_reference(m.cliques, m.n, coef, 1.7,
                                           fuse_amp),
            rtol=1e-6, atol=1e-6)
    got = kernels.combine_lse(*kernels.lse_partials(m.cliques, m.n, coef,
                                                    1.7))
    want = kernels.combine_lse(*kernels.lse_partials_reference(
        m.cliques, m.n, coef, 1.7))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_cuda_models_go_through_the_kernels(dev):
    m = model(dev)
    counts = dict(kernels.LAUNCHES)
    p, delta = analytic.postselected_probs(m)
    assert kernels.LAUNCHES["logpot"] == counts["logpot"] + 1
    assert kernels.LAUNCHES["lse"] == counts["lse"] + 1
    assert p.is_cuda and abs(float(p.sum()) - 1.0) < 1e-5
    cpu = MRF.create(m.cliques, theta=m.theta.cpu())
    assert abs(float(delta) - float(cpu.success_rate())) < 1e-6
    keys = batch.batched_sample_outcomes([[0, 1], [1, 2]],
                                         [[-0.1] * 8] * 4, 0, 300,
                                         device=dev)
    assert keys.is_cuda and keys.shape == (4, 300)


def test_wrappers_raise_on_bad_inputs(dev):
    cl, n = ((0, 1),), 2
    with pytest.raises(ValueError):  # float64 coefficients
        kernels.logpot_table(cl, n, torch.zeros(1, 4, dtype=torch.float64,
                                                device=dev), 1.0)
    with pytest.raises(ValueError):  # not contiguous
        kernels.lse_partials(cl, n, torch.zeros(4, 2, device=dev).T, 1.0)
