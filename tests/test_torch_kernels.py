"""Port parity of the kernel modules: the plain PyTorch versions of the
log-potential table, the streaming logsumexp and the sampler's inputs
against the JAX package's Pallas kernels (interpret mode on the CPU), and
the port's Philox against the Random123 known answers. On the CPU every
wrapper runs its plain version; tests/test_torch_gpu.py holds the CUDA
kernels against them on a card."""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.models.mrf import grid_mrf as jgrid_mrf  # noqa: E402
from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402
from qcmrf_tpu.ops import sampler_kernel as jsampler  # noqa: E402

from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.ops import kernels, sampler_kernel  # noqa: E402
from qcmrf_tpu_torch.utils import moebius  # noqa: E402


def port(jm, device="cpu") -> MRF:
    return MRF.from_numpy(jm.cliques, np.asarray(jm.theta), float(jm.beta),
                          jm.n, device=device)


def rand_grid(rows, cols, seed, scale=1.0, beta=1.0):
    g = jgrid_mrf(rows, cols, beta=beta)
    rng = np.random.RandomState(seed)
    return g.with_theta(jnp.asarray(
        -np.abs(rng.randn(g.dimension)).astype(np.float32) * scale))


def random_structures(count=4, seed=11):
    """Random clique structures as in tests/test_kernels.py: mixed sizes,
    shared variables, non-contiguous."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        n = int(rng.randint(10, 14))
        cliques = []
        for _ in range(rng.randint(2, 5)):
            size = int(rng.randint(1, 4))
            cliques.append(sorted(
                rng.choice(n, size=size, replace=False).tolist()))
        dim = sum(1 << len(C) for C in cliques)
        out.append(JMRF.create(cliques, theta=jnp.asarray(
            -np.abs(rng.randn(dim)).astype(np.float32) * 0.4)))
    return out


@pytest.mark.parametrize("beta", [1.0, 2.5])
def test_logpot_table_matches_pallas(beta):
    jm = rand_grid(3, 4, seed=1, beta=beta)  # n=12: JAX takes its kernel
    got = kernels.all_log_potentials(port(jm)).numpy()
    want = np.asarray(jkernels.all_log_potentials(jm))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_postselected_amplitudes_match_pallas():
    jm = rand_grid(3, 4, seed=5, scale=0.3)
    got = kernels.postselected_amplitudes(port(jm)).numpy()
    want = np.asarray(jkernels.postselected_amplitudes(jm))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("case", ["grid3x4", "grid4x4", "rand0", "rand1",
                                  "rand2", "rand3"])
def test_lse_matches_pallas_streaming(case):
    if case.startswith("grid"):
        jm = (rand_grid(3, 4, 7, 0.2) if case == "grid3x4"
              else rand_grid(4, 4, 7, 0.35))
    else:
        jm = random_structures()[int(case[-1])]
    coef = jkernels._moebius_coefficients(jm)
    beta = jnp.reshape(jnp.asarray(jm.beta, jnp.float32), (1,))
    want = float(jkernels._log_partition_fused(jm.cliques, jm.n, coef, beta))
    m = port(jm)
    got = float(kernels.log_partition(m))
    assert abs(got - want) < 1e-4, (case, got, want)
    # the partials' combine is the logsumexp of the table
    table = kernels.all_log_potentials(m)
    assert abs(got - float(torch.logsumexp(table, 0))) < 1e-5


def test_moebius_coefficients_match():
    for jm in [rand_grid(2, 3, 2)] + random_structures(2, seed=4):
        np.testing.assert_allclose(
            kernels.moebius_coefficients(port(jm)).numpy(),
            np.asarray(jkernels._moebius_coefficients(jm)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_keep_prob_coefficients_match(seed):
    for jm in [rand_grid(2, 3, seed, 0.5)] + random_structures(2, seed):
        np.testing.assert_allclose(
            sampler_kernel.keep_prob_coefficients(port(jm)).numpy(),
            np.asarray(jsampler._keep_prob_coefficients(jm)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_keep_prob_values_are_the_gathered_exp_table(seed):
    """The sampler's table: exp(beta * theta) gathered by the layout of
    JAX's ``_moebius_layout``; its Moebius transform is the JAX kernel's
    coefficient table."""
    from qcmrf_tpu.sim.analytic import _moebius_layout as jlayout

    for jm in [rand_grid(2, 3, seed, 0.5, beta=1.3)] + random_structures(
            2, seed):
        m = port(jm)
        idx, _, cmax = jlayout(jm.cliques, jm.n)
        want = np.exp(np.float32(jm.beta) * np.asarray(jm.theta)[idx])
        got = sampler_kernel.keep_prob_values(m.cliques, m.n, m.theta,
                                              m.beta)
        np.testing.assert_allclose(got.numpy(), want.reshape(-1),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            moebius.transform(got.reshape(-1, 1 << cmax), cmax)
            .reshape(-1).numpy(),
            sampler_kernel.keep_prob_coefficients(m).numpy(),
            rtol=0, atol=1e-6)


KNOWN_ANSWERS = [
    # (counter, key, output): the Random123 philox4x32_10 known answers
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,out", KNOWN_ANSWERS)
def test_philox_known_answers(ctr, key, out):
    assert sampler_kernel.philox4x32_10(*ctr, *key) == out
    # the same words from int64 tensors, as the plain sampler draws them
    t = [torch.tensor([c, 0], dtype=torch.int64) for c in ctr + key]
    words = sampler_kernel.philox4x32_10(*t)
    assert tuple(int(w[0]) for w in words) == out


def test_batch_rows_are_independent_models():
    jm = rand_grid(2, 3, 3, 0.5)
    thetas = torch.stack([port(jm).theta, port(jm).theta * 0.5,
                          port(jm).theta * 2.0])
    cl, n = jm.cliques, jm.n
    coef = kernels.coefficient_table(cl, n, thetas)
    table = kernels.logpot_table(cl, n, coef, 1.5)
    lnz = kernels.combine_lse(*kernels.lse_partials(cl, n, coef, 1.5))
    for b in range(3):
        m = MRF.create(cl, theta=thetas[b], beta=1.5, device="cpu")
        torch.testing.assert_close(table[b], kernels.all_log_potentials(m),
                                   rtol=0, atol=0)
        torch.testing.assert_close(lnz[b], kernels.log_partition(m),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("num_states", [1, 32, 1024, 3000, 1 << 20,
                                        (1 << 28) + 5])
def test_lse_geometry_covers_every_state(num_states):
    parts, per_part = kernels.lse_geometry(num_states)
    assert 1 <= parts <= kernels.MAX_LSE_PARTS
    assert parts * per_part >= num_states > (parts - 1) * per_part


def test_combine_lse_with_empty_partials():
    m = torch.tensor([[0.5, -math.inf, 2.0]])
    s = torch.tensor([[3.0, 0.0, 1.0]])
    want = math.log(3.0 * math.exp(0.5) + math.exp(2.0))
    assert abs(float(kernels.combine_lse(m, s)[0]) - want) < 1e-6


def test_wrappers_check_inputs_before_launch():
    cl, n = ((0, 1), (1, 2)), 3
    with pytest.raises(ValueError):
        sampler_kernel.sample_call(0, cl, n, torch.zeros(1, 8), 10, "bogus")
    with pytest.raises(ValueError):
        sampler_kernel.sample_call(0, ((0, 32),), 33, torch.zeros(1, 4), 10,
                                   "flags")
    with pytest.raises(ValueError):
        sampler_kernel.sample_call(0, tuple((i,) for i in range(33)), 31,
                                   torch.zeros(1, 66), 10, "parts")
    from qcmrf_tpu_torch.ops import _build

    with pytest.raises(ValueError):  # shape mismatch
        _build.structure_args(cl, n, torch.zeros(1, 6))
    with pytest.raises(ValueError):  # beyond the shared-memory tables
        _build.structure_args(tuple((i,) for i in range(16000)), 16000,
                              torch.zeros(1, 32000))
    with pytest.raises(ValueError):  # the tables fit, the kernel's own not
        _build.structure_args(tuple((i,) for i in range(14000)), 14000,
                              torch.zeros(1, 28000), extra=16384)
    _build.structure_args(tuple((i,) for i in range(14000)), 14000,
                          torch.zeros(1, 28000))  # past 48 KB: fits


@pytest.mark.parametrize("K,cmax", [(351, 2), (600, 4), (1000, 5)])
def test_moments_launch_fills_shared_memory(K, cmax):
    """A moments launch (either form of ``lnz_moments_kernel``) takes as
    many monomials as fit beside the split's tables, ``P`` and ``W``,
    and not one more: K distinct random cliques of cmax variables over
    27, 20 and 16 variables."""
    from qcmrf_tpu_torch.ops import _build

    n = {2: 27, 4: 20, 5: 16}[cmax]
    rng = np.random.RandomState(K)
    cl = set()
    while len(cl) < K:
        cl.add(tuple(sorted(rng.choice(n, cmax, replace=False).tolist())))
    cl = tuple(sorted(cl))
    plan = kernels.split_plan(cl, n, kernels.split_bits(n))
    step = kernels.moments_per_launch(cl, n)
    need = kernels.split_shared_bytes(plan, step) + kernels._LNZ_STATIC_BYTES
    assert step > 0
    assert need <= _build.SHARED_BYTES_LIMIT < need + 12
