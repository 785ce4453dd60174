"""Port parity: bit conventions, Moebius machinery, theta<->gamma maps, the
seed-1984 suite and the MRF core of ``qcmrf_tpu_torch`` against
``qcmrf_tpu`` on the same numpy inputs."""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.circuits import params as jparams  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.models.mrf import grid_mrf as jgrid_mrf  # noqa: E402
from qcmrf_tpu.utils import bits as jbits  # noqa: E402
from qcmrf_tpu.utils import moebius as jmoebius  # noqa: E402

from qcmrf_tpu_torch.circuits import params  # noqa: E402
from qcmrf_tpu_torch.models import suite  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf, grid_mrf  # noqa: E402
from qcmrf_tpu_torch.utils import bits, moebius  # noqa: E402


def port(jm) -> MRF:
    """The port's model carrying a JAX model's parameters."""
    return MRF.from_numpy(jm.cliques, np.asarray(jm.theta), float(jm.beta),
                          jm.n, device="cpu")


def test_bits_match():
    n = 7
    x = np.random.RandomState(0).randint(0, 1 << n, size=64)
    got = bits.bits_from_state_id(torch.from_numpy(x), n).numpy()
    want = np.asarray(jbits.bits_from_state_id(jnp.asarray(x), n))
    np.testing.assert_array_equal(got, want)
    back = bits.state_id_from_bits(torch.from_numpy(got), n).numpy()
    np.testing.assert_array_equal(back, x)
    for v in range(n):
        np.testing.assert_array_equal(
            bits.var_bit(torch.from_numpy(x), v, n).numpy(),
            np.asarray(jbits.var_bit(jnp.asarray(x), v, n)))
        assert bits.var_to_qubit(v, n) == jbits.var_to_qubit(v, n)
    for i in (0, 5, 77):
        assert bits.key_string(i, 9) == jbits.key_string(i, 9)
        assert bits.key_to_index(bits.key_string(i, 9)) == i
    assert bits.postselect_mask_size(n) == jbits.postselect_mask_size(n)


@pytest.mark.parametrize("cmax", [1, 2, 3, 4])
def test_moebius_transform_exact(cmax):
    tab = np.random.RandomState(cmax).randn(5, 1 << cmax).astype(np.float32)
    got = moebius.transform(torch.from_numpy(tab), cmax).numpy()
    want = np.asarray(jmoebius.transform(jnp.asarray(tab), cmax))
    np.testing.assert_array_equal(got, want)
    # leading batch axes transform row by row
    stack = np.stack([tab, -tab])
    got2 = moebius.transform(torch.from_numpy(stack), cmax).numpy()
    np.testing.assert_array_equal(got2[0], want)


def test_eval_multilinear_exact():
    rng = np.random.RandomState(1)
    m = 3
    planes = [rng.randint(0, 2, size=(50,)).astype(np.float32)
              for _ in range(m)]
    coef = rng.randn(1 << m).astype(np.float32)
    acc0 = rng.randn(50).astype(np.float32)
    got = moebius.eval_multilinear(
        [torch.from_numpy(p) for p in planes], m,
        lambda s: torch.from_numpy(coef[s:s + 1]), torch.from_numpy(acc0))
    want = jmoebius.eval_multilinear(
        [jnp.asarray(p) for p in planes], m,
        lambda s: jnp.asarray(coef[s:s + 1]), jnp.asarray(acc0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.arange(16)
    planes_t = moebius.extract_bit_planes(x, [2, 0, 2], 4)
    planes_j = jmoebius.extract_bit_planes(jnp.arange(16), [2, 0, 2], 4)
    assert sorted(planes_t) == sorted(planes_j)
    for v in planes_t:
        np.testing.assert_array_equal(planes_t[v].numpy(),
                                      np.asarray(planes_j[v]))


def test_params_exact_float64():
    theta = -np.abs(np.random.RandomState(2).randn(40)) * 0.7
    g = params.theta_to_gamma(theta, beta=1.3)
    np.testing.assert_array_equal(g, jparams.theta_to_gamma(theta, beta=1.3))
    assert g.dtype == np.float64
    np.testing.assert_array_equal(params.gamma_to_theta(g, beta=1.3),
                                  jparams.gamma_to_theta(g, beta=1.3))
    # tensors map in their own dtype
    gt = params.theta_to_gamma(torch.from_numpy(theta), beta=1.3)
    assert isinstance(gt, torch.Tensor) and gt.dtype == torch.float64
    np.testing.assert_allclose(gt.numpy(), g, rtol=1e-12)
    params.validate_theta_domain(theta)
    with pytest.raises(ValueError):
        params.validate_theta_domain(torch.tensor([0.1]))


@pytest.mark.parametrize("scale", [0.1, 0.25, 0.5])
def test_generate_suite_bit_exact(scale, tmp_path):
    got = suite.generate_suite(scale)
    want = jsuite.generate_suite(scale)
    assert got.graphs == want.graphs
    assert got.thetas == want.thetas  # python floats, bit for bit
    assert got.num_circuits == want.num_circuits == 70
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "jax.json"))
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    loaded = suite.load_suite(str(tmp_path / "port.json"), scale)
    assert loaded.thetas == got.thetas and loaded.scale == scale


def test_load_suite_scale_from_name(tmp_path):
    s = suite.generate_suite(0.25)
    p = tmp_path / "models_0.25.json"
    s.save(str(p))
    assert suite.load_suite(str(p)).scale == 0.25
    assert (suite.reference_models_path(0.25, str(tmp_path))
            == str(tmp_path / "res_0.25" / "models.json"))
    mrfs = s.mrfs(device="cpu")
    assert len(mrfs) == 70 and mrfs[10].cliques == ((0, 1),)
    np.testing.assert_array_equal(mrfs[10].theta.numpy(),
                                  np.float32(s.thetas[1][0]))


@functools.lru_cache(maxsize=1)
def _suite_models():
    s = jsuite.generate_suite(0.5)
    out = [JMRF.create(C, theta=s.thetas[j][r])
           for j, C in enumerate(s.graphs) for r in (0, 7)]
    rng = np.random.RandomState(3)
    for beta in (1.0, 2.5):
        g = jgrid_mrf(3, 4, beta=beta)
        out.append(g.with_theta(
            jnp.asarray(-np.abs(rng.randn(g.dimension)), jnp.float32)))
    return out


@pytest.mark.parametrize("idx", range(16))
def test_mrf_matches_jax(idx):
    jm = _suite_models()[idx]
    m = port(jm)
    assert (m.n, m.cliques, m.dimension, m.theta_offsets) == (
        jm.n, jm.cliques, jm.dimension, jm.theta_offsets)
    x = np.arange(jm.num_states)
    np.testing.assert_array_equal(
        m.suff_stat_flat_indices(torch.from_numpy(x)).numpy(),
        np.asarray(jm.suff_stat_flat_indices(jnp.asarray(x))))
    np.testing.assert_array_equal(
        m.phi(torch.from_numpy(x[:9])).numpy(),
        np.asarray(jm.phi(jnp.asarray(x[:9]))))
    tol = dict(rtol=1e-6, atol=1e-5)  # float32, another summation order
    np.testing.assert_allclose(m.log_potential(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.log_potential(jnp.asarray(x))),
                               **tol)
    np.testing.assert_allclose(m.all_log_potentials().numpy(),
                               np.asarray(jm.all_log_potentials()), **tol)
    np.testing.assert_allclose(float(m.log_partition()),
                               float(jm.log_partition()), **tol)
    np.testing.assert_allclose(m.gibbs_probs().numpy(),
                               np.asarray(jm.gibbs_probs()), **tol)
    np.testing.assert_allclose(float(m.success_rate()),
                               float(jm.success_rate()), **tol)


def test_mrf_constructors():
    m = grid_mrf(2, 3, device="cpu")
    assert m.cliques == jgrid_mrf(2, 3).cliques
    assert m.theta.dtype == torch.float32 and m.device.type == "cpu"
    assert chain_mrf(4, device="cpu").cliques == ((0, 1), (1, 2), (2, 3))
    with pytest.raises(ValueError):
        MRF.create([[0, 1]], theta=[0.0] * 3, device="cpu")
    with pytest.raises(ValueError):
        MRF.create([[0, 3]], n=2, device="cpu")
    with pytest.raises(ValueError):
        MRF.create([0, 1], device="cpu")
    m2 = MRF.create([[0, 1]], n=4, device="cpu")
    assert m2.num_states == 16 and m2.num_nodes == 4
    m3 = m2.with_theta(np.full(4, -0.5))
    assert float(m2.theta.sum()) == 0.0 and float(m3.theta.sum()) == -2.0
    with pytest.raises(Exception):
        m3.beta = 2.0  # frozen value type
