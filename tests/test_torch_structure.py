"""Port parity of structure learning (``models/structure.py``): group-lasso
MLE over candidate cliques on the problems of ``tests/test_structure.py``,
the same data (drawn by the JAX package) through both packages. Selected
edges are equal; the refit theta within 1e-4 and the final NLL within
1e-5 (a few hundred Adam steps on float32 gradients summed in another
order: measured 6e-7 and 2e-7); ``interaction_norms`` of one theta within
1e-4. The penalised fit's norms of the selected candidates agree within
1e-3, the tolerance of tests/test_structure.py between two lnZ routes;
the other candidates sit at a noise floor far below the cut in both
packages (the nonsmooth group penalty drives them around zero, where
float32 differences in the gradient grow step by step: measured up to
1.5e-3 apart, as JAX's own routes drift)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models import sample as jsample  # noqa: E402
from qcmrf_tpu.models import structure as jstruct  # noqa: E402
from qcmrf_tpu.models import train as jtrain  # noqa: E402

from qcmrf_tpu_torch.models import capability, structure  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from qcmrf_tpu_torch.utils.bits import bits_from_state_id  # noqa: E402
from test_structure import planted_chain  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def chain6():
    """tests/test_structure.py's planted 6-chain and its 6000 samples."""
    true, edges = planted_chain(6, seed=5)
    data = np.asarray(jsample.sample_exact(jax.random.PRNGKey(11), true,
                                           6000))
    return edges, data


def assert_fits_agree(got, want):
    assert got.selected == want.selected
    assert got.cliques == want.cliques and got.threshold == want.threshold
    real = np.asarray(want.group_norm) >= want.threshold
    np.testing.assert_allclose(got.group_norm[real], want.group_norm[real],
                               rtol=0, atol=1e-3)
    floor = 0.2 * want.threshold
    assert got.group_norm[~real].max() < floor
    assert want.group_norm[~real].max() < floor
    assert [list(C) for C in got.mrf.cliques] == [list(C) for C in
                                                  want.mrf.cliques]
    np.testing.assert_allclose(got.mrf.theta.numpy(),
                               np.asarray(want.mrf.theta), rtol=0, atol=TOL)
    assert abs(got.nll - want.nll) <= 1e-5


def test_recovers_planted_chain_like_jax(chain6):
    edges, data = chain6
    kw = dict(lam=0.05, steps=350)
    want = jstruct.fit_structure(jstruct.candidate_pairs(6), data, 6, **kw)
    got = structure.fit_structure(structure.candidate_pairs(6), data, 6,
                                  device="cpu", **kw)
    assert got.selected == edges
    assert_fits_agree(got, want)
    np.testing.assert_allclose(got.group_norm[:6], 0.0)
    assert not got.mrf.theta.requires_grad


def test_bit_rows_select_as_state_ids(chain6):
    """2-D bit rows reduce to the same moments as state ids."""
    edges, data = chain6
    bits = bits_from_state_id(torch.tensor(data).long(), 6).numpy()
    kw = dict(lam=0.05, steps=150, refit_steps=100)
    got = structure.fit_structure(structure.candidate_pairs(6), bits, 6,
                                  device="cpu", **kw)
    want = jstruct.fit_structure(jstruct.candidate_pairs(6), bits, 6, **kw)
    assert_fits_agree(got, want)
    ids = structure.fit_structure(structure.candidate_pairs(6), data, 6,
                                  device="cpu", **kw)
    assert ids.selected == got.selected
    np.testing.assert_allclose(ids.group_norm, got.group_norm, atol=1e-6)


def test_streaming_selection_matches_jax(chain6, monkeypatch):
    """The selection NLL through the streaming fused sweep, forced in both
    packages by a width cap of 1 and no enumeration, selects what JAX's
    streaming custom VJP selects, with the same norms and refit."""
    edges, data = chain6
    monkeypatch.setattr(jtrain, "_ELIM_WIDTH_CAP", 1)
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    jorig = jtrain.make_lnz_fn
    monkeypatch.setattr(
        jstruct, "make_lnz_fn",
        lambda t, mesh=None: jorig(t, mesh=mesh, enumerate_max_n=-1))
    monkeypatch.setattr(structure, "_ENUMERATE_MAX_N", -1)
    sweeps = []
    plain = kernels.lnz_moments_partials

    def fused(*args):
        sweeps.append(1)
        return plain(*args)

    monkeypatch.setattr(kernels, "lnz_moments_partials", fused)
    kw = dict(lam=0.05, steps=250, refit_steps=150)
    want = jstruct.fit_structure(jstruct.candidate_pairs(6), data, 6, **kw)
    got = structure.fit_structure(structure.candidate_pairs(6), data, 6,
                                  device="cpu", **kw)
    assert len(sweeps) == 250 + 150
    assert got.selected == edges
    assert_fits_agree(got, want)


def test_interaction_norms_and_projector_match_jax():
    m = MRF.create([[0, 1]], theta=np.zeros(4), device="cpu")
    base = np.array([-0.2, -1.1, -1.3, -0.1])
    w = structure.interaction_norms(m, base)[0]
    assert np.isclose(structure.interaction_norms(m, base - 2.0)[0], w)
    unary = np.array([0.7, 0.7, 0.0, 0.0]) + np.array([0.0, 0.3, 0.0, 0.3])
    assert np.isclose(structure.interaction_norms(m, base + unary)[0], w)
    assert np.isclose(structure.interaction_norms(
        m, torch.tensor(-0.5 * np.array([0, 1, 1, 0.0])))[0], 0.5)
    for c in (1, 2, 3, 4):
        np.testing.assert_array_equal(structure._interaction_projector(c),
                                      jstruct._interaction_projector(c))


def test_interaction_norms_of_one_theta_match_jax():
    cliques = [[0], [0, 1], [1, 2, 3], [0, 2, 3, 4], [3, 4]]
    theta = np.random.RandomState(7).randn(sum(1 << len(C)
                                               for C in cliques))
    from qcmrf_tpu.models.mrf import MRF as JMRF

    got = structure.interaction_norms(
        MRF.create(cliques, theta=theta, device="cpu"))
    want = jstruct.interaction_norms(JMRF.create(cliques, theta=theta))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_penalty_matches_jax():
    cliques = [[0], [1], [0, 1], [1, 2, 3], [0, 3], [2, 3]]
    theta = -np.abs(np.random.RandomState(4).randn(
        sum(1 << len(C) for C in cliques))).astype(np.float32)
    m = MRF.create(cliques, theta=theta, device="cpu")
    from qcmrf_tpu.models.mrf import MRF as JMRF

    jm = JMRF.create(cliques, theta=jnp.asarray(theta))
    got = structure._interaction_penalty(m)(m.theta)
    want = jstruct._interaction_penalty(jm)(jm.theta)
    assert abs(float(got) - float(want)) <= 1e-6


def test_prune_tol_override_and_independent_data():
    """Independent data selects nothing; an explicit prune_tol is honoured
    (tests/test_structure.py's problem)."""
    data = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (4000,), 0,
                                         16))
    kw = dict(lam=0.1, steps=200, prune_tol=0.25, refit_steps=100)
    want = jstruct.fit_structure(jstruct.candidate_pairs(4), data, 4, **kw)
    got = structure.fit_structure(structure.candidate_pairs(4), data, 4,
                                  device="cpu", **kw)
    assert got.selected == [] and got.threshold == 0.25
    assert all(len(C) == 1 for C in got.mrf.cliques)
    assert_fits_agree(got, want)


def test_singleton_candidates_rejected():
    with pytest.raises(ValueError, match="size >= 2"):
        structure.fit_structure([[0], [0, 1]], np.zeros(4, np.int32), 2,
                                device="cpu")


def test_structure_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        structure.fit_structure([[0, 1]], np.zeros(4, np.int32), 2, steps=1)
