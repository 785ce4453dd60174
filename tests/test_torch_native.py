"""The port's native engine (``qcmrf_tpu_torch/native``) against the JAX
package's wrapper of the same C++ source, on the CPU.

One source (the port keeps a byte-equal copy), one compiler and one set of
flags: weights, ln Z, log-potentials, MAP states and the Gibbs and PAM
samples are equal for the same seed, and ``evaluate_suite(native=True)``
equals the JAX harness's field by field."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.evaluation import harness as jharness  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402

from qcmrf_tpu_torch.evaluation import harness  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.ops import _build  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

REPO = Path(__file__).resolve().parents[1]

GRAPHS = [
    [[0]],
    [[0, 1]],
    [[0, 1], [1, 2], [2, 3]],
    [[0, 1], [1, 2], [2, 3], [3, 4]],
    [[0, 1, 2]],
    [[0, 1, 2], [2, 3, 4]],
    [[0, 1, 2, 3]],
]


@pytest.fixture(scope="module")
def px():
    from qcmrf_tpu_torch.native import kiopto

    return kiopto


@pytest.fixture(scope="module")
def jpx():
    from qcmrf_tpu.native import kiopto

    return kiopto


def pair(px, jpx, cliques, seed, scale=0.6, n=None):
    """The same weights in a port and a JAX backend."""
    n = n or 1 + max(v for C in cliques for v in C)
    rng = np.random.RandomState(seed)
    theta = -np.abs(rng.randn(sum(1 << len(C) for C in cliques))) * scale
    out = []
    for mod in (px, jpx):
        b = mod.backend(cliques, np.array([2] * n))
        mod.weights(b)[:] = theta
        out.append(b)
    return out


def test_source_is_the_jax_packages_byte_for_byte(px):
    assert (px.SOURCE.read_bytes()
            == (REPO / "qcmrf_tpu" / "native" / "kiopto.cpp").read_bytes())
    assert px.SOURCE.parent == REPO / "qcmrf_tpu_torch" / "native"


def test_builds_into_the_ports_build_directory(px):
    path = px.build()
    assert path.is_file() and path == px.library_path()
    assert _build.BUILD_ROOT in path.parents
    assert path.parents[2] == REPO / "build" / "qcmrf_tpu_torch"


def test_failed_build_raises(px, monkeypatch, tmp_path):
    bad = tmp_path / "kiopto.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(px, "SOURCE", bad)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        px.build()
    assert not list((tmp_path / "build").rglob("*.so*"))


def test_reference_api_surface(px):
    b = px.backend([[0, 1]], np.array([2, 2]), inference="exact")
    w = px.weights(b)
    assert w.shape == (4,)
    w[:] = [-0.1, -0.2, -0.3, -0.4]  # in-place write-through
    assert np.isclose(px.weights(b)[2], -0.3)
    # the view keeps a temporary backend alive
    v = px.weights(px.backend([[0, 1, 2]], [2, 2, 2]))
    v[:] = 1.0
    assert v.sum() == 8.0
    with pytest.raises(ValueError, match="binary"):
        px.backend([[0, 1]], np.array([3, 3]))
    with pytest.raises(ValueError, match="exact"):
        px.backend([[0, 1]], [2, 2], inference="lbp")
    with pytest.raises(ValueError, match="partition"):
        px.infer(b, task="map")


@pytest.mark.parametrize("cliques", GRAPHS)
def test_logpot_and_partition_equal_jax(px, jpx, cliques):
    b, jb = pair(px, jpx, cliques, 11)
    for x in range(1 << b.n):
        assert abs(px.logpot(b, x) - jpx.logpot(jb, x)) <= 1e-9
    assert abs(px.infer(b) - jpx.infer(jb)) <= 1e-9
    theta = np.asarray(px.weights(b), np.float32)
    m = JMRF.create(cliques, theta=theta)
    assert abs(px.infer(b) - float(m.log_partition())) < 1e-5


def test_partition_of_a_30_chain_equal_jax(px, jpx):
    b, jb = pair(px, jpx, [[i, i + 1] for i in range(29)], 3, 1.0)
    assert abs(px.infer(b) - jpx.infer(jb)) <= 1e-9


@pytest.mark.parametrize("cliques", GRAPHS[2:])
def test_map_state_equal_jax(px, jpx, cliques):
    b, jb = pair(px, jpx, cliques, 5, 1.5)
    np.testing.assert_array_equal(px.map_state(b), jpx.map_state(jb))


@pytest.mark.parametrize("pam", [False, True])
def test_samples_equal_jax(px, jpx, pam):
    b, jb = pair(px, jpx, [[0, 1], [1, 2], [2, 3, 4]], 7)
    got = px.sample(b, pam=pam, num=500, seed=123)
    want = jpx.sample(jb, pam=pam, num=500, seed=123)
    assert got.dtype == np.int32 and got.shape == (500, 5)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, px.sample(b, pam=pam, num=500, seed=124))


def test_isolated_trailing_variables(px, jpx):
    b = px.backend([[0, 1]], np.array([2, 2, 2]))
    assert b.n == 3 and np.isclose(px.infer(b), 3 * np.log(2.0))
    assert px.sample(b, pam=True, num=4, seed=0).shape == (4, 3)
    px.weights(b)[:] = [0.0, 0.0, 0.0, -1.0]
    assert np.isclose(px.logpot(b, 0b110), -1.0)
    assert np.isclose(px.logpot(b, 0b111), -1.0)
    assert np.isclose(px.logpot(b, 0b100), 0.0)
    jb = jpx.backend([[0, 1]], np.array([2, 2, 2]))
    jpx.weights(jb)[:] = [0.0, 0.0, 0.0, -1.0]
    np.testing.assert_array_equal(px.sample(b, num=50, seed=3),
                                  jpx.sample(jb, num=50, seed=3))


def test_gibbs_beyond_64_variables(px, jpx):
    n = 70
    cl = [[i, i + 1] for i in range(n - 1)]
    b = px.backend(cl, np.array([2] * n))
    S = px.sample(b, num=300, seed=1)
    assert S.shape == (300, n) and 0.4 < S.mean() < 0.6
    np.testing.assert_array_equal(
        S, jpx.sample(jpx.backend(cl, np.array([2] * n)), num=300, seed=1))
    with pytest.raises(ValueError, match="n <= 64"):
        px.logpot(b, 0)


def test_empty_clique_rejected(px):
    with pytest.raises(ValueError, match="empty"):
        px.backend([[0, 1], []], np.array([2, 2]))


@pytest.mark.parametrize("mode", ["gibbs", "pam"])
def test_evaluate_suite_native_equals_jax(mode):
    """The scale-0.1 suite (70 models): samples of both harnesses come
    from the same engine with the same seeds (the rep's suite index), so
    success rates are equal and fidelities and KLs agree to the exact
    tables' rounding."""
    num = 300 if mode == "gibbs" else 200
    got = harness.evaluate_suite(generate_suite(0.1), mode=mode,
                                 num_samples=num, native=True, device="cpu")
    want = jharness.evaluate_suite(jsuite.generate_suite(0.1), mode=mode,
                                   num_samples=num, native=True)
    assert len(got) == len(want) == 7
    for r, w in zip(got, want):
        assert r.graph == w.graph
        assert r.successes == w.successes == [num / 10_000] * 10
        np.testing.assert_allclose(r.fidelities, w.fidelities, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(r.kls, w.kls, rtol=0, atol=1e-5)
    assert harness.results_table(got) == jharness.results_table(want)
