"""The port's sharded sweeps (``qcmrf_tpu_torch.parallel.sharded``, slice
6a) on ``Mesh((cpu,) * 8)`` and ``(cpu,) * 4`` against the JAX package's
sharded functions on its 8 virtual CPU devices (tests/test_sharded.py's
sweep tests), the same numpy-seeded models on both sides; the plain
versions at a nonzero ``x0_blocks`` against JAX's Pallas kernels at the
same first state, interpreted; and the ``--mesh`` routes of the infer and
train CLIs and of AIS (tests/test_infer_cli.py, test_train_cli.py,
test_ais.py). Tolerances are stated in each test."""

import itertools
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models import elimination as jelim  # noqa: E402
from qcmrf_tpu.models import moments as jmoments  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402
from qcmrf_tpu.parallel import sharded as jsharded  # noqa: E402
from qcmrf_tpu.runners import infer_cli as jinfer  # noqa: E402
from qcmrf_tpu.runners import train_cli as jtrain_cli  # noqa: E402

from qcmrf_tpu_torch.models import ais, elimination, moments  # noqa: E402
from qcmrf_tpu_torch.models import sample as msample  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from qcmrf_tpu_torch.parallel import sharded  # noqa: E402
from qcmrf_tpu_torch.runners import infer_cli, train_cli  # noqa: E402
from qcmrf_tpu_torch.utils import moebius  # noqa: E402

CPU = torch.device("cpu")


def models(cliques, seed=0, scale=0.4):
    """The same model in both packages: theta = -|randn(seed)| * scale."""
    probe = JMRF.create(cliques)
    theta = (-np.abs(np.random.RandomState(seed).randn(probe.dimension))
             * scale).astype(np.float32)
    jm = JMRF.create(cliques, theta=jnp.asarray(theta))
    return jm, MRF.from_numpy(jm.cliques, theta, 1.0, jm.n, device=CPU)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return jsharded.make_mesh(8)


@pytest.fixture(scope="module")
def mesh8():
    return sharded.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def mesh4():
    return sharded.Mesh((CPU,) * 4)


def test_mesh_helpers(mesh8, mesh4):
    """make_mesh repeats the host; _dlog refuses a mesh not a power of
    two; fit_mesh drops a mesh larger than the model; a 2-D mesh
    flattens (JAX's helpers, sharded.py:55-119)."""
    assert mesh8.size == 8 and mesh8.shape == {"amp": 8}
    assert sharded._dlog(mesh4) == 2
    with pytest.raises(ValueError, match="power-of-two"):
        sharded._dlog(sharded.Mesh((CPU,) * 3))
    assert sharded.fit_mesh(mesh8, 3) is mesh8
    assert sharded.fit_mesh(mesh8, 2) is None and sharded.fit_mesh(None, 9) \
        is None
    m2 = sharded.device_mesh((4, 2), ("amp", "data"), "cpu")
    assert m2.shape == {"amp": 4, "data": 2}
    assert m2.axis_devices("data") == (CPU, CPU)
    flat = sharded._sweep_mesh(m2)
    assert flat.axis_names == ("sweep",) and flat.size == 8
    # the sweep's blocks divide over the shards from n = 13 (8 blocks) on
    assert not sharded._use_slice_kernel(12, 3)
    assert sharded._use_slice_kernel(13, 3)
    assert [s[1:] for s in sharded._shards(mesh4, 14)] == [
        (0, 4), (4, 4), (8, 4), (12, 4)]


def test_mesh_from_spec():
    """The CLIs' ``--mesh AxB`` (JAX train_cli.py:45-57): a 2-D (amp,
    data) mesh of A * B devices, the host repeated on the CPU; a spec that
    is not AxB exits with the reason."""
    assert sharded.visible_devices("cpu") == (CPU,)
    m = sharded.mesh_from_spec("4x2", "cpu")
    assert m.shape == {"amp": 4, "data": 2} and m.devices == (CPU,) * 8
    for bad in ("4", "4x", "axb", "2x2x2"):
        with pytest.raises(SystemExit, match="expected AxB"):
            sharded.mesh_from_spec(bad, "cpu")


def test_sharded_log_partition(jmesh8, mesh8):
    """lnZ of the 4x4 grid: the port's sharded sweep equals its one-device
    sweep bit for bit and JAX's sharded lnZ within rtol 1e-5."""
    jm, m = models([[r * 4 + c, r * 4 + c + 1] for r in range(4)
                    for c in range(3)]
                   + [[r * 4 + c, r * 4 + c + 4] for r in range(3)
                      for c in range(4)], seed=1, scale=0.3)
    got = sharded.sharded_log_partition(m, mesh8)
    assert torch.equal(got, kernels.log_partition(m))
    assert np.isclose(float(got), float(jsharded.sharded_log_partition(
        jm, jmesh8)), rtol=1e-5)


def test_sharded_gibbs_probs_and_success_rate(jmesh8, mesh8):
    """The sharded table's softmax against JAX's (rtol 1e-4, atol 1e-8);
    the success rate rtol 1e-4."""
    jm, m = models([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6]], seed=2)
    np.testing.assert_allclose(
        sharded.sharded_gibbs_probs(m, mesh8).numpy(),
        np.asarray(jsharded.sharded_gibbs_probs(jm, jmesh8)),
        rtol=1e-4, atol=1e-8)
    jm3, m3 = models([[0, 1], [1, 2], [2, 3]], seed=3)
    assert np.isclose(float(sharded.sharded_success_rate(m3, mesh8)),
                      float(jsharded.sharded_success_rate(jm3, jmesh8)),
                      rtol=1e-4)


def test_sharded_sampling_distribution(mesh8):
    """80 000 shots over 8 shards: the acceptance within 0.01 of Z/2^n and
    the accepted shots' law within 0.015 of the Gibbs law (the JAX pin's
    bars: JAX splits keys, the port gives shard d Philox stream d)."""
    _, m = models([[0, 1], [1, 2]], seed=4)
    x, acc = sharded.sharded_sample_postselected(0, m, mesh8, 80_000)
    assert x.shape == acc.shape == (80_000,)
    assert np.isclose(float(acc.float().mean()), float(m.success_rate()),
                      atol=0.01)
    emp = np.bincount(x[acc].numpy(), minlength=m.num_states) / int(acc.sum())
    np.testing.assert_allclose(emp, m.gibbs_probs().numpy(), atol=0.015)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        sharded.sharded_sample_postselected(0, m, mesh8, 1001)


def test_sharded_estimate_delta_fused(mesh8):
    """4 rounds of 40 000 shots: each within 0.02 of Z/2^n, not all equal
    (JAX's pin)."""
    _, m = models([[0, 1], [1, 2]], seed=4)
    deltas = sharded.sharded_estimate_delta(1, m, mesh8, 40_000, 4).numpy()
    assert deltas.shape == (4,)
    np.testing.assert_allclose(deltas, float(m.success_rate()), atol=0.02)
    assert len(np.unique(deltas)) > 1


@pytest.mark.parametrize("case", ["kernel", "fallback", "tiny"])
def test_sharded_map_state(jmesh8, mesh8, case):
    """The sharded MAP: n = 14 (JAX's kernel path) equal to JAX's sharded
    id, value within 1e-4; n = 20 (JAX's table fallback) and n = 6 (shards
    of 8 states) equal to the table's argmax, values within 1e-4 and
    1e-5. The port's id equals its one-device sweep's everywhere."""
    cl, seed, tol = {
        "kernel": ([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 8], [8, 9, 10],
                    [10, 11, 12], [12, 13]], 9, 1e-4),
        "fallback": ([[i, i + 1] for i in range(19)], 10, 1e-4),
        "tiny": ([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]], 11, 1e-5)}[case]
    jm, m = models(cl, seed=seed, scale=0.6)
    got_id, got_val = sharded.sharded_map_state(m, mesh8)
    want_id, want_val = jsharded.sharded_map_state(jm, jmesh8)
    assert got_id == want_id and abs(got_val - want_val) < tol
    assert (got_id, got_val) == kernels.map_state_streaming(m)


def test_sharded_clique_moments(jmesh8, mesh8, monkeypatch):
    """The sharded moments sweep against JAX's sharded sweep and
    elimination (rtol 1e-5, atol 1e-7): n = 6, and n = 9 (JAX forced to
    several blocks a device, its scan path)."""
    jm, m = models([[0, 1, 2], [2, 3], [3, 4, 5], [0, 5], [1, 4]], seed=11,
                   scale=0.7)
    got = sharded.sharded_clique_moments(m, mesh8).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jsharded.sharded_clique_moments(jm, jmesh8)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, np.asarray(jelim.clique_marginals(jm)),
                               rtol=1e-5, atol=1e-7)
    monkeypatch.setattr(jmoments, "_CHUNK_BITS", 3)
    jm, m = models([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7],
                    [7, 8], [0, 8]], seed=12, scale=0.5)
    np.testing.assert_allclose(
        sharded.sharded_clique_moments(m, mesh8).numpy(),
        np.asarray(jsharded.sharded_clique_moments(jm, jmesh8)),
        rtol=1e-5, atol=1e-7)


def test_sharded_streaming_lnz_grad(jmesh8, mesh8):
    """Value and gradient of the mesh-sharded differentiable lnZ against
    JAX's ``jax.value_and_grad`` through its sharded lnZ: rtol 1e-5; the
    gradient rtol 1e-4, atol 1e-6."""
    jm, m = models([[0, 1, 2], [2, 3], [3, 4, 0]], seed=13, scale=0.6)
    v_want, g_want = jax.value_and_grad(
        lambda t: jmoments.log_partition_streaming(jm.with_theta(t),
                                                   mesh=jmesh8))(jm.theta)
    theta = m.theta.clone().requires_grad_()
    v = moments.log_partition_streaming(m.with_theta(theta), mesh=mesh8)
    v.backward()
    assert np.isclose(float(v.detach()), float(v_want), rtol=1e-5)
    np.testing.assert_allclose(theta.grad.numpy(), np.asarray(g_want),
                               rtol=1e-4, atol=1e-6)


def test_multi_axis_mesh_flattened():
    """A 2-D (amp, data) mesh of 4 x 2 gives the 1-D mesh's sweeps (JAX's
    pin): lnZ and moments against elimination (rtol 1e-5, atol 1e-7), the
    MAP id equal to the 8-device mesh's, the differentiable lnZ too."""
    jm, m = models([[0, 1, 2], [2, 3], [3, 4, 5], [0, 5]], seed=17,
                   scale=0.6)
    mesh2d = sharded.device_mesh((4, 2), ("amp", "data"), "cpu")
    lnz = float(sharded.sharded_log_partition(m, mesh2d))
    assert np.isclose(lnz, float(jelim.log_partition(jm)), rtol=1e-5)
    np.testing.assert_allclose(
        sharded.sharded_clique_moments(m, mesh2d).numpy(),
        np.asarray(jelim.clique_marginals(jm)), rtol=1e-5, atol=1e-7)
    assert sharded.sharded_map_state(m, mesh2d) == sharded.sharded_map_state(
        m, sharded.make_mesh(8, device="cpu"))
    assert np.isclose(float(moments.log_partition_streaming(m, mesh2d)),
                      lnz, rtol=1e-6)


def test_sharded_fused_lnz_and_moments(jmesh8, mesh8):
    """The sharded fused sweep against JAX's sharded fused sweep and
    elimination: a 12-ring with chords (JAX's Gram kernel) lnZ rtol 1e-6,
    moments rtol 1e-5 and atol 1e-6; size-3 cliques and a 5-variable
    clique (JAX's two-sweep fallback) likewise; the sharded lnZ's
    gradient is beta * moments. The port's sharded answer equals its
    one-device sweep bit for bit."""
    cases = ([[i, (i + 1) % 12] for i in range(12)] + [[0, 6], [3, 9]],
             [[i, (i + 1) % 12] for i in range(12)] + [[0, 4, 8],
                                                      [1, 5, 9]],
             [[0, 1, 2, 3, 4], [4, 5], [5, 6]])
    for seed, cl in zip((23, 24, 25), cases):
        jm, m = models(cl, seed=seed, scale=0.5)
        lnz, mu = sharded.sharded_lnz_and_moments(m, mesh8)
        jl, jmu = jsharded.sharded_lnz_and_moments(jm, jmesh8)
        assert np.isclose(float(lnz), float(jl), rtol=1e-6)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(mu.numpy(), np.asarray(
            jelim.clique_marginals(jm)), rtol=1e-5, atol=1e-6)
        one = kernels.lnz_and_moments(m.cliques, m.n, m.theta, m.beta)
        assert torch.equal(lnz, one[0]) and torch.equal(mu, one[1])
        theta = m.theta.clone().requires_grad_()
        moments.log_partition_streaming(m.with_theta(theta),
                                        mesh8).backward()
        np.testing.assert_allclose(theta.grad.numpy(), m.beta * mu.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_sharded_clamped_conditional(jmesh8, mesh8):
    """Clamped log-mass and a conditional with the sweep sharded, against
    JAX's with its mesh: rtol 1e-6 and 1e-5."""
    cl = [[i, i + 1] for i in range(12)] + [[0, 5, 9]]
    jm, m = models(cl, seed=28, scale=0.5)
    ev = {0: 1, 5: 0}
    got = float(moments.log_partition_clamped_streaming(m, ev, mesh8))
    assert np.isclose(got, float(jmoments.log_partition_clamped_streaming(
        jm, ev, jmesh8)), rtol=1e-6)
    p = float(moments.conditional_prob_streaming(m, 3, 1, ev, mesh8))
    assert np.isclose(p, float(jmoments.conditional_prob_streaming(
        jm, 3, 1, ev, jmesh8)), rtol=1e-5)


def test_sharded_clamped_map_and_sampling(jmesh8, mesh8):
    """Evidence-constrained MAP sharded: the id equal to JAX's sharded
    one, value rtol 1e-5; conditional PAM sharded equal to the port's
    one-device draws from the same seed (JAX's samples agree with the
    port's in distribution only: ROADMAP.md §3)."""
    from qcmrf_tpu.models import sample as jsample

    cl = [[i, i + 1] for i in range(12)] + [[0, 5, 9]]
    jm, m = models(cl, seed=28, scale=0.5)
    ev = {0: 1, 5: 0}
    gid, gval = msample.map_state_clamped(m, ev, mesh8)
    jid, jval = jsample.map_state_clamped(jm, ev, jmesh8)
    assert gid == jid and np.isclose(gval, jval, rtol=1e-5)
    assert (gid, gval) == msample.map_state_clamped(m, ev)
    single = msample.sample_conditional(11, m, 4, ev, method="pam")
    got = msample.sample_conditional(11, m, 4, ev, method="pam", mesh=mesh8)
    assert torch.equal(got, single)


def test_sharded_sample_pam(mesh4, mesh8):
    """Sharded perturb-and-MAP equal to the one-device streaming sampler
    from one generator seed, on 8 and on 4 shards, and for a model whose
    blocks do not divide over the mesh (n = 9, the whole sweep on the
    first device)."""
    _, m = models([[i, i + 1] for i in range(13)] + [[0, 6], [3, 10]],
                  seed=26, scale=0.6)
    single = msample.sample_pam_streaming(9, m, 5)
    for mesh in (mesh8, mesh4):
        assert torch.equal(sharded.sharded_sample_pam(9, m, mesh, 5), single)
    _, small = models([[i, i + 1] for i in range(8)], seed=27)
    assert torch.equal(sharded.sharded_sample_pam(9, small, mesh8, 10),
                       msample.sample_pam_streaming(9, small, 10))


def test_sharded_shot_moments(mesh4):
    """Shot moments over 4 shards: delta-hat within 5 binomial sigma of
    Z/2^n and every marginal within 5 sigma of the exact one, 200 000
    shots."""
    _, m = models([[0, 1], [1, 2], [2, 3]], seed=5)
    shots = 200_000
    marg, delta = sharded.sharded_shot_moments(3, m, mesh4, shots)
    d = float(m.success_rate())
    assert abs(delta - d) <= 5 * np.sqrt(d * (1 - d) / shots)
    mu = elimination.clique_marginals(m).double().numpy()
    sig = np.sqrt(mu * (1 - mu) / (delta * shots))
    assert np.all(np.abs(marg.numpy() - mu) <= 5 * sig + 1e-12)


def test_table_slice_past_2_31():
    """JAX refuses a table slice past 2^31 states (its int32 state-unit
    offset); the port's offsets are 64-bit. A 34-variable chain's table
    over one block starting past 2^33 against numpy's per-state sum in
    float64 (1e-5), and the split's plain version at the same offset
    within split_gap."""
    jm, m = models([[i, i + 1] for i in range(33)], seed=5, scale=0.3)
    coef = kernels.moebius_coefficients(m)[None]
    x0 = kernels.lse_geometry(1 << 34)[0] - 2
    got = kernels.logpot_table(m.cliques, 34, coef, 1.0, False, x0, 1)[0]
    per = kernels.lse_geometry(1 << 34)[1]
    ids = np.arange(x0 * per, (x0 + 1) * per, dtype=np.int64)
    assert ids[0] > 1 << 31
    theta = m.theta.double().numpy()
    want = np.zeros(len(ids))
    for k in range(33):
        y = (((ids >> (33 - k)) & 1) << 1) | ((ids >> (32 - k)) & 1)
        want += theta[4 * k + y]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    split = kernels.logpot_table_split_reference(m.cliques, 34, coef, 1.0,
                                                 False, x0, 1)[0]
    assert float((split - got).abs().max()) <= float(
        kernels.split_gap(coef, 1.0)[0])


def test_plain_versions_at_an_offset_match_pallas():
    """The plain versions over blocks 4-5 of a 14-variable sweep (first
    state 4096, 2048 states) against JAX's Pallas kernels at the same
    first state, interpreted: the table within 1e-5, lnZ of the range
    rtol 1e-6, the MAP id equal (value within 1e-5), the moments for a
    given lnZ and the fused lnZ + moments of the range within 1e-5 (JAX's
    Gram kernels)."""
    from qcmrf_tpu.models import moments as M

    cl = [[i, (i + 1) % 14] for i in range(14)] + [[0, 7]]
    jm, m = models(cl, seed=31, scale=0.5)
    n, chunk, start = 14, 2048, 4096
    x0, blocks = 4, 2
    assert x0 * kernels.lse_geometry(1 << n)[1] == start
    coef = kernels.moebius_coefficients(m)[None]
    jcoef = jkernels._moebius_coefficients(jm)
    beta = jnp.ones((1,), jnp.float32)
    table = jkernels._logpot_call_sized(jm.cliques, n, False, chunk, jcoef,
                                        beta, jnp.asarray([start],
                                                          jnp.int32))
    np.testing.assert_allclose(
        kernels.logpot_table(m.cliques, n, coef, 1.0, False, x0,
                             blocks)[0].numpy(),
        np.asarray(table).reshape(-1), rtol=0, atol=1e-5)
    jb = start // jkernels.lse_block_states(jm.cliques, n, chunk)
    jl = jkernels._combine_lse(*jkernels._lse_partials_call(
        jm.cliques, n, chunk, jcoef, beta, jnp.asarray([jb], jnp.int32)))
    lnz_range = kernels.combine_lse(*kernels.lse_partials(
        m.cliques, n, coef, 1.0, x0, blocks))
    assert np.isclose(float(lnz_range[0]), float(jl), rtol=1e-6)
    jb = start // jkernels.map_block_states(jm.cliques, n, chunk)
    out = jkernels._map_partials_call(jm.cliques, n, chunk, jcoef, beta,
                                      jnp.asarray([jb], jnp.int32))
    jid, jval = jkernels.map_partials_decode(jm.cliques, n, chunk, out)
    v, x = kernels.combine_map(*kernels.map_partials(
        m.cliques, n, coef, 1.0, None, x0, blocks))
    assert int(x[0]) == jid and abs(float(v[0]) - jval) <= 1e-5

    gram = M._gram_layout(jm.cliques)
    assert M._use_gram_kernel(gram, n, chunk)
    layout = M._monomial_layout(jm.cliques)
    coef_mono = M._coef_mono(M._beta_coef(jm), layout)
    Q, E, lsh, grow, hsh, S1, S2 = M._gram_kernel_inputs(gram, coef_mono, n,
                                                         chunk)
    jb = jnp.asarray([start // jkernels.gram_block_states(gram.width,
                                                          chunk)],
                     jnp.int32)
    lnz = kernels.log_partition(m)
    G = jkernels.gram_moments_call(gram.width, Q, E,
                                   jnp.asarray([float(lnz)], jnp.float32),
                                   chunk, jb, lsh, grow, hsh, S1, S2)
    want = np.asarray(M._masks_from_monomials(
        M._mono_from_G(G, gram, layout.m, chunk), jm.cliques))
    masks = moebius.device_masks(m.cliques, n, CPU)
    mono = kernels.monomial_moments(m.cliques, n, coef, 1.0,
                                    lnz.float()[None], masks, x0, blocks)[0]
    np.testing.assert_allclose(
        moebius.masks_from_monomials(mono, m.cliques).numpy(), want,
        rtol=0, atol=1e-5)
    G, Md = jkernels.gram_lse_moments_call(gram.width, Q, E, chunk, jb, lsh,
                                           grow, hsh, S1, S2)
    jmono = M._mono_from_G(G, gram, layout.m, chunk)
    jz = float(Md) + float(np.log(jmono[0]))
    got_z, got_mono = kernels.combine_lnz_moments(
        *kernels.lnz_moments_partials(m.cliques, n, coef, 1.0, masks, x0,
                                      blocks))
    assert np.isclose(float(got_z[0]), jz, rtol=1e-6)
    np.testing.assert_allclose(
        moebius.masks_from_monomials(got_mono[0], m.cliques).numpy(),
        np.asarray(M._masks_from_monomials(jmono / jmono[0], jm.cliques)),
        rtol=0, atol=1e-5)


# ---- the CLIs' --mesh --------------------------------------------------------


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """test_infer_cli.py's model: a 6-variable structure wider than the
    toy elimination routes need, as a fitted_model.json."""
    cl = [[0, 1, 2], [2, 3], [3, 4, 5], [0, 5], [1, 4]]
    jm, _ = models(cl, seed=3, scale=0.5)
    path = tmp_path_factory.mktemp("m") / "model.json"
    path.write_text(json.dumps({"cliques": cl,
                                "theta": np.asarray(jm.theta).tolist()}))
    return str(path), jm


def _port(path, *argv):
    return infer_cli.main(["--model", path, "--platform", "cpu", *argv])


def test_infer_mesh_matches_single_device(model_file):
    """``--mesh 4x2``: lnZ rtol 1e-5 against elimination, marginals under
    evidence within 2e-5 of the clamped streaming marginals, mmap equal
    (JAX's pin, tests/test_infer_cli.py:95), and each answer against the
    JAX CLI's with its mesh."""
    path, jm = model_file
    r = _port(path, "--query", "lnz", "--mesh", "4x2")
    assert r["backend"] == "streaming"
    assert np.isclose(r["lnz"], float(jelim.log_partition(jm)), rtol=1e-5)
    r = _port(path, "--query", "marginals", "--mesh", "4x2", "--evidence",
              "2=1")
    want = np.asarray(jmoments.clique_marginals_clamped_streaming(
        jm, {2: 1}), np.float64)
    np.testing.assert_allclose(np.asarray(r["marginals"]), want, atol=2e-5)
    argv = ["--query", "mmap", "--max-vars", "0,4", "--mesh", "4x2",
            "--evidence", "2=1"]
    r = _port(path, *argv)
    want_a, want_v = jelim.marginal_map(jm, [0, 4], {2: 1})
    assert r["max_vars"] == {str(v): b for v, b in want_a.items()}
    assert np.isclose(r["log_mass"], want_v, rtol=1e-5)
    j = jinfer.main(["--model", path] + argv)
    assert r["max_vars"] == j["max_vars"] and r["backend"] == j["backend"]


def test_infer_tiny_model_with_mesh_drops_to_single_device():
    """A model smaller than the mesh (n = 2 on 8 devices) answers on one
    device, marginals within 2e-5 (tests/test_infer_cli.py:112)."""
    r = infer_cli.main(["--graph", "chain:2", "--query", "marginals",
                        "--mesh", "4x2", "--platform", "cpu"])
    want = np.asarray(jmoments.clique_marginals_clamped_streaming(
        JMRF.create([[0, 1]]), {}), np.float64)
    np.testing.assert_allclose(np.asarray(r["marginals"]), want, atol=2e-5)


def test_infer_mesh_does_not_change_sampler(model_file):
    """``--mesh`` shards PAM only: an exact request stays exact, says so,
    and draws what it draws without a mesh (tests/test_infer_cli.py:227);
    ``--method pam`` with a mesh draws the one-device samples."""
    path, _ = model_file
    r = _port(path, "--query", "sample", "--method", "exact", "--mesh",
              "2x1", "--num-samples", "4", "--sample-seed", "7")
    assert r["method"] == "exact" and "single-device" in r["note"]
    single = _port(path, "--query", "sample", "--method", "exact",
                   "--num-samples", "4", "--sample-seed", "7")
    assert r["samples"] == single["samples"]
    pam = [_port(path, "--query", "sample", "--method", "pam",
                 "--num-samples", "6", "--sample-seed", "7", *mesh)
           for mesh in ((), ("--mesh", "2x2"))]
    assert pam[0]["samples"] == pam[1]["samples"]


def test_infer_mesh_smaller_than_reduced_model(model_file):
    """Evidence leaves 2 free variables on an 8-device mesh: every query
    answers on one device, against elimination (rtol 1e-5, marginals
    2e-5; tests/test_infer_cli.py:287)."""
    path, jm = model_file
    ev, evd = "0=1,2=0,3=1,5=0", {0: 1, 2: 0, 3: 1, 5: 0}
    r = _port(path, "--query", "lnz", "--mesh", "4x2", "--evidence", ev)
    assert np.isclose(r["log_mass"],
                      float(jelim.log_partition_clamped(jm, evd)), rtol=1e-5)
    r = _port(path, "--query", "marginals", "--mesh", "4x2", "--evidence",
              ev)
    np.testing.assert_allclose(
        np.asarray(r["marginals"]),
        np.asarray(jmoments.clique_marginals_clamped_streaming(jm, evd)),
        atol=2e-5)
    r = _port(path, "--query", "prob", "--of", "1=1", "--mesh", "4x2",
              "--evidence", ev)
    assert np.isclose(r["prob"], float(jelim.conditional_prob(jm, 1, 1,
                                                              evd)),
                      rtol=1e-5)
    r = _port(path, "--query", "map", "--mesh", "4x2", "--evidence", ev)
    assert r["state_bits"][0] == 1 and r["state_bits"][2] == 0


def _train(outdir, *argv):
    out = train_cli.main(["--graph", "chain:5", "--samples", "4096",
                          "--platform", "cpu", "--outdir", str(outdir),
                          *argv])
    with open(out) as f:
        return json.load(f)


def test_train_mesh_matches_single_device(tmp_path):
    """``--mesh 4x2`` (lnZ over amp, the batch over data) lands on the
    one-device fit within 5e-3 after 60 steps (tests/test_train_cli.py:34),
    and on the JAX CLI's --mesh 4x2 fit of the same --data file within
    5e-3."""
    a = _train(tmp_path / "single", "--steps", "60")
    b = _train(tmp_path / "mesh", "--steps", "60", "--mesh", "4x2")
    np.testing.assert_allclose(a["theta"], b["theta"], atol=5e-3)
    data = str(tmp_path / "single" / "data.json")
    c = _train(tmp_path / "pm", "--steps", "60", "--mesh", "4x2", "--data",
               data)
    jout = jtrain_cli.main(["--graph", "chain:5", "--steps", "60", "--mesh",
                            "4x2", "--data", data, "--platform", "cpu",
                            "--outdir", str(tmp_path / "jm")])
    with open(jout) as f:
        j = json.load(f)
    np.testing.assert_allclose(c["theta"], j["theta"], atol=5e-3)


def test_shots_gradient_sharded_mesh(tmp_path):
    """``--grad shots --mesh 4x2``: the draws over all 8 devices; the fit
    leaves the init plateau (NLL < 3.2) and lands within 0.35 of the
    one-device shot fit (tests/test_train_cli.py:114); shots that do not
    divide over the mesh exit."""
    common = ["--steps", "60", "--checkpoint-every", "60", "--grad",
              "shots", "--grad-shots", "8192"]
    a = _train(tmp_path / "single", *common)
    b = _train(tmp_path / "mesh", *common, "--mesh", "4x2")
    assert b["final_nll"] < 3.2
    np.testing.assert_allclose(b["theta"], a["theta"], atol=0.35)
    with pytest.raises(SystemExit):
        _train(tmp_path / "m", "--steps", "2", "--grad", "shots",
               "--grad-shots", "4097", "--mesh", "2x1")


def test_big_wide_mesh_training(tmp_path, monkeypatch):
    """Past the big-n threshold on a wide structure, ``--mesh 4x2`` trains
    through the sharded streaming lnZ and matches the one-device fit
    (rtol 1e-4 on theta and the final NLL; tests/test_train_cli.py:205)."""
    from qcmrf_tpu_torch.models import capability

    monkeypatch.setenv("QCMRF_BIG_N_THRESHOLD", "8")
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 3)
    k10 = tmp_path / "k10.json"
    k10.write_text(json.dumps(
        [list(p) for p in itertools.combinations(range(10), 2)]))
    bits = (np.random.RandomState(3).rand(64, 10) < 0.4).astype(int)
    dataf = tmp_path / "bits.json"
    dataf.write_text(json.dumps(bits.tolist()))
    common = ["--graph", str(k10), "--data", str(dataf), "--steps", "6",
              "--lr", "0.2", "--platform", "cpu"]
    fm = json.load(open(train_cli.main(
        common + ["--mesh", "4x2", "--outdir", str(tmp_path / "mesh")])))
    fs = json.load(open(train_cli.main(
        common + ["--outdir", str(tmp_path / "single")])))
    assert np.isfinite(fm["final_nll"])
    assert np.isclose(fm["final_nll"], fs["final_nll"], rtol=1e-4)
    np.testing.assert_allclose(fm["theta"], fs["theta"], rtol=1e-4,
                               atol=1e-6)


def test_ais_mesh_sharded_chains(mesh8):
    """AIS on a 3x3 grid with 256 chains over 8 shards: lnZ within
    max(4 stderr, 0.03) of exact, (256,) log-weights, the same estimate
    twice and as on one device (the same chains), marginals within 0.12
    (tests/test_ais.py:227); 100 chains do not divide over 8."""
    cl = [[r * 3 + c, r * 3 + c + 1] for r in range(3) for c in range(2)] \
        + [[r * 3 + c, r * 3 + c + 3] for r in range(2) for c in range(3)]
    jm, m = models(cl, seed=7, scale=0.4)
    exact = float(jelim.log_partition(jm))
    lnz, diag = ais.ais_log_partition(0, m, num_chains=256, num_temps=96,
                                      return_diagnostics=True, mesh=mesh8)
    assert abs(float(lnz) - exact) < max(4 * float(diag["stderr"]), 0.03)
    assert diag["log_weights"].shape == (256,)
    assert float(ais.ais_log_partition(0, m, num_chains=256, num_temps=96,
                                       mesh=mesh8)) == float(lnz)
    assert torch.equal(lnz, ais.ais_log_partition(0, m, num_chains=256,
                                                  num_temps=96))
    mu = ais.ais_clique_marginals(0, m, num_chains=256, num_temps=96,
                                  mesh=mesh8).numpy()
    assert np.allclose(mu.reshape(-1, 4).sum(1), 1.0, atol=1e-5)
    assert np.max(np.abs(mu - np.asarray(jelim.clique_marginals(jm)))) < 0.12
    with pytest.raises(ValueError):
        ais.ais_log_partition(0, m, num_chains=100, mesh=mesh8)
