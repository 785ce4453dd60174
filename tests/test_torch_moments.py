"""Port parity of the streaming sweeps: the plain versions of the
streaming-argmax kernel (TPU row 5) and the monomial-moments kernel (row
6), and ``models/moments.py`` / ``models/sample.py`` around them, against
the JAX package on the same numpy-seeded models (its Pallas kernels in
interpret mode on the CPU). MAP ids are equal and values agree within
1e-5; moments, probabilities and log masses within 1e-5 (float32 sweeps
summed in another order)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models import elimination as jelim  # noqa: E402
from qcmrf_tpu.models import moments as jmoments  # noqa: E402
from qcmrf_tpu.models import sample as jsample  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402

from qcmrf_tpu_torch.models import moments, sample  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf  # noqa: E402
from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from qcmrf_tpu_torch.parallel import sharded  # noqa: E402
from qcmrf_tpu_torch.utils import moebius  # noqa: E402

TOL = 1e-5


def _complete(n):
    return [[i, j] for i in range(n) for j in range(i + 1, n)]


def _random_cliques(n, draws, size, seed):
    rng = np.random.RandomState(seed)
    return [list(C) for C in sorted(
        {tuple(sorted(rng.choice(n, size, replace=False).tolist()))
         for _ in range(draws)})]


STRUCTURES = {
    "K10": _complete(10),
    "K12": _complete(12),
    # 14 variables: a chain with chords
    "chain14": [[i, i + 1] for i in range(13)] + [[0, 13], [2, 9], [4, 11]],
    # 3- and 4-variable cliques: JAX's Gram kernel with product lanes
    "size34": [[0, 1, 2], [2, 3, 4, 5], [5, 6, 7], [7, 8, 9, 0], [1, 6],
               [3, 10, 11]],
    # a 5-variable clique: JAX's XLA sweep
    "size5": [[0, 1, 2, 3, 4], [4, 5, 6], [6, 7, 8, 9, 10], [10, 0], [2, 8]],
    # 219 distinct 4-variable cliques over 12 variables, 516 monomials:
    # a wide structure, many lanes of JAX's Gram relayout
    "wide4": _random_cliques(12, 300, 4, 4),
    # 6 variables: below the kernel floor, the dense argmax in both
    "small": [[0, 1], [1, 2], [2, 3, 4], [4, 5]],
    # a variable in no clique (n set explicitly)
    "isolated": [[0, 1], [1, 2, 3], [3, 5], [5, 6], [6, 7], [7, 8], [8, 9]],
}


def models(name, seed=11, scale=0.4, beta=1.0):
    cliques = STRUCTURES[name]
    n = 1 + max(v for C in cliques for v in C)
    if name == "isolated":
        n += 1
    d = sum(1 << len(C) for C in cliques)
    theta = (-np.abs(np.random.RandomState(seed).randn(d))
             * scale).astype(np.float32)
    return (JMRF.create(cliques, theta=jnp.asarray(theta), beta=beta, n=n),
            MRF.create(cliques, theta=theta, beta=beta, n=n, device="cpu"))


# ---- row 5: the streaming argmax -------------------------------------------


@pytest.mark.parametrize("name", ["small", "K10", "K12", "chain14",
                                  "size34", "size5"])
def test_map_state_streaming_matches_jax(name):
    jm, m = models(name, scale=0.6)
    want_id, want_val = jkernels.map_state_streaming(jm)
    got_id, got_val = kernels.map_state_streaming(m)
    assert got_id == want_id
    assert abs(got_val - want_val) <= TOL
    coef = kernels.moebius_coefficients(m)[None]
    v, x = kernels.combine_map(*kernels.map_partials_reference(
        m.cliques, m.n, coef, m.beta))
    assert int(x[0]) == want_id and abs(float(v[0]) - want_val) <= TOL
    assert int(sample.map_state(m)) == int(jsample.map_state(jm))


def test_map_partials_blocks_and_ids():
    """The partials cover every state once: block p holds the ids of its
    slice, and a block's best is its slice's maximum."""
    _, m = models("chain14")
    coef = kernels.moebius_coefficients(m)[None]
    v, x = kernels.map_partials_reference(m.cliques, m.n, coef, m.beta)
    parts, per_part = kernels.lse_geometry(1 << m.n)
    assert v.shape == x.shape == (1, parts) and x.dtype == torch.int64
    lp = kernels.logpot_table_reference(m.cliques, m.n, coef, m.beta)[0]
    for p in range(parts):
        block = lp[p * per_part: (p + 1) * per_part]
        assert p * per_part <= int(x[0, p]) < (p + 1) * per_part
        assert float(v[0, p]) == float(block.max())
        assert int(x[0, p]) == p * per_part + int(torch.argmax(block))


@pytest.mark.parametrize("n", [8, 12, 14])
def test_map_ties_go_to_the_earliest_state(n):
    """Two alternating states tie exactly at 0 (dyadic theta): the earliest
    id wins, in the plain version, the combine and the dense path (n < 10),
    where the JAX kernel breaks ties by the lowest lane."""
    m = chain_mrf(n, theta=np.tile([-0.5, 0.0, 0.0, -0.5], n - 1),
                  device="cpu")
    early = int("01" * (n // 2), 2)
    sid, val = kernels.map_state_streaming(m)
    assert (sid, val) == (early, 0.0)
    coef = kernels.moebius_coefficients(m)[None]
    v, x = kernels.map_partials_reference(m.cliques, n, coef, m.beta)
    if x.shape[1] > 1:  # the two maxima lie in two blocks
        assert int(x[0].tolist().count(int("10" * (n // 2), 2))) == 1
    # reversed partials: the combine still returns the earliest id
    best, ids = kernels.combine_map(v.flip(-1), x.flip(-1))
    assert int(ids[0]) == early and float(best[0]) == 0.0


def test_map_state_clamped_matches_jax():
    for name in ("K12", "size5"):
        jm, m = models(name, scale=0.6, beta=1.7)
        for ev in ({}, {0: 1}, {0: 1, 5: 0, 9: 1},
                   {v: v & 1 for v in range(m.n)}):
            got = sample.map_state_clamped(m, ev)
            want = jsample.map_state_clamped(jm, ev)
            assert got[0] == want[0], ev
            assert abs(got[1] - want[1]) <= TOL, ev


# ---- row 6: the monomial-moments sweep ---------------------------------------


@pytest.mark.parametrize("name", ["K10", "K12", "size34", "size5",
                                  "isolated", "wide4"])
def test_clique_moments_streaming_matches_jax(name):
    # wide4 sums 219 cliques: a smaller theta keeps its log-potential
    # spread near the other structures'
    jm, m = models(name, scale=0.05 if name == "wide4" else 0.4)
    want = np.asarray(jmoments.clique_moments_streaming(jm))
    got = moments.clique_moments_streaming(m)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jelim.clique_marginals(jm)),
                               rtol=0, atol=TOL)


def test_monomial_moments_reference_is_the_masked_sum():
    """Each monomial's moment is the sum of p(x) over the states holding
    all its variables; the empty monomial sums to 1."""
    _, m = models("size5")
    coef = kernels.moebius_coefficients(m)[None]
    lnz = kernels.log_partition(m).reshape(1)
    masks = torch.from_numpy(moebius.monomial_masks(m.cliques, m.n))
    got = kernels.monomial_moments(m.cliques, m.n, coef, m.beta, lnz, masks)
    assert got.dtype == torch.float64 and got.shape == (1, masks.numel())
    p = torch.softmax(kernels.logpot_table_reference(
        m.cliques, m.n, coef, m.beta)[0].double(), dim=0)
    x = torch.arange(1 << m.n)
    for g, mask in enumerate(masks.tolist()):
        want = float(p[(x & mask) == mask].sum())
        assert abs(float(got[0, g]) - want) <= 1e-6, g
    assert abs(float(got[0, 0]) - 1.0) <= 1e-6


def test_monomial_layout_and_doubling_match_jax():
    for name in ("size34", "size5"):
        cl = tuple(tuple(C) for C in STRUCTURES[name])
        got, want = moebius.monomial_layout(cl), jmoments._monomial_layout(cl)
        assert got.subsets == want.subsets and got.cmaps == want.cmaps
        assert got.m == want.m
        mono = np.random.RandomState(1).rand(got.m)
        np.testing.assert_allclose(
            moebius.masks_from_monomials(torch.from_numpy(mono), cl).numpy(),
            np.asarray(jmoments._masks_from_monomials(
                jnp.asarray(mono, jnp.float32), cl)), rtol=0, atol=1e-6)


def test_streaming_moments_cap():
    cl = [[0, 1], [47, 1]]
    m = MRF.create(cl, theta=np.zeros(8), device="cpu")
    with pytest.raises(ValueError, match="n=47"):
        moments.clique_moments_streaming(m)


# ---- evidence and the streaming queries -------------------------------------

EVIDENCE = ({0: 1}, {0: 1, 5: 0}, {1: 0, 2: 1, 3: 1, 7: 0})


@pytest.mark.parametrize("name", ["K10", "size34", "isolated"])
def test_reduce_evidence_matches_jax(name):
    jm, m = models(name, beta=1.4)
    for ev in EVIDENCE + ({v: 1 for v in range(m.n)},):
        red, const = moments.reduce_evidence(m, ev)
        jred, jconst = jmoments.reduce_evidence(jm, ev)
        assert abs(float(const) - float(jconst)) <= 1e-6, ev
        if jred is None:
            assert red is None
            continue
        assert red.cliques == jred.cliques and red.n == jred.n
        assert red.beta == pytest.approx(float(jred.beta))
        np.testing.assert_array_equal(red.theta.numpy(),
                                      np.asarray(jred.theta))


@pytest.mark.parametrize("name", ["K10", "size5", "isolated"])
def test_clamped_streaming_queries_match_jax(name):
    jm, m = models(name, beta=1.4)
    np.testing.assert_allclose(
        float(moments.log_partition_streaming(m)),
        float(jmoments.log_partition_streaming(jm)), atol=TOL)
    for ev in EVIDENCE:
        np.testing.assert_allclose(
            float(moments.log_partition_clamped_streaming(m, ev)),
            float(jmoments.log_partition_clamped_streaming(jm, ev)),
            atol=TOL)
        for v, b in ((4, 1), (0, 0), (8, 1)):
            np.testing.assert_allclose(
                float(moments.conditional_prob_streaming(m, v, b, ev)),
                float(jmoments.conditional_prob_streaming(jm, v, b, ev)),
                atol=TOL)
        got = moments.clique_marginals_clamped_streaming(m, ev)
        want = np.asarray(jmoments.clique_marginals_clamped_streaming(jm,
                                                                      ev))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
        assert set(np.unique(got.numpy()[want == 0.0])) <= {0.0}
        for mv in ([0, 4], [2, 3, 6]):
            ga, gv = moments.marginal_map_streaming(m, mv, ev)
            wa, wv = jmoments.marginal_map_streaming(jm, mv, ev)
            assert ga == wa and abs(gv - wv) <= TOL, (mv, ev)


def test_embed_clamped_marginals_matches_jax():
    jm, m = models("size34")
    for ev in EVIDENCE:
        red, _ = moments.reduce_evidence(m, ev)
        rmom = np.random.RandomState(2).rand(red.dimension)
        np.testing.assert_allclose(
            moments.embed_clamped_marginals(m, ev, rmom).numpy(),
            np.asarray(jmoments.embed_clamped_marginals(jm, ev, rmom)),
            rtol=0, atol=1e-7)
    full = {v: 0 for v in range(m.n)}
    mu = moments.clique_marginals_clamped_streaming(m, full)
    np.testing.assert_array_equal(
        mu.numpy(), np.asarray(jmoments.clique_marginals_clamped_streaming(
            jm, full)))


# ---- the evidence clamp as one gather and one scatter -----------------------


def _loop_reduce(mrf, ev):
    """The per-clique reduction (each clique's table sliced, a cat, the
    constant added clique by clique), the oracle of the one gather:
    ``(cliques, n, theta, const)``, cliques and theta None when every
    variable is observed."""
    free = [v for v in range(mrf.n) if v not in ev]
    rank = {v: i for i, v in enumerate(free)}
    const = torch.zeros((), dtype=mrf.theta.dtype)
    cliques, thetas, off = [], [], 0
    for C in mrf.cliques:
        c = len(C)
        tab = mrf.theta[off: off + (1 << c)].reshape((2,) * c)
        tab = tab[tuple(ev[v] if v in ev else slice(None) for v in C)]
        scope = tuple(rank[v] for v in C if v not in ev)
        if scope:
            cliques.append(scope)
            thetas.append(tab.reshape(-1))
        else:
            const = const + tab.reshape(())
        off += 1 << c
    if not free:
        return None, 0, None, const
    if not cliques:
        cliques, thetas = [(0,)], [torch.zeros(2)]
    return tuple(cliques), len(free), torch.cat(thetas), const


def _loop_embed(mrf, ev, rmom):
    """The double loop that placed reduced moments back in the theta
    layout, the oracle of the one scatter."""
    out = np.zeros((mrf.dimension,), np.float64)
    off = roff = 0
    for C in mrf.cliques:
        c = len(C)
        surv = [s for s, v in enumerate(C) if v not in ev]
        base = 0
        for s, v in enumerate(C):
            if v in ev:
                base |= ev[v] << (c - 1 - s)
        if not surv:
            out[off + base] = 1.0
        else:
            m = len(surv)
            for j in range(1 << m):
                idx = base
                for t, s in enumerate(surv):
                    idx |= ((j >> (m - 1 - t)) & 1) << (c - 1 - s)
                out[off + idx] = rmom[roff + j]
            roff += 1 << m
        off += 1 << c
    return out


def _mixed_model(seed):
    """Cliques of every size 1-6 and a few more, variables in random slot
    order, over 6-11 variables; on odd seeds one or two more variables in
    no clique."""
    rng = np.random.RandomState(seed)
    used = int(rng.randint(6, 12))
    n = used + (seed % 2) * int(rng.randint(1, 3))
    sizes = list(range(1, 7)) + rng.randint(1, 7, rng.randint(0, 8)).tolist()
    cliques = [rng.choice(used, k, replace=False).tolist()
               for k in rng.permutation(sizes)]
    d = sum(1 << len(C) for C in cliques)
    theta = (rng.randn(d) * 3).astype(np.float32)
    return MRF.create(cliques, theta=theta, beta=0.8, n=n, device="cpu")


def _evidences(m, seed):
    """None, one, about half, all but one and every variable observed, and
    every clique variable observed (the free ones in no clique)."""
    rng = np.random.RandomState(seed + 100)
    in_cliques = sorted({v for C in m.cliques for v in C})
    sets = [[], [int(rng.randint(m.n))],
            rng.choice(m.n, m.n // 2, replace=False).tolist(),
            rng.choice(m.n, m.n - 1, replace=False).tolist(),
            list(range(m.n)), in_cliques]
    return [{int(v): int(rng.randint(2)) for v in vs} for vs in sets]


@pytest.mark.parametrize("seed", range(12))
def test_reduce_evidence_equals_the_per_clique_loop(seed):
    """One gather gives the loop's reduced theta and constant bit for bit,
    its cliques and n, and the zero-potential clique or None where the
    loop gives them; no evidence gives the model itself."""
    m = _mixed_model(seed)
    for ev in _evidences(m, seed):
        red, const = moments.reduce_evidence(m, ev)
        cliques, n, theta, want = _loop_reduce(m, ev)
        assert const.dtype == torch.float32 and const.shape == ()
        assert const.item() == want.item(), ev
        if cliques is None:
            assert red is None
            continue
        assert red.cliques == cliques and red.n == n, ev
        assert red.beta == m.beta and torch.equal(red.theta, theta), ev
        if not ev:
            assert red is m


@pytest.mark.parametrize("seed", range(12))
def test_embed_clamped_marginals_equals_the_per_clique_loop(seed):
    m = _mixed_model(seed)
    rng = np.random.RandomState(seed)
    for ev in _evidences(m, seed):
        red, _ = moments.reduce_evidence(m, ev)
        rmom = rng.rand(0 if red is None else red.dimension)
        got = moments.embed_clamped_marginals(m, ev, rmom)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), _loop_embed(m, ev, rmom).astype(np.float32))


def test_reduce_evidence_under_autograd_keeps_the_loops_gradient():
    """With theta requiring a gradient the constant is one differentiable
    sum: its value within float32 rounding of the loop's, the gradient
    through the reduced theta and the constant equal to the loop's."""
    m = _mixed_model(3)
    ev = _evidences(m, 3)[2]
    grads = []
    for reduce in (moments.reduce_evidence, None):
        theta = m.theta.clone().requires_grad_()
        mg = MRF(theta=theta, beta=m.beta, cliques=m.cliques, n=m.n)
        if reduce is None:
            _, _, rt, const = _loop_reduce(mg, ev)
        else:
            red, const = reduce(mg, ev)
            rt = red.theta
        w = torch.arange(rt.numel(), dtype=torch.float32)
        ((rt * w).sum() + 3 * const).backward()
        grads.append((theta.grad, float(const.detach())))
    assert torch.equal(grads[0][0], grads[1][0])
    assert grads[0][1] == pytest.approx(grads[1][1], rel=1e-6, abs=1e-6)


def test_clamp_tables_build_once_a_structure():
    """The clamp's tables are built once a structure (the
    ``clamp_table_build`` counter): a new theta on the same cliques, new
    evidence and the scatter reuse them."""
    from torch.autograd import profiler

    from qcmrf_tpu_torch.utils import profiling

    a, b = _mixed_model(0), _mixed_model(1)
    a2 = MRF.create(a.cliques, theta=-a.theta, n=a.n, device="cpu")
    moments._clamp_tables.cache_clear()
    with profiler.profile(use_kineto=True):
        for m in (a, b, a2, b, a):
            for ev in _evidences(m, 0)[1:]:
                red, _ = moments.reduce_evidence(m, ev)
                moments.embed_clamped_marginals(
                    m, ev, np.zeros(0 if red is None else red.dimension))
    assert profiling.session_counts()["clamp_table_build"] == 2


def _aten_calls(fn) -> int:
    from torch.autograd import profiler

    with profiler.profile(use_kineto=True) as prof:
        fn()
    return sum(e.name.startswith("aten::") for e in prof.function_events)


@pytest.mark.parametrize("observed", [0, 1, 4, 13, 27])
def test_reduce_evidence_dispatches_a_few_ops_at_k27(observed):
    """At K27 (351 cliques) a reduction calls at most 25 of PyTorch's
    operators whatever the evidence, where the per-clique loop called
    over a thousand."""
    m = MRF.create(_complete(27), theta=np.random.RandomState(0).randn(1404),
                   device="cpu")
    ev = {v: v % 2 for v in range(observed)}
    moments.reduce_evidence(m, ev)
    assert _aten_calls(lambda: moments.reduce_evidence(m, ev)) <= 25
    if observed == 4:
        assert _aten_calls(lambda: _loop_reduce(m, ev)) > 1000


def test_unported_options_name_their_slices():
    """The mesh arguments (slice 6a) answer as without a mesh: the lnZ,
    MAP and PAM sweeps bit for bit, the moments within 1e-6 (the sharded
    route takes lnZ, then the moments for it, as JAX's; the single route
    one fused sweep); the gate-level sharded engine (slice 6b) runs on the
    same mesh: an H wall's shards gather to the uniform state."""
    _, m = models("K10")
    mesh = sharded.make_mesh(4, device="cpu")
    for fn, args in ((moments.log_partition_streaming, (m,)),
                     (moments.log_partition_clamped_streaming, (m, {1: 0})),
                     (moments.marginal_map_streaming, (m, [0])),
                     (sample.map_state_clamped, (m, {2: 1}))):
        assert fn(*args, mesh=mesh) == fn(*args)
    np.testing.assert_allclose(
        moments.clique_marginals_clamped_streaming(m, {0: 1}, mesh=mesh),
        moments.clique_marginals_clamped_streaming(m, {0: 1}),
        rtol=0, atol=1e-6)
    assert moments.conditional_prob_streaming(m, 0, 1, {}, mesh=mesh) == \
        moments.conditional_prob_streaming(m, 0, 1, {})
    assert torch.equal(
        sample.sample_conditional(0, m, 4, {0: 1}, method="pam", mesh=mesh),
        sample.sample_conditional(0, m, 4, {0: 1}, method="pam"))
    from qcmrf_tpu_torch.circuits.ir import Circuit

    wall = Circuit(6)
    for q in range(6):
        wall.h(q)
    re, im = sharded.run_statevector_sharded(wall, mesh)
    assert len(re) == 4
    torch.testing.assert_close(sharded.gather(re),
                               torch.full((64,), 0.125), rtol=0, atol=1e-7)
    assert not sharded.gather(im).any()
