"""Port parity of the plane engine: the fusion planner's op streams, the
sandwich passes' plain versions against the JAX package's Pallas kernels
(interpret mode), and whole QCMRF circuits against the JAX plane engine
and both dense engines. On the CPU every sandwich wrapper runs its plain
version; tests/test_torch_gpu.py holds the CUDA kernels against them."""

import functools
import numbers

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.circuits.compiler import compile_qcmrf as jcompile  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402
from qcmrf_tpu.sim import dense as jdense  # noqa: E402
from qcmrf_tpu.sim import tpu as jtpu  # noqa: E402

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf  # noqa: E402
from qcmrf_tpu_torch.circuits.ir import Circuit  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF, grid_cliques  # noqa: E402
from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from qcmrf_tpu_torch.sim import dense, planes  # noqa: E402


def models(cliques, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    dim = sum(1 << len(C) for C in cliques)
    theta = (-np.abs(rng.randn(dim)) * scale).astype(np.float32)
    return (JMRF.create(cliques, theta=jnp.asarray(theta)),
            MRF.create(cliques, theta=theta, device="cpu"))


def circuits(cliques, seed, scale=0.5, **kw):
    jm, m = models(cliques, seed, scale)
    return jcompile(jm, **kw), compile_qcmrf(m, **kw)


#: kron of a lane op's factors against its M: both are composed in
#: complex64 (in another order), a few float32 ulps of entries <= 1
FACTORS_ATOL = 1e-6


def kron_factors(factors):
    """``F6 ⊗ ... ⊗ F0`` of a lane op's (7, 2, 2) factors."""
    return functools.reduce(np.kron, np.asarray(factors)[::-1])


def assert_same(got, want, path="op"):
    """Structural equality of two op streams: ints and strings exactly,
    floats and matrices to 1e-9. The port's lane op carries its factors
    beside M: its ``(kind, M)`` is held to JAX's ``("lane", M)``, and the
    Kronecker product of its factors to its M within FACTORS_ATOL."""
    if (isinstance(got, tuple) and isinstance(want, tuple)
            and len(got) == 3 and len(want) == 2
            and got[0] == want[0] == "lane"):
        assert np.asarray(got[2]).shape == (7, 2, 2), path
        np.testing.assert_allclose(kron_factors(got[2]), got[1], rtol=0,
                                   atol=FACTORS_ATOL, err_msg=path)
        got = got[:2]
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                   err_msg=path)
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)), path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, numbers.Integral) and isinstance(
            got, numbers.Integral):
        assert int(got) == int(want), path
    elif isinstance(want, numbers.Real):
        assert abs(float(got) - float(want)) <= 1e-9, path
    else:
        assert got == want, path


def chain(nn):
    return [[i, i + 1] for i in range(nn - 1)]


@pytest.mark.parametrize("nn", range(6, 17))
def test_fuse_ops_matches_on_bench_chains(nn):
    """Chains of 6-16 variables (widths 12-32), theta as bench.py draws
    it: the port's stream equals the JAX package's."""
    theta = -np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3
    jc = jcompile(JMRF.create(chain(nn), theta=theta),
                  with_measurements=False)
    c = compile_qcmrf(MRF.create(chain(nn), theta=theta, device="cpu"),
                      with_measurements=False)
    got, want = planes.fuse_ops(c), jtpu.fuse_ops(jc)
    assert_same(got, want)
    assert all(op[0] in ("sandwichku", "sandwichk", "sandwich")
               for op in got)
    if nn == 16:  # width 32: the stream holds all three sandwich forms
        assert [op[0] for op in got] == ["sandwichku", "sandwichk",
                                         "sandwich"]
        assert [op[2] if op[0] == "sandwichku" else op[1]
                for op in got] == [17, 24, 31]


def test_fuse_ops_matches_on_mixed_and_lane_cases():
    # width 15: one write-only pass holds the whole circuit
    jc, c = circuits([[i, i + 1] for i in range(6)], 1,
                     with_measurements=False)
    ops = planes.fuse_ops(c)
    assert_same(ops, jtpu.fuse_ops(jc))
    assert [o[0] for o in ops] == ["sandwichku"]
    assert ops[0][1] == tuple(range(7)) and len(ops[0][3]) == 6
    # width 10: the a=6 block stays unfused (lane and diag passes)
    jc, c = circuits([[0, 1], [1, 2], [2, 3], [3, 4]], 2,
                     with_measurements=False)
    ops = planes.fuse_ops(c)
    assert_same(ops, jtpu.fuse_ops(jc))
    kinds = [o[0] for o in ops]
    assert kinds[0] == "init_uniform" and kinds.count("sandwichk") == 1
    assert kinds.count("diag") == 1 and "lane" in kinds
    # mixed clique sizes, measurements and a lowered-style cx stream
    jc, c = circuits([[0, 1, 2], [2, 3], [3, 4, 5, 6]], 4)
    assert_same(planes.fuse_ops(c), jtpu.fuse_ops(jc))
    probe = Circuit(9)
    probe.h(7).cx(7, 8).rz(0.3, 8).x(2).sx(8).sxdg(7).cp(0.2, 1, 8).x(2)
    from qcmrf_tpu.circuits.ir import Circuit as JCircuit

    jprobe = JCircuit(9)
    jprobe.h(7).cx(7, 8).rz(0.3, 8).x(2).sx(8).sxdg(7).cp(0.2, 1, 8).x(2)
    assert_same(planes.fuse_ops(probe), jtpu.fuse_ops(jprobe))
    assert_same(planes.circuit_primitives(probe),
                jtpu.circuit_primitives(jprobe))


def to_complex(re, im):
    return (np.asarray(re).reshape(-1).astype(np.complex64)
            + 1j * np.asarray(im).reshape(-1))


def planes_pair(nq, seed):
    rng = np.random.RandomState(seed)
    re = rng.randn(1 << nq).astype(np.float32)
    im = rng.randn(1 << nq).astype(np.float32)
    return re, im


def port_planes(re, im):
    return (torch.from_numpy(re.copy()).reshape(-1, 128),
            torch.from_numpy(im.copy()).reshape(-1, 128))


def jax_planes(re, im):
    return jnp.asarray(re.reshape(-1, 128)), jnp.asarray(im.reshape(-1, 128))


SINGLE = dict(nu_terms=(((0, 1), (3, 0)), ((1, 1),)), nu_angles=(0.7, -0.4),
              nu_base=0.2, mu_terms=(((2, 1),),), mu_angles=(0.3,),
              mu_base=-0.1)


@pytest.mark.parametrize("with_mu", [True, False])
def test_single_sandwich_matches_pallas(with_mu):
    nq, anc = 9, 7
    re, im = planes_pair(nq, 7)
    args = dict(SINGLE) if with_mu else {
        k: v for k, v in SINGLE.items() if k.startswith("nu")}
    want = jkernels.apply_hdh_sandwich(*jax_planes(re, im), anc, **args)
    pr, pi = port_planes(re, im)
    got = kernels.apply_hdh_sandwich(pr, pi, anc, **args)
    assert got[0] is pr and got[1] is pi  # updated in place
    np.testing.assert_allclose(to_complex(*got), to_complex(*want),
                               atol=1e-5)
    ref = kernels.apply_hdh_sandwich_reference(*port_planes(re, im), anc,
                                               **args)
    assert torch.equal(ref[0], pr) and torch.equal(ref[1], pi)


PAIR = ((((0, 1),), ((2, 0), (4, 1))), (0.7, -0.3), 0.15,
        (((1, 1), (3, 1)),), (-0.9,), 0.0)
PAIR_MU = ((((5, 1),), ((0, 0),)), (0.4, -0.6), -0.1)


@pytest.mark.parametrize("with_mu", [True, False])
def test_pair_sandwich_matches_pallas(with_mu):
    nq, a_lo = 10, 7
    re, im = planes_pair(nq, 8)
    mu = PAIR_MU if with_mu else ((), (), 0.0)
    want = jkernels.apply_hdh_sandwich_pair(*jax_planes(re, im), a_lo,
                                            *PAIR, *mu)
    got = kernels.apply_hdh_sandwich_pair(*port_planes(re, im), a_lo,
                                          *PAIR, *mu)
    np.testing.assert_allclose(to_complex(*got), to_complex(*want),
                               atol=1e-5)


QUAD = ((((0, 1),), ((2, 0), (4, 1))), (((1, 1), (3, 1)),),
        (((5, 0),), ((6, 1),)), (((11, 1), (0, 0)),))
QUAD_ANGLES = ((0.7, -0.3), (-0.9,), (0.25, 1.1), (0.6,))
QUAD_BASES = (0.15, 0.0, -0.4, 0.05)
QUAD_MU = ((((5, 1),), ((2, 1),)), (0.4, -0.7), -0.2)


@pytest.mark.parametrize("with_mu", [True, False])
def test_quad_and_multi_sandwich_match_pallas(with_mu):
    nq, a_lo = 12, 7
    re, im = planes_pair(nq, 9)
    mu = QUAD_MU if with_mu else ((), (), 0.0)
    want = jkernels.apply_hdh_sandwich_quad(
        *jax_planes(re, im), a_lo, QUAD, QUAD_ANGLES, QUAD_BASES, *mu)
    got = kernels.apply_hdh_sandwich_quad(
        *port_planes(re, im), a_lo, QUAD, QUAD_ANGLES, QUAD_BASES, *mu)
    np.testing.assert_allclose(to_complex(*got), to_complex(*want),
                               atol=1e-5)
    # k = 3 (the width-10 chain's group) against the JAX multi kernel
    want = jkernels.apply_hdh_sandwich_multi(
        *jax_planes(re, im), 8, QUAD[:3], QUAD_ANGLES[:3], QUAD_BASES[:3],
        *mu)
    got = kernels.apply_hdh_sandwich_multi(
        *port_planes(re, im), 8, QUAD[:3], QUAD_ANGLES[:3],
        QUAD_BASES[:3], *mu)
    np.testing.assert_allclose(to_complex(*got), to_complex(*want),
                               atol=1e-5)


@pytest.mark.parametrize("with_mu", [True, False])
def test_multi_uniform_matches_pallas(with_mu):
    nq, a_lo = 11, 7
    folded = (0, 1, 2, 3, 4, 5)
    nts, nas, nbs = QUAD[:3], QUAD_ANGLES[:3], QUAD_BASES[:3]
    nts = nts[:2] + ((((5, 0),), ((6, 1),)),)
    mu = QUAD_MU if with_mu else ((), (), 0.0)
    want = jkernels.apply_hdh_sandwich_multi_uniform(
        nq, folded, a_lo, nts, nas, nbs, *mu)
    got = kernels.apply_hdh_sandwich_multi_uniform(
        nq, folded, a_lo, nts, nas, nbs, *mu, device="cpu")
    assert got[0].shape == (1 << (nq - 7), 128)
    np.testing.assert_allclose(to_complex(*got), to_complex(*want),
                               atol=1e-5)
    # into given planes, whatever they held
    out = (torch.full((16, 128), 3.0), torch.full((16, 128), -2.0))
    into = kernels.apply_hdh_sandwich_multi_uniform(
        nq, folded, a_lo, nts, nas, nbs, *mu, out=out)
    assert into[0] is out[0]
    np.testing.assert_allclose(to_complex(*into), to_complex(*want),
                               atol=1e-5)
    # the probability form: |amplitude|^2, flat
    probs = kernels.apply_hdh_sandwich_multi_uniform_probs(
        nq, folded, a_lo, nts, nas, nbs, *mu, device="cpu")
    assert probs.shape == (1 << nq,)
    np.testing.assert_allclose(probs.numpy(),
                               np.abs(to_complex(*want)) ** 2, atol=1e-6)


def test_sandwich_guards_raise():
    pr, pi = port_planes(*planes_pair(9, 1))
    with pytest.raises(ValueError, match="ancilla 7"):
        kernels.apply_hdh_sandwich(pr, pi, 7, (((7, 1),),), (0.1,))
    with pytest.raises(ValueError, match="1..7"):
        kernels.apply_hdh_sandwich_multi(pr, pi, 0, ((),) * 8, ((),) * 8,
                                         (0.0,) * 8)
    with pytest.raises(ValueError, match="outside"):
        kernels.apply_hdh_sandwich_multi(pr, pi, 8, ((), ()), ((), ()),
                                         (0.0, 0.0))
    with pytest.raises(ValueError, match="folded"):
        kernels.apply_hdh_sandwich_multi_uniform(9, (0, 7), 7, ((),), ((),),
                                                 (0.0,))
    for form in (kernels.apply_hdh_sandwich_multi_uniform,
                 kernels.apply_hdh_sandwich_multi_uniform_probs):
        with pytest.raises(ValueError, match="1..16"):
            form(20, (0,), 2, ((),) * 17, ((),) * 17, (0.0,) * 17,
                 device="cpu")
    with pytest.raises(ValueError, match="float32"):
        kernels.apply_hdh_sandwich(pr.double(), pi.double(), 7, (), ())
    with pytest.raises(ValueError, match="terms"):
        kernels.apply_hdh_sandwich(pr, pi, 8, ((((0, 1),),) * 1025),
                                   (0.1,) * 1025)


@pytest.mark.parametrize("cliques", [
    [[i, i + 1] for i in range(5)],                  # width 12
    [[0, 1, 2], [2, 3], [3, 4], [4, 5], [5, 6]],     # width 13
])
def test_run_statevector_matches_jax_and_dense(cliques):
    jc, c = circuits(cliques, 7, with_measurements=False)
    got = to_complex(*planes.run_statevector(c, device="cpu"))
    want = to_complex(*jtpu.run_statevector(jc))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jdense.run_statevector(jc)),
                               atol=1e-5)
    np.testing.assert_allclose(got, dense.run_statevector(c, device="cpu")
                               .numpy(),
                               atol=1e-5)


def test_outcome_probs_marginalise_like_dense():
    jc, c = circuits([[i, i + 1] for i in range(5)], 3)
    probs = planes.simulate_probs(c, device="cpu")
    np.testing.assert_allclose(
        probs.numpy(), dense.simulate_probs(c, device="cpu").numpy(),
        atol=1e-6)
    # only the ancillas measured, onto a narrower register
    part = Circuit(c.num_qubits, 6, gates=[
        g for g in c.gates if g.name != "measure"])
    for i, q in enumerate(range(7, 12)):
        part.measure(q, i)
    re, im = planes.run_statevector(part, device="cpu")
    np.testing.assert_allclose(
        planes.outcome_probs(part, re, im).numpy(),
        dense.outcome_probs(part, dense.run_statevector(
            part, device="cpu")).numpy(),
        atol=1e-6)


def test_unported_passes_raise():
    """The passes that once raised (diag, lane, rowq, row2) now run: the
    width-10 circuit whose a=6 block stays unfused matches the JAX plane
    engine and the dense engine, and each pass alone matches the JAX
    executor's within 1e-5. Planes below 7 qubits still raise."""
    jc, c = circuits([[0, 1], [1, 2], [2, 3], [3, 4]], 2)  # width 10
    got = planes.simulate_probs(c, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jtpu.simulate_probs(jc)),
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jdense.simulate_probs(jc)),
                               atol=1e-5)
    rng = np.random.RandomState(3)
    U4 = (rng.randn(4, 4) + 1j * rng.randn(4, 4)).astype(np.complex64) / 3
    M = ((rng.randn(128, 128) + 1j * rng.randn(128, 128)) / 16).astype(
        np.complex64)
    for op in (("diag", (((0, 1),), ((8, 0), (2, 1)), ()), (0.1, -0.7, 0.3),
                0.2),
               ("lane", M), ("rowq", U4[:2, :2], 8), ("row2", U4, 7)):
        re, im = planes_pair(9, 4)
        want = jtpu._apply_ops(*jax_planes(re, im), [op], 9)
        pr, pi = port_planes(re, im)
        assert planes.apply_ops(pr, pi, [op], 9)[0] is pr
        np.testing.assert_allclose(to_complex(pr, pi), to_complex(*want),
                                   atol=1e-5, err_msg=op[0])
    with pytest.raises(ValueError, match=">= 7"):
        planes.run_statevector(Circuit(3), device="cpu")


def test_init_uniform_matches_jax():
    for nq, folded in ((8, (0, 1, 2)), (9, (1, 4, 8))):
        got = kernels.uniform_planes(nq, folded, device="cpu")
        want = jtpu.uniform_planes(nq, folded)
        np.testing.assert_array_equal(to_complex(*got), to_complex(*want))
    re, im = planes.run_ops([("init_uniform", (0, 1, 2))], 8, "cpu")
    assert float(re.sum()) == pytest.approx(8 * 2 ** -1.5)


# ---- the planner's cache: one plan a gate skeleton --------------------------


def assert_bits(got, want, path="op"):
    """Two op streams equal to the bit: the same structure and types, every
    float the same bit pattern, every array the same dtype and values."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bits(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert type(got) is float and got.hex() == want.hex(), (path, got,
                                                                 want)
    else:
        assert type(got) is type(want) and got == want, path


def floats(x):
    """Every float of an op stream, in order."""
    if isinstance(x, float):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from floats(y)


def counted(fn):
    """``fn()`` under PyTorch's profiler; returns (its result, the
    session's counters)."""
    from torch.autograd import profiler

    from qcmrf_tpu_torch.utils import profiling

    with profiler.profile(use_kineto=True):
        out = fn()
    return out, profiling.session_counts()


def clear_plan_caches():
    from qcmrf_tpu_torch.circuits import compiler

    compiler._skeleton.cache_clear()
    planes._PLANS.clear()


#: (cliques, lowered): the chain15 cell's circuit, the 4x5 grid, and a
#: 6-chain lowered to [cx, id, rz, sx, x] (rz angles and cx's pi)
PLAN_CASES = {
    "chain15": (chain(15), False),
    "grid4x5": (grid_cliques(4, 5), False),
    "chain6_lowered": (chain(6), True),
}


def draw_circuits(cliques, lowered, seed, draws=8):
    """(port circuit, JAX circuit) of ``draws`` theta draws, unmeasured."""
    from qcmrf_tpu.circuits.lower import lower as jlower

    from qcmrf_tpu_torch.circuits.lower import lower

    out = []
    for k in range(draws):
        jc, c = circuits(cliques, 100 * seed + k, scale=(0.1, 0.25, 0.5)[k % 3],
                         with_measurements=False)
        if lowered:
            jc, c = jlower(jc, style="fused"), lower(c, style="fused")
        out.append((c, jc))
    return out


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_fuse_hit_equals_the_planner_and_jax(case):
    """Eight theta draws of one skeleton: the first builds the plan, the
    others hit it, and each stream equals the planner's own bit for bit
    and the JAX package's fuse_ops as the parity tests hold it."""
    clear_plan_caches()
    draws = draw_circuits(*PLAN_CASES[case], seed=1)

    def run():
        return [planes.fuse_ops(c) for c, _ in draws]

    streams, counts = counted(run)
    assert counts.get("fuse_build") == 1 and counts.get("fuse_hit") == 7
    assert len(planes._PLANS) == 1
    for (c, jc), got in zip(draws, streams):
        assert_bits(got, planes.plan_stream(c))
        assert_same(got, jtpu.fuse_ops(jc))
    # the angles did change from draw to draw
    assert any(a.hex() != b.hex()
               for a, b in zip(floats(streams[1]), floats(streams[2])))


def test_fuse_skeleton_change_misses():
    """A theta entry of exactly 0 makes the compiler skip its gamma: a new
    skeleton, so both caches miss, and the stream is the planner's. Zeroing
    the next entry instead leaves the same names and qubits, other flags:
    a skeleton of its own again."""
    clear_plan_caches()
    theta = (-np.abs(np.random.RandomState(2).randn(4 * 14))
             * 0.3).astype(np.float32)
    zeroed, other = theta.copy(), theta.copy()
    zeroed[5] = 0.0
    other[6] = 0.0

    def run():
        out = []
        for t in (theta, zeroed, theta * 0.5, other):
            c = compile_qcmrf(MRF.create(chain(15), theta=t, device="cpu"),
                              with_measurements=False)
            out.append((c, planes.fuse_ops(c)))
        return out

    out, counts = counted(run)
    assert counts == {"skeleton_build": 3, "fuse_build": 3, "fuse_hit": 1}
    assert len(out[1][0].gates) == len(out[0][0].gates) - 2
    assert ([(g.name, g.qubits) for g in out[1][0].gates]
            == [(g.name, g.qubits) for g in out[3][0].gates])
    for c, got in out:
        assert_bits(got, planes.plan_stream(c))
    jc = jcompile(JMRF.create(chain(15), theta=jnp.asarray(zeroed)),
                  with_measurements=False)
    assert_same(out[1][1], jtpu.fuse_ops(jc))


def test_fuse_mutated_circuit_is_planned_anew():
    """A gate appended after compilation changes the skeleton: the circuit
    gets its own stream, not the one kept for the compiled circuit."""
    clear_plan_caches()
    jc, c = circuits(chain(7), 3, with_measurements=False)
    before = planes.fuse_ops(c)
    c.rz(0.375, 9)
    jc.rz(0.375, 9)
    after, counts = counted(lambda: planes.fuse_ops(c))
    assert counts == {"fuse_build": 1}
    assert len(after) == len(before) + 1 and after[-1][0] == "diag"
    assert_bits(after, planes.plan_stream(c))
    assert_same(after, jtpu.fuse_ops(jc))


def test_fuse_drop_pattern_change_is_planned_anew():
    """H · cp(a) · cp(b) · H on a row qubit: the sandwich keeps its term
    while a + b is not 0 and drops it where b = -a. A draw that turns a
    drop test the other way is planned anew; one that keeps the kept
    pattern hits."""
    clear_plan_caches()

    def probe(a, b, cls=Circuit):
        return cls(9).h(7).cp(a, 1, 7).cp(b, 1, 7).h(7)

    from qcmrf_tpu.circuits.ir import Circuit as JCircuit

    pairs = [(0.3, 0.2), (0.3, -0.3), (0.1, 0.4), (0.2, 0.5), (-0.7, 0.7)]

    def run():
        return [planes.fuse_ops(probe(a, b)) for a, b in pairs]

    streams, counts = counted(run)
    assert counts == {"fuse_build": 4, "fuse_hit": 1}
    assert len(planes._PLANS) == 1
    for (a, b), got in zip(pairs, streams):
        assert_bits(got, planes.plan_stream(probe(a, b)))
        assert_same(got, jtpu.fuse_ops(probe(a, b, JCircuit)))
    assert streams[1][0][2] == () and streams[0][0][2] != ()


def test_plan_caches_count_and_stay_bounded():
    """One skeleton_build and one fuse_build on the first circuit of a
    shape, then fuse_hit only; more skeletons than the caches hold evict
    the oldest."""
    from qcmrf_tpu_torch.circuits import compiler

    clear_plan_caches()
    mrf = MRF.create(chain(6), device="cpu")
    rng = np.random.RandomState(4)

    def run(m, k):
        for _ in range(k):
            planes.fuse_ops(compile_qcmrf(
                m.with_theta(-np.abs(rng.randn(m.dimension)) - 0.1)))

    _, counts = counted(lambda: run(mrf, 1))
    assert counts == {"skeleton_build": 1, "fuse_build": 1}
    _, counts = counted(lambda: run(mrf, 5))
    assert counts == {"fuse_hit": 5}
    size = planes.FUSE_CACHE_SIZE
    for n in range(2, size + 12):
        m = MRF.create([[0, v] for v in range(1, n + 1)], device="cpu")
        run(m, 1)
    assert len(planes._PLANS) == size
    assert compiler._skeleton.cache_info().currsize <= size
    _, counts = counted(lambda: run(mrf, 1))  # evicted: built again
    assert counts == {"skeleton_build": 1, "fuse_build": 1}


# ---- the write-only pass absorbs the groups on fresh ancillas ---------------


def assert_matches_dense(c):
    """simulate_probs and run_statevector on the CPU against the dense
    engine in complex128, within 1e-6."""
    want = dense.run_statevector(c, dtype=torch.complex128, device="cpu")
    re, im = planes.run_statevector(c, device="cpu")
    got = torch.complex(re, im).reshape(-1).to(torch.complex128)
    assert float((got - want).abs().max()) <= 1e-6
    probs = planes.simulate_probs(c, device="cpu")
    want = dense.simulate_probs(c, dtype=torch.complex128, device="cpu")
    assert float((probs.double() - want).abs().max()) <= 1e-6


def test_fresh_fold_engages_on_a_chain():
    """A 9-chain (width 18: groups of 7 and 1 ancillas) runs as one
    write-only pass over ancillas 10-17, counted as one fresh_fold in
    each run; both results match the dense engine."""
    _, c = circuits(chain(9), 5, with_measurements=False)
    ops = planes.fuse_ops(c)
    assert [op[0] for op in ops] == ["sandwichku", "sandwich"]
    (op,) = planes.fold_fresh(ops)
    assert op[0] == "sandwichku" and op[2] == 10 and len(op[3]) == 8
    assert op[6] == ops[0][6] + ops[1][5]  # mu terms concatenated
    assert op[8] == ops[0][8] + ops[1][7]  # mu bases added
    for run in (lambda: planes.simulate_probs(c, device="cpu"),
                lambda: planes.run_statevector(c, device="cpu")):
        _, counts = counted(run)
        assert counts.get("fresh_fold") == 1
    assert_matches_dense(c)


def test_fresh_fold_decision_on_chain15():
    """chain15's stream (width 30) folds into one write-only pass over
    ancillas 16-29; the stream fuse_ops gives keeps its two ops."""
    _, c = circuits(chain(15), 8, with_measurements=False)
    ops = planes.fuse_ops(c)
    assert [op[0] for op in ops] == ["sandwichku", "sandwichk"]
    assert (ops[0][2], len(ops[0][3]), ops[1][1], len(ops[1][2])) == (
        16, 7, 23, 7)
    (op,) = planes.fold_fresh(ops)
    assert op[2] == 16 and len(op[3]) == 14 and op[1] == tuple(range(15))
    assert len(planes.fuse_ops(c)) == 2


def _two_sandwiches(second_anc, cond_on_first=False, between=False):
    """Width 10: an H wall on qubits 0-6, a sandwich on ancilla 7, and a
    sandwich on ``second_anc`` whose diagonal conditions on qubit 1 (and
    on ancilla 7 with ``cond_on_first``), after an rz on its own ancilla
    with ``between``."""
    c = Circuit(10)
    for q in range(7):
        c.h(q)
    c.h(7).cp(0.7, 0, 7).rz(0.3, 7).h(7)
    if between:
        c.rz(0.4, second_anc)
    c.h(second_anc).cp(-0.9, 1, second_anc)
    if cond_on_first:
        c.cp(0.5, 7, second_anc)
    return c.h(second_anc)


@pytest.mark.parametrize("case", ["conditions_on_first", "op_between",
                                  "not_adjacent"])
def test_fresh_fold_needs_fresh_independent_adjacent_ancillas(case):
    """The second group is not absorbed when it conditions on an ancilla
    of the first, when an op on its ancilla comes between them, or when
    its ancilla is not adjacent; each stream still matches the dense
    engine."""
    c = {"conditions_on_first": lambda: _two_sandwiches(8, True),
         "op_between": lambda: _two_sandwiches(8, between=True),
         "not_adjacent": lambda: _two_sandwiches(9)}[case]()
    ops = planes.fuse_ops(c)
    assert ops[0][0] == "sandwichku" and ops[-1][0] == "sandwich"
    assert len(ops) == (3 if case == "op_between" else 2)
    assert planes.fold_fresh(ops) is ops
    _, counts = counted(lambda: planes.simulate_probs(c, device="cpu"))
    assert counts["fresh_fold"] == 0  # looked at, none absorbed
    assert_matches_dense(c)


@pytest.mark.parametrize("second_terms,absorbed", [(424, True),
                                                    (425, False)])
def test_fresh_fold_stops_at_the_kernels_term_table(second_terms, absorbed):
    """A group is absorbed only while the merged pass's terms fit the
    kernels' table (600 + 424 = 1024 do, one more does not); either
    stream runs, and equals the stream run op for op."""
    rng = np.random.RandomState(second_terms)
    first = ("sandwichku", tuple(range(7)), 7, ((((0, 1),),) * 600,),
             (tuple(rng.randn(600) * 0.01),), (0.3,), (), (), 0.0)
    second = ("sandwich", 8, (((2, 0), (1, 1)),) * second_terms,
              tuple(rng.randn(second_terms) * 0.01), -0.2, (), (), 0.0)
    ops = [first, second]
    folded = planes.fold_fresh(ops)
    assert (folded is ops) != absorbed
    if absorbed:
        assert sum(map(len, folded[0][3])) == kernels.MAX_SANDWICH_TERMS
    got = planes.run_ops(ops, 10, "cpu")
    want = planes.apply_ops(*planes.zero_planes(10, "cpu"), ops, 10)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_fresh_fold_never_engages_on_a_lowered_chain():
    """A lowered stream folds no H wall: no sandwichku leads it, and
    nothing is absorbed."""
    from qcmrf_tpu_torch.circuits.lower import lower

    _, c = circuits(chain(4), 6, with_measurements=False)
    low = lower(c)
    ops = planes.fuse_ops(low)
    assert ops[0][0] != "sandwichku" and planes.fold_fresh(ops) is ops
    probs, counts = counted(lambda: planes.simulate_probs(low, device="cpu"))
    assert "fresh_fold" not in counts
    want = dense.simulate_probs(low, dtype=torch.complex128, device="cpu")
    assert float((probs.double() - want).abs().max()) <= 1e-5
