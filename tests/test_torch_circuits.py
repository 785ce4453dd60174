"""Port parity of the circuit IR, the QCMRF compiler and the dense
statevector engine: ``qcmrf_tpu_torch`` against ``qcmrf_tpu`` on the same
numpy inputs (JAX on the CPU)."""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.circuits import compiler as jcompiler  # noqa: E402
from qcmrf_tpu.circuits.ir import Circuit as JCircuit  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.sim import dense as jdense  # noqa: E402

import qcmrf_tpu_torch  # noqa: E402
from qcmrf_tpu_torch.circuits import compiler  # noqa: E402
from qcmrf_tpu_torch.circuits.ir import Circuit, Gate  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.sim import dense  # noqa: E402


def port_circuit(jc) -> Circuit:
    """The port's circuit carrying a JAX circuit's fields."""
    return Circuit(
        num_qubits=jc.num_qubits, num_clbits=jc.num_clbits,
        gates=[Gate(g.name, g.qubits, g.params, g.flags, g.clbits)
               for g in jc.gates],
        global_phase=jc.global_phase, name=jc.name)


def fields(c):
    return ([(g.name, g.qubits, g.params, g.flags, g.clbits)
             for g in c.gates], c.num_qubits, c.num_clbits, c.global_phase,
            c.name)


def assert_same_gates(got, want, atol=1e-12):
    assert len(got.gates) == len(want.gates)
    for g, w in zip(got.gates, want.gates):
        assert (g.name, g.qubits, g.flags, g.clbits) == \
            (w.name, w.qubits, w.flags, w.clbits)
        np.testing.assert_allclose(g.params, w.params, rtol=0, atol=atol)
    assert (got.num_qubits, got.num_clbits) == (want.num_qubits,
                                                want.num_clbits)


def build(cls):
    c = cls(5, 5, name="probe")
    c.h(0).x(1).sx(2).sxdg(3).id(4).rz(0.3, 0).cx(0, 4).cp(-0.7, 2, 1)
    c.barrier()
    c.flags_phase([1, 3], [1, -1], 0.45, control=4)
    c.add_global_phase(7.0)
    return c


def test_builder_and_inspection_match():
    got, want = build(Circuit), build(JCircuit)
    assert fields(got) == fields(want)
    assert got.count_ops() == want.count_ops()
    assert got.depth() == want.depth()
    got.measure(2, 2).measure(4, 0)
    want.measure(2, 2).measure(4, 0)
    assert got.measured_pairs == want.measured_pairs == [(2, 2), (4, 0)]
    for c in (Circuit(3, 3), JCircuit(3, 3)):
        with pytest.raises(ValueError):
            c.h(3)
        with pytest.raises(ValueError):
            c.measure(0, 3)
        with pytest.raises(ValueError):
            c.flags_phase([0, 1], [1], 0.1, control=2)


def test_inverse_and_extend_match():
    got, want = build(Circuit), build(JCircuit)
    assert fields(got.inverse()) == fields(want.inverse())
    a, b = Circuit(7, 7), JCircuit(7, 7)
    qmap = [6, 5, 4, 3, 2]
    a.extend(build(Circuit), qubit_map=qmap)
    b.extend(build(JCircuit), qubit_map=qmap)
    a.extend(build(Circuit))
    b.extend(build(JCircuit))
    assert fields(a) == fields(b)
    for c in (build(Circuit), build(JCircuit)):
        c.measure(0, 0)
        with pytest.raises(ValueError):
            c.inverse()
    bad = Circuit(3, 3).measure(0, 1)
    with pytest.raises(ValueError, match="remap"):
        Circuit(3, 3).extend(bad, qubit_map=[2, 1, 0])


def jmodel(cliques, theta, beta=1.0):
    return JMRF.create(cliques, theta=jnp.asarray(theta, jnp.float32),
                       beta=beta)


def pmodel(cliques, theta, beta=1.0):
    return MRF.create(cliques, theta=np.asarray(theta, np.float32),
                      beta=beta, device="cpu")


@pytest.mark.parametrize("j", range(7))
def test_compile_qcmrf_matches_on_the_suite(j):
    suite = jsuite.generate_suite(0.1)
    C = suite.graphs[j]
    for theta in suite.thetas[j][:3]:
        want = jcompiler.compile_qcmrf(jmodel(C, theta))
        got = compiler.compile_qcmrf(pmodel(C, theta))
        assert_same_gates(got, want)


def test_compile_qcmrf_mixed_cliques_and_skip_rule():
    cliques = [[0, 1, 2], [2, 3], [3, 4, 5, 6]]
    rng = np.random.RandomState(3)
    theta = -np.abs(rng.randn(28)) * 0.6
    theta[[1, 9, 20]] = 0.0  # gamma == 0: those phases are skipped
    for kwargs in ({}, {"with_measurements": False},
                   {"with_barriers": True, "name": "mixed"}):
        want = jcompiler.compile_qcmrf(jmodel(cliques, theta, 1.5), **kwargs)
        got = compiler.compile_qcmrf(pmodel(cliques, theta, 1.5), **kwargs)
        assert_same_gates(got, want)
        assert got.name == want.name
    with pytest.raises(ValueError, match="theta <= 0"):
        compiler.compile_qcmrf(pmodel([[0, 1]], [0.1, -1, -1, -1]))


def test_qcmrf_facade_matches():
    cliques = [[0, 1], [1, 2, 3]]
    theta = -np.abs(np.random.RandomState(1).randn(12)) * 0.5
    got = compiler.QCMRF.build(cliques, theta=theta)
    want = jcompiler.QCMRF.build(cliques, theta=theta)
    assert_same_gates(got.circuit, want.circuit)
    for prop in ("dimension", "cliques", "num_vertices", "num_nodes",
                 "num_cliques", "max_clique", "num_qubits",
                 "workspace_qubit", "ancilla_qubits"):
        assert getattr(got, prop) == getattr(want, prop), prop
    np.testing.assert_allclose(got.theta, want.theta, atol=1e-7)
    np.testing.assert_allclose(got.gamma, want.gamma, atol=1e-7)
    gamma = np.asarray(want.gamma)
    np.testing.assert_allclose(
        compiler.QCMRF.build(cliques, gamma=gamma).theta,
        jcompiler.QCMRF.build(cliques, gamma=gamma).theta, atol=1e-6)
    with pytest.raises(ValueError, match="pi/4"):
        compiler.QCMRF.build(cliques, gamma=np.full(12, 1.0))
    with pytest.raises(ValueError, match="dimension"):
        compiler.QCMRF.build(cliques, theta=np.zeros(5))
    gen = torch.Generator().manual_seed(4)
    drawn = compiler.QCMRF.build(cliques, init_key=gen)
    assert all(-5.0 <= t <= 0.0 for t in drawn.theta)
    assert qcmrf_tpu_torch.compile_qcmrf is compiler.compile_qcmrf
    assert qcmrf_tpu_torch.QCMRF is compiler.QCMRF


def test_unported_facade_methods_name_their_slice():
    """The facade methods that once raised now return what JAX's do: the
    lowered gate list (params within 1e-12, global phase), and the
    operators' Z-string terms."""
    q = compiler.QCMRF.build([[0, 1]], theta=[-1.0] * 4)
    jq = jcompiler.QCMRF.build([[0, 1]], theta=[-1.0] * 4)
    for style in ("fused", "literal"):
        got, want = q.lowered(style), jq.lowered(style)
        assert_same_gates(got, want)
        assert abs(got.global_phase - want.global_phase) <= 1e-12
    for got, want in ((q.Hamiltonian(), jq.Hamiltonian()),
                      (q.sufficient_statistic([0, 1], [0, 1]),
                       jq.sufficient_statistic([0, 1], [0, 1])),
                      (q._conjugate_blocks(q.Hamiltonian()),
                       jq._conjugate_blocks(jq.Hamiltonian()))):
        assert got.n == want.n
        assert [m for m, _ in got.terms] == [m for m, _ in want.terms]
        np.testing.assert_allclose([c for _, c in got.terms],
                                   [c for _, c in want.terms], atol=1e-12)


def random_circuit(nq, depth, seed):
    """A JAX circuit over the whole gate set, from a numpy seed."""
    rng = np.random.RandomState(seed)
    c = JCircuit(nq, nq)
    for _ in range(depth):
        kind = rng.randint(8)
        q = int(rng.randint(nq))
        other = int((q + 1 + rng.randint(nq - 1)) % nq)
        if kind == 0:
            c.h(q)
        elif kind == 1:
            c.x(q)
        elif kind == 2:
            c.sx(q).sxdg(other)
        elif kind == 3:
            c.rz(float(rng.randn()), q)
        elif kind == 4:
            c.cx(q, other)
        elif kind == 5:
            c.cp(float(rng.randn()), q, other)
        elif kind == 6:
            pattern = [int(p) for p in rng.choice(
                [p for p in range(nq) if p != q], 2, replace=False)]
            c.flags_phase(pattern, [int(f) for f in rng.choice([-1, 1], 2)],
                          float(rng.randn()), control=q)
        else:
            c.id(q).barrier()
    c.add_global_phase(0.3)
    return c


@pytest.mark.parametrize("seed", range(4))
def test_dense_matches_jax_on_random_circuits(seed):
    nq = 5 + seed
    jc = random_circuit(nq, 40, seed)
    for q in range(0, nq, 2):
        jc.measure(q, q)
    c = port_circuit(jc)
    want = np.asarray(jdense.run_statevector(jc))
    got = dense.run_statevector(c, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(dense.outcome_probs(c, torch.from_numpy(got))
                               .numpy(),
                               np.asarray(jdense.outcome_probs(jc, want)),
                               atol=1e-5)
    wide = dense.run_statevector(c, dtype=torch.complex128, device="cpu")
    assert wide.dtype == torch.complex128
    np.testing.assert_allclose(wide.numpy(), want, atol=1e-5)
    assert abs(dense.statevector_fidelity(wide, wide) - 1.0) < 1e-12


def test_dense_qcmrf_probs_match_jax():
    cliques = [[0, 1, 2], [2, 3]]
    theta = -np.abs(np.random.RandomState(6).randn(12)) * 0.5
    jc = jcompiler.compile_qcmrf(jmodel(cliques, theta))
    got = dense.simulate_probs(port_circuit(jc), device="cpu").numpy()
    want = np.asarray(jdense.simulate_probs(jc))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert abs(got.sum() - 1.0) < 1e-5
    # the post-selected branch carries the Gibbs law times delta
    m = pmodel(cliques, theta)
    post = got[: 1 << m.n]
    np.testing.assert_allclose(post / post.sum(), m.gibbs_probs().numpy(),
                               atol=1e-5)
    assert abs(post.sum() - float(m.success_rate())) < 1e-5


def test_dense_gate_helpers():
    state = dense.zero_state(3, device="cpu")
    state = dense.apply_1q(state, dense.GATES_1Q["h"], 1, 3)
    np.testing.assert_allclose(state.abs().numpy() ** 2,
                               [0.5, 0, 0.5, 0, 0, 0, 0, 0], atol=1e-7)
    with pytest.raises(ValueError):
        dense.apply_2q(state, np.eye(4), 1, 1, 3)
    with pytest.raises(ValueError, match="unknown gate"):
        dense.apply_gate(state, Gate("ccz", (0, 1, 2)), 3)
    assert math.isclose(dense.statevector_fidelity(state, state), 1.0,
                        rel_tol=1e-6)


#: cliques of the skeleton tests: the 15-chain, the 4x5 grid, and a set
#: with a 3-clique (and a 4-clique)
SKELETON_CASES = {
    "chain15": [[i, i + 1] for i in range(14)],
    "grid4x5": None,  # grid_cliques(4, 5)
    "mixed3": [[0, 1, 2], [2, 3], [3, 4, 5, 6]],
}


@pytest.mark.parametrize("measured", [True, False])
@pytest.mark.parametrize("case", sorted(SKELETON_CASES))
def test_compile_skeleton_hit_equals_an_empty_cache(case, measured):
    """A compile that hits the skeleton cache gives, gate by gate, the
    gates of a compile with the cache emptied, each float to the bit, and
    the JAX package's gates; the circuit's gate list is its own."""
    from torch.autograd import profiler

    from qcmrf_tpu_torch.models.mrf import grid_cliques
    from qcmrf_tpu_torch.utils import profiling

    cliques = SKELETON_CASES[case] or grid_cliques(4, 5)
    dim = sum(1 << len(C) for C in cliques)
    rng = np.random.RandomState(7)
    thetas = [-np.abs(rng.randn(dim)) * s for s in (0.5, 0.25, 0.1)]
    compiler._skeleton.cache_clear()
    with profiler.profile(use_kineto=True):
        hits = [compiler.compile_qcmrf(pmodel(cliques, t),
                                       with_measurements=measured)
                for t in thetas]
    assert profiling.session_counts() == {"skeleton_build": 1}
    for t, got in zip(thetas, hits):
        compiler._skeleton.cache_clear()
        cold = compiler.compile_qcmrf(pmodel(cliques, t),
                                      with_measurements=measured)
        assert fields(got)[1:] == fields(cold)[1:]
        assert len(got.gates) == len(cold.gates)
        for g, w in zip(got.gates, cold.gates):
            assert (g.name, g.qubits, g.flags, g.clbits) == \
                (w.name, w.qubits, w.flags, w.clbits)
            assert [p.hex() for p in g.params] == [p.hex() for p in w.params]
            assert all(type(p) is float for p in g.params)
        assert_same_gates(got, jcompiler.compile_qcmrf(
            jmodel(cliques, t), with_measurements=measured))
    # each circuit owns its list: appending to one leaves the next alone
    hits[0].h(0)
    again = compiler.compile_qcmrf(pmodel(cliques, thetas[0]),
                                   with_measurements=measured)
    assert len(again.gates) == len(hits[1].gates) == len(hits[0].gates) - 1
