"""Port parity of the basis-gate lowering and the Pauli algebra:
``qcmrf_tpu_torch.circuits.lower`` and ``models.pauli`` against
``qcmrf_tpu``'s on the same inputs (the gate list equal: names, qubits and
params within 1e-12, global phase included), and the lowered circuits'
states against the dense engine."""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.circuits import compiler as jcompiler  # noqa: E402
from qcmrf_tpu.circuits import lower as jlower  # noqa: E402
from qcmrf_tpu.circuits.ir import Circuit as JCircuit  # noqa: E402
from qcmrf_tpu.models import pauli as jpauli  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.sim import dense as jdense  # noqa: E402

import qcmrf_tpu_torch  # noqa: E402
from qcmrf_tpu_torch.circuits import compiler  # noqa: E402
from qcmrf_tpu_torch.circuits import lower as L  # noqa: E402
from qcmrf_tpu_torch.circuits.ir import Circuit, Gate  # noqa: E402
from qcmrf_tpu_torch.models import pauli  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.sim import dense  # noqa: E402

#: (style, optimize) pairs; literal ignores optimize, as in the JAX pass
MODES = [("fused", 0), ("fused", 1), ("literal", 0), ("literal", 1)]


def port_circuit(jc) -> Circuit:
    return Circuit(
        num_qubits=jc.num_qubits, num_clbits=jc.num_clbits,
        gates=[Gate(g.name, g.qubits, g.params, g.flags, g.clbits)
               for g in jc.gates],
        global_phase=jc.global_phase, name=jc.name)


def assert_same_circuit(got, want):
    """The same gate list (params within 1e-12), register sizes, name and
    global phase."""
    assert len(got.gates) == len(want.gates)
    for g, w in zip(got.gates, want.gates):
        assert (g.name, g.qubits, g.flags, g.clbits) == \
            (w.name, w.qubits, w.flags, w.clbits)
        np.testing.assert_allclose(g.params, w.params, rtol=0, atol=1e-12)
    assert (got.num_qubits, got.num_clbits, got.name) == \
        (want.num_qubits, want.num_clbits, want.name)
    assert abs(got.global_phase - want.global_phase) <= 1e-12


def models(cliques, theta):
    return (JMRF.create(cliques, theta=jnp.asarray(theta, jnp.float32)),
            MRF.create(cliques, theta=np.asarray(theta, np.float32),
                       device="cpu"))


@pytest.mark.parametrize("j", range(7))
def test_lowered_gate_list_matches_on_the_suite(j):
    suite = jsuite.generate_suite(0.1)
    jm, m = models(suite.graphs[j], suite.thetas[j][0])
    jc = jcompiler.compile_qcmrf(jm)
    c = compiler.compile_qcmrf(m)
    for style, opt in MODES:
        assert_same_circuit(L.lower(c, style, optimize=opt),
                            jlower.lower(jc, style, optimize=opt))


def fuzz_circuit(rng, n, depth):
    """tests/test_engine_fuzz.py's gate mix over qubits 0..n-1 of an
    (n+1)-qubit JAX circuit: the top qubit stays idle for the literal
    style's workspace."""
    c = JCircuit(n + 1, n + 1)
    for _ in range(depth):
        kind = rng.randint(0, 8)
        if kind == 0:
            c.h(rng.randint(n))
        elif kind == 1:
            c.x(rng.randint(n))
        elif kind == 2:
            c.sx(rng.randint(n))
        elif kind == 3:
            c.rz(float(rng.uniform(-np.pi, np.pi)), rng.randint(n))
        elif kind == 4:
            a, b = rng.choice(n, 2, replace=False)
            c.cx(int(a), int(b))
        elif kind == 5:
            a, b = rng.choice(n, 2, replace=False)
            c.cp(float(rng.uniform(-np.pi, np.pi)), int(a), int(b))
        elif kind == 6:
            c.sxdg(rng.randint(n))
        else:
            m = rng.randint(1, min(3, n - 1) + 1)
            qs = rng.choice(n, m + 1, replace=False)
            flags = [int(f) * 2 - 1 for f in rng.randint(0, 2, m)]
            c.flags_phase([int(q) for q in qs[:m]], flags,
                          float(rng.uniform(-np.pi, np.pi)), int(qs[m]))
    c.id(0).barrier()
    c.measure(0, 0)
    c.add_global_phase(0.4)
    return c


@pytest.mark.parametrize("seed", range(6))
def test_lowered_gate_list_matches_on_random_circuits(seed):
    """Random circuits (n = 5, depth 25) in both styles, optimize 0 and 1:
    the same gate list, and the fused lowering's state equals the JAX
    dense engine's within 5e-5."""
    jc = fuzz_circuit(np.random.RandomState(seed), 5, 25)
    c = port_circuit(jc)
    for style, opt in MODES:
        got = L.lower(c, style, optimize=opt)
        assert_same_circuit(got, jlower.lower(jc, style, optimize=opt))
        assert {g.name for g in got.gates} <= set(L.BASIS) | {"measure",
                                                              "barrier"}
    np.testing.assert_allclose(
        dense.run_statevector(L.lower(c), device="cpu").numpy(),
        np.asarray(jdense.run_statevector(jc)), atol=5e-5)


GRAPHS = [[[0]], [[0, 1]], [[0, 1], [1, 2], [2, 3]], [[0, 1, 2]],
          [[0, 1, 2, 3]]]


@pytest.mark.parametrize("cliques", GRAPHS)
@pytest.mark.parametrize("style", ["fused", "literal"])
def test_lowered_qcmrf_exact_state(cliques, style):
    """The lowered QCMRF circuit's full state (global phase included)
    equals the unlowered circuit's on the port's dense engine, and the JAX
    lowering's on JAX's, within 1e-5."""
    rng = np.random.RandomState(7)
    dim = sum(1 << len(C) for C in cliques)
    q = compiler.QCMRF.build(cliques, theta=-np.abs(rng.randn(dim)) * 0.5,
                             with_measurements=False)
    jq = jcompiler.QCMRF.build(cliques, theta=np.asarray(q.theta),
                               with_measurements=False)
    for opt in (0, 1):
        low = q.lowered(style=style, optimize=opt)
        assert_same_circuit(low, jq.lowered(style=style, optimize=opt))
        got = dense.run_statevector(low, device="cpu").numpy()
        np.testing.assert_allclose(
            got, dense.run_statevector(q.circuit, device="cpu").numpy(),
            atol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(jdense.run_statevector(
                jq.lowered(style=style, optimize=opt))), atol=1e-5)


def test_qcmrf_lowered_workspace_and_basis():
    """Variable 0 in no clique: the facade passes workspace = n, which the
    idle-qubit default also finds; another basis raises."""
    theta = -np.abs(np.random.RandomState(6).randn(4)) * 0.5
    q = compiler.QCMRF.build([[1, 2]], theta=theta, with_measurements=False)
    jq = jcompiler.QCMRF.build([[1, 2]], theta=theta,
                               with_measurements=False)
    assert q.mrf.n == 3
    assert_same_circuit(q.lowered("literal"), jq.lowered("literal"))
    assert_same_circuit(L.lower(q.circuit, "literal"), q.lowered("literal"))
    bad = compiler.QCMRF.build([[0, 1]], theta=theta,
                               basis_gates=("cx", "u3"))
    with pytest.raises(ValueError, match="unsupported basis"):
        bad.lowered()
    with pytest.raises(ValueError, match="unknown lowering style"):
        L.lower(q.circuit, "qiskit")
    full = Circuit(2)
    full.flags_phase([0], [1], 0.3, control=1)
    with pytest.raises(ValueError, match="workspace"):
        L.lower(full, "literal")
    with pytest.raises(ValueError, match="cannot lower"):
        L.lower(Circuit(3, gates=[Gate("ccz", (0, 1, 2))]))


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_mcp_and_mcx_synthesis_match(m):
    got, want = Circuit(m + 1), JCircuit(m + 1)
    for c, mod in ((got, L), (want, jlower)):
        for q in range(m):
            c.h(q)
        mod._emit_mcp(c, 0.9, list(range(m)))
        mod._emit_mcx(c, list(range(m - 1)), m)
    assert_same_circuit(got, want)
    state = dense.run_statevector(got, device="cpu").numpy()
    np.testing.assert_allclose(state, np.asarray(jdense.run_statevector(
        want)), atol=1e-5)


def test_basis_gate_counts_match():
    assert qcmrf_tpu_torch.lower is L.lower
    assert qcmrf_tpu_torch.basis_gate_counts is L.basis_gate_counts
    rng = np.random.RandomState(1)
    for cliques in ([[0, 1]], [[0, 1, 2], [2, 3]]):
        dim = sum(1 << len(C) for C in cliques)
        theta = -np.abs(rng.randn(dim)) * 0.5
        jm, m = models(cliques, theta)
        c, jc = compiler.compile_qcmrf(m), jcompiler.compile_qcmrf(jm)
        for style in ("fused", "literal"):
            counts = L.basis_gate_counts(c, style=style)
            assert counts == jlower.basis_gate_counts(jc, style=style)
            assert set(counts) <= set(L.BASIS)
        assert (L.basis_gate_counts(c, "literal")["cx"]
                > L.basis_gate_counts(c)["cx"])


def assert_same_sum(got, want):
    assert got.n == want.n
    assert [m for m, _ in got.terms] == [m for m, _ in want.terms]
    np.testing.assert_allclose([c for _, c in got.terms],
                               [c for _, c in want.terms], rtol=0,
                               atol=1e-12)


def test_pauli_terms_and_diagonals_match():
    """identity, z_on, projector, the algebra and sufficient statistics:
    the same Z-string terms, and diagonals equal to JAX's (float32 there)
    within 1e-6."""
    pairs = [(pauli.identity(3), jpauli.identity(3)),
             (pauli.z_on(3, 1), jpauli.z_on(3, 1)),
             (pauli.projector(2, 0, 0), jpauli.projector(2, 0, 0)),
             (pauli.projector(2, 1, 1), jpauli.projector(2, 1, 1))]
    Z0, jZ0 = pauli.z_on(2, 0), jpauli.z_on(2, 0)
    pairs.append(((pauli.identity(2) + Z0) * 0.5,
                  (jpauli.identity(2) + jZ0) * 0.5))
    pairs.append((Z0 @ Z0, jZ0 @ jZ0))
    pairs.append((2.0 * Z0, 2.0 * jZ0))
    for n, C in ((3, [0, 2]), (4, [1, 2, 3]), (5, [4])):
        for y in itertools.product([0, 1], repeat=len(C)):
            pairs.append((pauli.sufficient_statistic(n, C, y),
                          jpauli.sufficient_statistic(n, C, y)))
    for got, want in pairs:
        assert_same_sum(got, want)
        assert got.as_dict() == pytest.approx(want.as_dict())
        d = got.diagonal(device="cpu")
        assert d.dtype == torch.float64 and d.shape == (1 << got.n,)
        np.testing.assert_allclose(d.numpy(), np.asarray(want.diagonal()),
                                   rtol=0, atol=1e-6)
    assert Z0.adjoint() is Z0
    np.testing.assert_array_equal(
        pauli.projector(2, 0, 0).diagonal(device="cpu").numpy(),
        [1, 1, 0, 0])


def test_facade_operators_match():
    """QCMRF.sufficient_statistic, Hamiltonian and _conjugate_blocks
    against JAX's; the Hamiltonian's diagonal is minus the log-potential
    table."""
    cliques = [[0, 1], [1, 2, 3]]
    theta = -np.abs(np.random.RandomState(4).randn(12))
    q = compiler.QCMRF.build(cliques, theta=theta)
    jq = jcompiler.QCMRF.build(cliques, theta=theta)
    assert_same_sum(q.sufficient_statistic([0, 2], [1, 0]),
                    jq.sufficient_statistic([0, 2], [1, 0]))
    H = q.Hamiltonian()
    assert_same_sum(H, jq.Hamiltonian())
    np.testing.assert_allclose(
        H.diagonal(device="cpu").numpy(),
        -q.mrf.all_log_potentials().double().numpy(), rtol=1e-6, atol=1e-6)
    blocks = q._conjugate_blocks(H)
    assert_same_sum(blocks, jq._conjugate_blocks(jq.Hamiltonian()))
    d = blocks.diagonal(device="cpu")
    torch.testing.assert_close(d[: 1 << 4], d[1 << 4:])
    A = pauli.z_on(2, 1)
    np.testing.assert_array_equal(
        pauli.conjugate_blocks(A).diagonal(device="cpu").numpy(),
        [1, -1, 1, -1, 1, -1, 1, -1])
