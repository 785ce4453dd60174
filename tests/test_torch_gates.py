"""Port parity of the generic gate passes: each plain version against its
JAX Pallas kernel (interpret mode), the fused plane engine against
``qcmrf_tpu.sim.tpu`` and both dense engines on random circuits, lowered
QCMRF circuits and suite circuits with ancillas below qubit 7, and the
unfused per-gate path against the fused stream. On the CPU every gate
wrapper runs its plain version; tests/test_torch_gpu.py holds the CUDA
kernels against them.

Tolerances, as the JAX package's own tests state them: 1e-5 a pass, 2e-5
for lowered circuits, 5e-5 for the random-circuit fuzz. Every state is a
unit-norm random vector, so one float32 ulp of the largest amplitude is
far below each."""

import functools
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.circuits.compiler import compile_qcmrf as jcompile  # noqa: E402
from qcmrf_tpu.circuits.ir import Circuit as JCircuit  # noqa: E402
from qcmrf_tpu.circuits.lower import lower as jlower  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.ops import kernels as jkernels  # noqa: E402
from qcmrf_tpu.sim import dense as jdense  # noqa: E402
from qcmrf_tpu.sim import tpu as jtpu  # noqa: E402

from qcmrf_tpu_torch.circuits.ir import Circuit, Gate  # noqa: E402
from qcmrf_tpu_torch.circuits.lower import lower  # noqa: E402
from qcmrf_tpu_torch.ops import _build, kernels  # noqa: E402
from qcmrf_tpu_torch.sim import dense, planes  # noqa: E402

H = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2)


def state(nq, seed):
    """A unit-norm random complex state as float32 (re, im) numpy."""
    rng = np.random.RandomState(seed)
    v = rng.randn(1 << nq) + 1j * rng.randn(1 << nq)
    v = (v / np.linalg.norm(v)).astype(np.complex64)
    return v.real.copy(), v.imag.copy()


def port_planes(re, im):
    return (torch.from_numpy(re.copy()).reshape(-1, 128),
            torch.from_numpy(im.copy()).reshape(-1, 128))


def jax_planes(re, im):
    return jnp.asarray(re.reshape(-1, 128)), jnp.asarray(im.reshape(-1, 128))


def to_complex(re, im):
    return (np.asarray(re).reshape(-1).astype(np.complex64)
            + 1j * np.asarray(im).reshape(-1))


def assert_pass_matches(port_fn, jax_fn, nq, seed, atol=1e-5):
    """A port pass (in place, on CPU planes) against its JAX kernel."""
    re, im = state(nq, seed)
    pr, pi = port_planes(re, im)
    got = port_fn(pr, pi)
    assert got[0] is pr and got[1] is pi  # updated in place
    want = jax_fn(*jax_planes(re, im))
    np.testing.assert_allclose(to_complex(*got), to_complex(*want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("q", [0, 3, 6, 7, 9])
def test_apply_1q_matches_pallas(q):
    """Hadamard on lane (the factored pass) and row qubits, n = 10."""
    assert_pass_matches(
        lambda r, i: kernels.apply_1q(r, i, H, q, 10),
        lambda r, i: jkernels.apply_1q(r, i, H, q, 10), 10, 6)


@pytest.mark.parametrize("q", [2, 8])
def test_apply_1q_complex_gate_matches_pallas(q):
    sx = np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], np.complex64) / 2
    assert_pass_matches(
        lambda r, i: kernels.apply_1q(r, i, sx, q, 9),
        lambda r, i: jkernels.apply_1q(r, i, sx, q, 9), 9, 7)


def test_row_gate_high_qubit_stride_matches_pallas():
    """q = 16 of 17 qubits: the partner half lies 2^16 values away (the
    JAX kernel's stride-axis tiling case)."""
    U = np.array([[0.6, 0.8j], [0.8j, 0.6]], np.complex64)
    assert_pass_matches(
        lambda r, i: kernels.apply_1q(r, i, U, 16, 17),
        lambda r, i: jkernels.apply_1q(r, i, U, 16, 17), 17, 2)


@pytest.mark.parametrize("q_lo", [7, 8])
def test_row_pair_matches_pallas(q_lo):
    rng = np.random.RandomState(q_lo)
    U4 = (rng.randn(4, 4) + 1j * rng.randn(4, 4)).astype(np.complex64) / 3
    assert_pass_matches(
        lambda r, i: kernels.apply_2q_row_pair(r, i, U4, q_lo),
        lambda r, i: jkernels.apply_2q_row_pair(r, i, U4, q_lo), 10, 3)
    ref = kernels.apply_2q_row_pair_reference(
        *port_planes(*state(10, 3)), U4, q_lo)
    got = kernels.apply_2q_row_pair(*port_planes(*state(10, 3)), U4, q_lo)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("conds", [
    (), ((3, 1),), ((0, 0), (9, 1)), ((9, 1), (2, 0), (7, 1), (4, 1)),
])
def test_masked_rotation_matches_pallas(conds):
    assert_pass_matches(
        lambda r, i: kernels.apply_masked_rotation(r, i, conds, -0.35, 2.1),
        lambda r, i: jkernels.apply_masked_rotation(r, i, conds, -0.35, 2.1),
        10, 4)


def profile(regime, seed):
    """Terms and angles of one diagonal pass in each of the JAX kernel's
    evaluation regimes: the multilinear cos/sin select (support <= 4
    bits), rotor composition (<= 12 terms), and the accumulated angle
    (up to 64 terms, with an empty and a contradictory term)."""
    rng = np.random.RandomState(seed)
    if regime == "multilinear":
        bits, count = (0, 3, 8, 9), 8
    elif regime == "rotor":
        bits, count = tuple(range(10)), 12
    else:
        bits, count = tuple(range(10)), 62
    terms = []
    for _ in range(count):
        k = rng.randint(1, min(4, len(bits)) + 1)
        terms.append(tuple((int(p), int(rng.randint(2)))
                           for p in rng.choice(bits, k, replace=False)))
    if regime == "angle":
        terms += [(), ((5, 1), (5, 0))]
    return tuple(terms), tuple(rng.uniform(-np.pi, np.pi, len(terms)))


@pytest.mark.parametrize("regime", ["multilinear", "rotor", "angle"])
def test_diagonal_profile_matches_pallas(regime):
    terms, angles = profile(regime, 11)
    assert_pass_matches(
        lambda r, i: kernels.apply_diagonal_profile(r, i, terms, angles,
                                                    0.45),
        lambda r, i: jkernels.apply_diagonal_profile(r, i, terms, angles,
                                                     0.45), 10, 5)


def lane_wall():
    M = np.eye(128, dtype=np.complex64)
    for q in range(7):
        M = kernels._lane_gate_matrix(H, q) @ M
    return M


@pytest.mark.parametrize("which", ["wall", "random"])
def test_lane_op_matches_pallas(which):
    """The planner's composed lane op: the 7-H wall and a random complex
    M, against the JAX product (float32-exact in interpret mode)."""
    rng = np.random.RandomState(9)
    M = lane_wall() if which == "wall" else (
        (rng.randn(128, 128) + 1j * rng.randn(128, 128)) / 16
    ).astype(np.complex64)
    assert_pass_matches(
        lambda r, i: kernels.apply_lane(r, i, M),
        lambda r, i: jkernels._lane_matmul_call(
            r, i, jnp.asarray(M.real.astype(np.float32)),
            jnp.asarray(M.imag.astype(np.float32))), 9, 8)


def random_factors(count, seed):
    """(7, 2, 2) lane factors: random unitaries on ``count`` lane qubits
    drawn from ``seed``, the identity on the others."""
    rng = np.random.RandomState(seed)
    factors = kernels.identity_factors()
    for q in rng.choice(7, count, replace=False):
        a = rng.randn(2, 2) + 1j * rng.randn(2, 2)
        factors[q] = np.linalg.qr(a)[0].astype(np.complex64)
    return factors


@pytest.mark.parametrize("count", [0, 1, 7])
@pytest.mark.parametrize("nq", [7, 8, 10])
def test_lane_factored_matches_pallas(count, nq):
    """The factored pass's plain version (which the CPU wrapper runs, bit
    for bit) against JAX's executor on ``("lane", kron(factors))``, the
    Pallas product interpreted, within 1e-5."""
    F = random_factors(count, 10 * nq + count)
    re, im = state(nq, count)
    want = jtpu._apply_ops(*jax_planes(re, im), [("lane", kron_factors(F))],
                           nq)
    ref = kernels.apply_lane_factored_reference(*port_planes(re, im), F)
    pr, pi = port_planes(re, im)
    got = kernels.apply_lane_factored(pr, pi, F)
    assert got[0] is pr and got[1] is pi  # updated in place
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    np.testing.assert_allclose(to_complex(*got), to_complex(*want), rtol=0,
                               atol=1e-5)
    if count == 0:
        assert np.array_equal(to_complex(*got), to_complex(re, im))


@pytest.mark.parametrize("q", range(7))
def test_apply_1q_on_lane_qubits_takes_the_factored_pass(q, monkeypatch):
    """apply_1q on qubit 0-6 is one factored pass with the gate as factor
    q and the identity elsewhere, equal to JAX's apply_1q within 1e-5."""
    U = random_factors(7, q)[q]
    calls = []
    factored = kernels.apply_lane_factored

    def spy(re, im, factors):
        calls.append(np.asarray(factors))
        return factored(re, im, factors)

    monkeypatch.setattr(kernels, "apply_lane_factored", spy)
    assert_pass_matches(lambda r, i: kernels.apply_1q(r, i, U, q, 9),
                        lambda r, i: jkernels.apply_1q(r, i, U, q, 9), 9, q)
    assert len(calls) == 1
    want = kernels.identity_factors()
    want[q] = U
    assert np.array_equal(calls[0], want)


def test_executor_routes_lane_ops(monkeypatch):
    """A planner lane op (factors beside M) goes to the factored pass; a
    bare ``("lane", M)``, as JAX's planner makes it, to the dense one."""
    calls = []
    for name in ("apply_lane", "apply_lane_factored"):
        monkeypatch.setattr(kernels, name, lambda re, im, a, name=name: (
            calls.append(name), (re, im))[1])
    F = random_factors(2, 3)
    ops = [("lane", kron_factors(F), F), ("lane", kron_factors(F))]
    planes.apply_ops(*port_planes(*state(8, 1)), ops, 8)
    assert calls == ["apply_lane_factored", "apply_lane"]


def lowered_chain(nn):
    """bench.py's chain of nn variables (width 2 nn), lowered to basis
    gates (fused style), as a JAX and a port circuit."""
    theta = -np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3
    jc = jlower(jcompile(JMRF.create([[i, i + 1] for i in range(nn - 1)],
                                     theta=theta),
                         with_measurements=False), style="fused")
    return jc, port_circuit(jc)


@pytest.mark.parametrize("nn", [5, 6])
def test_lowered_chain_lane_ops_carry_their_factors(nn):
    """Every lane op of the lowered chain at widths 10 and 12: (kind, M)
    equal to JAX's op within 1e-9, kron(factors) equal to M within
    FACTORS_ATOL, and at most a few non-identity factors."""
    jc, c = lowered_chain(nn)
    ops, jops = planes.fuse_ops(c), jtpu.fuse_ops(jc)
    assert_same_ops(ops, jops)
    lanes = [op for op in ops if op[0] == "lane"]
    assert lanes and all(len(op) == 3 for op in lanes)
    eye = np.eye(2, dtype=np.complex64)
    for op in lanes:
        np.testing.assert_allclose(kron_factors(op[2]), op[1], rtol=0,
                                   atol=FACTORS_ATOL)
        assert 1 <= sum(not np.array_equal(f, eye) for f in op[2]) <= 7


def test_lowered_chain_run_ops_matches_jax(monkeypatch):
    """The width-8 lowered chain's whole stream through run_ops on the
    CPU, every lane op a factored pass and none a dense one, against JAX's
    executor on JAX's stream, within 2e-5."""
    jc, c = lowered_chain(4)
    ops = planes.fuse_ops(c)
    calls = []
    for name in ("apply_lane", "apply_lane_factored"):
        real = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda re, im, a, name=name,
                            real=real: (calls.append(name), real(re, im, a))[1])
    got = to_complex(*planes.run_ops(ops, c.num_qubits, "cpu"))
    want = jtpu._apply_ops(*jtpu.zero_planes(jc.num_qubits),
                           jtpu.fuse_ops(jc), jc.num_qubits)
    np.testing.assert_allclose(got, to_complex(*want), rtol=0, atol=2e-5)
    assert calls == ["apply_lane_factored"] * sum(op[0] == "lane"
                                                  for op in ops)


def test_gate_passes_raise_on_bad_inputs():
    pr, pi = port_planes(*state(9, 1))
    with pytest.raises(ValueError, match="row qubits"):
        kernels.apply_2q_row_pair(pr, pi, np.eye(4), 6)
    with pytest.raises(ValueError, match="row qubits"):
        kernels.apply_2q_row_pair(pr, pi, np.eye(4), 8)
    with pytest.raises(ValueError, match="shape"):
        kernels.apply_1q(pr, pi, np.eye(4), 8)
    with pytest.raises(ValueError, match="not 10"):
        kernels.apply_1q(pr, pi, H, 8, 10)
    with pytest.raises(ValueError, match="row qubits"):
        kernels.apply_1q(pr, pi, H, 9)
    with pytest.raises(ValueError, match="shape"):
        kernels.apply_lane(pr, pi, np.eye(64))
    with pytest.raises(ValueError, match="lane factors"):
        kernels.apply_lane_factored(pr, pi, np.eye(2))
    with pytest.raises(ValueError, match="outside"):
        kernels.apply_masked_rotation(pr, pi, ((9, 1),), 0.0, 0.1)
    with pytest.raises(ValueError, match="terms"):
        kernels.apply_diagonal_profile(pr, pi, ((),) * 1025, (0.1,) * 1025)
    small = (torch.zeros(1, 64), torch.zeros(1, 64))
    with pytest.raises(ValueError, match=">= 7"):
        kernels.apply_masked_rotation(*small, (), 0.0, 0.1)
    with pytest.raises(ValueError, match="size or device"):
        kernels.copy_planes(pr, pi, out=(torch.zeros(2, 128),
                                         torch.zeros(2, 128)))
    out = (torch.empty_like(pr), torch.empty_like(pi))
    assert kernels.copy_planes(pr, pi, out=out) is out
    assert torch.equal(out[0], pr) and torch.equal(out[1], pi)
    # one lane_kernel block holds M^T and its tile of rows
    assert kernels.LANE_SHARED_BYTES <= _build.SHARED_BYTES_LIMIT


def fuzz_circuit(rng, n, depth):
    """tests/test_engine_fuzz.py::random_circuit's gate mix, as a JAX
    circuit from a numpy generator."""
    c = JCircuit(n)
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
    return c


def port_circuit(jc) -> Circuit:
    return Circuit(
        num_qubits=jc.num_qubits, num_clbits=jc.num_clbits,
        gates=[Gate(g.name, g.qubits, g.params, g.flags, g.clbits)
               for g in jc.gates],
        global_phase=jc.global_phase, name=jc.name)


#: kron of a lane op's factors against its M: both are composed in
#: complex64 (in another order), a few float32 ulps of entries <= 1
FACTORS_ATOL = 1e-6


def kron_factors(factors):
    """``F6 ⊗ ... ⊗ F0`` of a lane op's (7, 2, 2) factors."""
    return functools.reduce(np.kron, np.asarray(factors)[::-1])


def assert_same_ops(got, want, path="op"):
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
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-9, err_msg=path)
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_ops(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(float(got) - want) <= 1e-9, path
    else:
        assert got == want, path


def run_port(c):
    return to_complex(*planes.run_statevector(c, device="cpu"))


@pytest.mark.parametrize("seed", range(4))
def test_fused_engine_matches_jax_and_dense_on_fuzz(seed):
    """Random circuits over the whole gate set (n = 8, depth 30): the op
    stream equals the JAX planner's; the state equals the JAX plane engine
    and both dense engines within 5e-5."""
    jc = fuzz_circuit(np.random.RandomState(100 + seed), 8, 30)
    c = port_circuit(jc)
    assert_same_ops(planes.fuse_ops(c), jtpu.fuse_ops(jc))
    got = run_port(c)
    np.testing.assert_allclose(got, to_complex(*jtpu.run_statevector(jc)),
                               atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(jdense.run_statevector(jc)),
                               atol=5e-5)
    np.testing.assert_allclose(
        got, dense.run_statevector(c, device="cpu").numpy(), atol=5e-5)


def jmodel(cliques, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    dim = sum(1 << len(C) for C in cliques)
    return JMRF.create(cliques, theta=-np.abs(rng.randn(dim)) * scale)


@pytest.mark.parametrize("cliques,style", [
    ([[0, 1], [1, 2], [2, 3]], "fused"),       # width 8 (the JAX test's)
    ([[0, 1, 2], [2, 3, 4]], "fused"),         # width 8, 3-cliques
    ([[0, 1], [1, 2]], "literal"),             # width 6 + 1 row qubit
])
def test_lowered_qcmrf_on_plane_engine(cliques, style):
    """Lowered QCMRF circuits (measurements included) through every pass
    kind: outcome probabilities equal the JAX dense engine's within 2e-5,
    and the op stream equals the JAX planner's."""
    jc = jlower(jcompile(jmodel(cliques, 5)), style=style)
    if jc.num_qubits < 7:  # widen to the plane engine's floor
        wide = JCircuit(7, jc.num_clbits)
        wide.extend(jc)
        jc = wide
    c = port_circuit(jc)
    assert lower(port_circuit(jcompile(jmodel(cliques, 5))),
                 style=style).count_ops() == jc.count_ops()
    assert_same_ops(planes.fuse_ops(c), jtpu.fuse_ops(jc))
    got = planes.simulate_probs(c, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jdense.simulate_probs(jc)),
                               atol=2e-5)


def test_lowered_state_matches_jax_plane_engine():
    """The width-8 lowered chain, full state and global phase, against the
    JAX plane engine (its Pallas kernels interpreted) within 2e-5."""
    jc = jlower(jcompile(jmodel([[0, 1], [1, 2], [2, 3]], 5),
                         with_measurements=False))
    got = run_port(port_circuit(jc))
    np.testing.assert_allclose(got, to_complex(*jtpu.run_statevector(jc)),
                               atol=2e-5)


@pytest.mark.parametrize("j", [2, 3, 5])
def test_suite_circuits_with_low_ancillas(j):
    """The seed-1984 suite's widths 8-10, whose ancillas sit at qubits 5-9:
    lane and diag passes beside the sandwiches, against the JAX plane
    engine and the dense engine within 1e-5."""
    suite = jsuite.generate_suite(0.1)
    C = suite.graphs[j]
    jc = jcompile(JMRF.create(C, theta=jnp.asarray(suite.thetas[j][0],
                                                   jnp.float32)))
    c = port_circuit(jc)
    kinds = {op[0] for op in planes.fuse_ops(c)}
    assert kinds & {"lane", "diag"}
    got = planes.simulate_probs(c, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jtpu.simulate_probs(jc)),
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jdense.simulate_probs(jc)),
                               atol=1e-5)


def port_model(cliques, seed, scale=0.5):
    from qcmrf_tpu_torch.models.mrf import MRF

    rng = np.random.RandomState(seed)
    dim = sum(1 << len(C) for C in cliques)
    return MRF.create(cliques, theta=-np.abs(rng.randn(dim)) * scale,
                      device="cpu")


def probs_case(name):
    """A circuit of one stream shape and the kind of its last pass."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf

    chain6 = [[i, i + 1] for i in range(5)]
    if name == "two_groups":  # nine ancillas, 7-15: sandwichku, sandwichk
        m = port_model(chain6 + [[0], [1], [2], [3]], 1)
        return compile_qcmrf(m, with_measurements=False), "sandwichk"
    if name == "one_group":  # five ancillas: the write-only pass alone
        return (compile_qcmrf(port_model(chain6, 2),
                              with_measurements=False), "sandwichku")
    if name == "middle_sandwich":
        c = Circuit(9)
        for q in range(7):
            c.h(q)
        c.h(7).cp(0.7, 0, 7).rz(0.3, 7).h(7).sx(2)
        c.h(8).cp(-0.4, 1, 8).rz(0.2, 8).h(8)
        return c, "sandwich"
    if name == "lowered":  # diag, lane and row passes
        return (lower(compile_qcmrf(port_model([[0, 1], [2, 3]], 1),
                                    with_measurements=False)), "lane")
    if name == "global_phase":
        c = compile_qcmrf(port_model([[i, i + 1] for i in range(6)], 5),
                          with_measurements=False)
        c.global_phase = 0.9
        return c, "sandwichku"
    # measured: every qubit but the workspace, so the mass is marginalised
    return compile_qcmrf(port_model(chain6, 4)), "sandwichku"


@pytest.mark.parametrize("name", ["two_groups", "one_group",
                                  "middle_sandwich", "lowered",
                                  "global_phase", "measured"])
def test_simulate_probs_matches_dense(name):
    """``planes.simulate_probs`` on each stream shape (a last read-write
    sandwich pass in its probability form, or ``re * re + im * im`` after
    any other) against the dense engine in complex128 within 1e-6."""
    c, last = probs_case(name)
    ops = planes.fuse_ops(c)
    assert ops[-1][0] == last
    assert (len(c.measured_pairs) not in (0, c.num_qubits)) == (
        name == "measured")
    assert bool(c.global_phase) == (name == "global_phase")
    got = planes.simulate_probs(c, device="cpu")
    want = dense.simulate_probs(c, dtype=torch.complex128, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("lowered", [False, True])
def test_apply_gate_matches_fused_stream(lowered):
    """The unfused per-gate path (and the JAX one) against the fused
    stream, on the mixed-clique QCMRF circuit of the JAX test and on a
    lowered chain; global phase left out on both sides."""
    cliques = [[0, 1], [1, 2], [2, 3]] if lowered else [[0, 1, 2], [2, 3],
                                                        [3, 4, 5, 6]]
    jc = jcompile(jmodel(cliques, 4), with_measurements=False)
    if lowered:
        jc = jlower(jc)
    c = port_circuit(jc)
    nq = c.num_qubits
    re, im = planes.zero_planes(nq, "cpu")
    for g in c.gates:
        planes.apply_gate(re, im, g, nq)
    stepwise = to_complex(re, im)
    fused = to_complex(*planes.run_ops(planes.fuse_ops(c), nq, "cpu"))
    np.testing.assert_allclose(stepwise, fused, atol=1e-5)
    if not lowered:
        jre, jim = jtpu.zero_planes(nq)
        for g in jc.gates:
            jre, jim = jtpu.apply_gate(jre, jim, g, nq)
        np.testing.assert_allclose(stepwise, to_complex(jre, jim),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="unsupported"):
        planes.apply_gate(re, im, Gate("ccz", (0, 1, 2)), nq)
    # a few hundred float32 passes: the norm drifts by ~1e-5
    assert math.isclose(float((re * re + im * im).sum()), 1.0, rel_tol=1e-4)


def test_rates_need_the_card():
    """The rate readers measure the card: a CPU device raises; the GB/s
    conversion is the JAX package's."""
    from qcmrf_tpu.runners import bench as jbench

    from qcmrf_tpu_torch.runners import bench

    for fn in (bench.copy_kernel_gbps, bench.gate_apply_gbps):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(12, device="cpu")
    for args in ((1.0, 28), (0.37, 24, 2)):
        assert bench._pass_ms_to_gbps(*args) == pytest.approx(
            jbench._pass_ms_to_gbps(*args), rel=1e-15)


@pytest.mark.parametrize("steps", [1, 15, 16])
def test_fma_chain_counts_its_steps(steps):
    """The FMA chain's wrapper on the CPU (its plain version): ``steps``
    chained ``x * x + b``, every final value written to ``out`` and their
    max returned. x -> x * x - 1.5 is chaotic, so a step more or fewer
    moves the values by O(1): float32 stays within 1e-3 of float64 at 16
    steps, and one step away lies more than 1 off."""
    x = torch.from_numpy(np.random.RandomState(18).uniform(
        -1, 1, 1 << 12).astype(np.float32))
    out = torch.empty_like(x)
    top = kernels.fma_chain_max(x, -1.5, steps=steps, out=out)
    want = x.double()
    for _ in range(steps):
        want = want * want - 1.5
    torch.testing.assert_close(out.double(), want, rtol=0, atol=1e-3)
    assert float(top) == float(out.max())
    assert float((want * want - 1.5 - want).abs().max()) > 1.0
    z = torch.zeros(8)
    kernels.fma_chain_max(z, -1.0, steps=kernels.FMA_CHAIN - 1, out=out[:8])
    assert bool((out[:8] == -1.0).all())
    for bad in (dict(x=x.double()), dict(x=x[:6]), dict(out=out[:8]),
                dict(steps=1 << 31)):
        with pytest.raises(ValueError):
            kernels.fma_chain_max(**{"x": x, "b": -1.5, "out": out, **bad})
