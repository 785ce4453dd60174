"""The port's gate-level sharded engine (``qcmrf_tpu_torch.parallel.sharded``:
``run_statevector_sharded``, ``sharded_outcome_probs``, the fused plan)
on ``Mesh((cpu,) * 4)`` and ``(cpu,) * 8`` against the JAX package's on its
8 virtual CPU devices: every gate-level case of tests/test_sharded.py, the
same circuits on both sides (built by the JAX package, carried across gate
for gate). Amplitudes and distributions agree within 2e-6 abs; the fused
plan and the remap count equal JAX's exactly."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.circuits import compiler as jcompiler  # noqa: E402
from qcmrf_tpu.circuits.ir import Circuit as JCircuit  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.parallel import sharded as jsharded  # noqa: E402

from qcmrf_tpu_torch.circuits.ir import Circuit, Gate  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.ops import kernels  # noqa: E402
from qcmrf_tpu_torch.parallel import sharded  # noqa: E402
from qcmrf_tpu_torch.sim import analytic, dense, planes  # noqa: E402

CPU = torch.device("cpu")
ATOL = 2e-6


def port_circuit(jc) -> Circuit:
    return Circuit(
        num_qubits=jc.num_qubits, num_clbits=jc.num_clbits,
        gates=[Gate(g.name, g.qubits, g.params, g.flags, g.clbits)
               for g in jc.gates],
        global_phase=jc.global_phase, name=jc.name)


def qcmrf(cliques, seed, scale=0.4, measure=True):
    """A QCMRF circuit compiled by the JAX package from theta =
    -|randn(seed)| * scale, with the port's model of the same theta."""
    probe = JMRF.create(cliques)
    theta = (-np.abs(np.random.RandomState(seed).randn(probe.dimension))
             * scale).astype(np.float32)
    jm = JMRF.create(cliques, theta=jnp.asarray(theta))
    jc = jcompiler.compile_qcmrf(jm, with_measurements=measure)
    return jc, MRF.from_numpy(jm.cliques, theta, 1.0, jm.n, device=CPU)


@pytest.fixture(scope="module")
def jmeshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return {4: jsharded.make_mesh(4), 8: jsharded.make_mesh(8)}


MESHES = {4: sharded.Mesh((CPU,) * 4), 8: sharded.make_mesh(8, device="cpu")}


def both_states(jc, D, jmeshes):
    """(port state, JAX state, port remaps, JAX remaps) of one circuit on
    a D-device mesh, the port's shards gathered."""
    re, im = sharded.run_statevector_sharded(port_circuit(jc), MESHES[D])
    remaps = sharded.LAST_REMAP_COUNT
    assert len(re) == len(im) == D
    assert all(r.shape == ((1 << jc.num_qubits) // D,) for r in re)
    got = sharded.gather(re).numpy() + 1j * sharded.gather(im).numpy()
    jre, jim = jsharded.run_statevector_sharded(jc, jmeshes[D])
    want = np.asarray(jre) + 1j * np.asarray(jim)
    return got, want, remaps, jsharded.LAST_REMAP_COUNT


def check_state(jc, D, jmeshes, atol=ATOL):
    got, want, remaps, jremaps = both_states(jc, D, jmeshes)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert remaps == jremaps
    return got, remaps


def check_probs(jc, D, jmeshes):
    parts = sharded.sharded_outcome_probs(port_circuit(jc), MESHES[D])
    got = sharded.gather(parts).numpy()
    want = np.asarray(jsharded.sharded_outcome_probs(jc, jmeshes[D]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    return parts, got


def bell():
    c = JCircuit(4)
    c.h(3).cx(3, 0)  # a sharded qubit (3) entangled with a local one
    return c


def h_wall(n=6):
    c = JCircuit(n)
    for q in range(n):
        c.h(q)
    return c


def rz_cp_on_device_bits():
    c = h_wall(4)
    c.rz(0.7, 3)      # a device bit on a 4-device mesh
    c.cp(1.1, 2, 3)   # both device bits
    return c


def scrambled():
    """tests/test_sharded.py's general final permutation (n = 6 on 8
    devices, local_n 3)."""
    rng = np.random.RandomState(11)
    c = JCircuit(6)
    for i, q in enumerate([5, 1, 4, 0, 3, 2, 5, 4, 1, 3, 0, 2]):
        if i % 3 == 2:
            c.x(q)
        else:
            c.h(q)
        c.rz(float(rng.uniform(-np.pi, np.pi)), q)
    c.cx(5, 0).cx(0, 4).cx(3, 5)
    return c


def phased(n):
    """A global phase on the small path (n = 6) and the fused one (n =
    12 on 4 shards: local_n 10)."""
    c = h_wall(n)
    c.sx(n - 1).rz(0.3, 2).cx(n - 1, 1)
    c.add_global_phase(0.7)
    return c


@pytest.mark.parametrize("case,D", [("bell", 4), ("h_wall", 8),
                                    ("rz_cp", 4), ("scrambled", 8),
                                    ("phased6", 4), ("phased12", 4)])
def test_small_circuits_equal_jax(jmeshes, case, D):
    """The gate-by-gate path (shards under 2^10): bell on a sharded qubit,
    the H wall, rz / cp on device bits and a general final permutation
    (>= 2 exchanges) equal JAX's amplitudes and remap count; so does a
    global phase on both paths."""
    jc = {"bell": bell, "h_wall": h_wall, "rz_cp": rz_cp_on_device_bits,
          "scrambled": scrambled, "phased6": lambda: phased(6),
          "phased12": lambda: phased(12)}[case]()
    got, remaps = check_state(jc, D, jmeshes)
    if case == "scrambled":
        assert remaps >= 2
    if case == "h_wall":
        np.testing.assert_allclose(got, 2 ** -3, atol=1e-6)


def scrambled_wide(n):
    """tests/test_torch_gpu.py's circuit, built by the JAX package: an H
    wall, 1q gates on both device qubits of 4 shards, sx and rz over every
    row qubit, twice, and two cx; the restore ends in a general
    permutation of the local bits."""
    c = JCircuit(n)
    rng = np.random.RandomState(7)
    for q in range(n):
        c.h(q)
    for _ in range(2):
        c.sx(n - 1).sx(n - 2)
        for q in range(7, n - 2):
            c.sx(q).rz(float(rng.uniform(-np.pi, np.pi)), q)
    c.cx(n - 1, 3).cx(n - 2, n - 3)
    return c


def test_fused_general_final_permutation_equals_jax(jmeshes):
    """The fused path (local_n 11 on 4 shards) through 8 exchanges and a
    general local permutation: JAX's amplitudes and remap count."""
    jc = scrambled_wide(13)
    plan, _ = sharded._plan_fused(port_circuit(jc), 11, 2)
    assert any(p[0] == "perm" for p in plan)
    _, remaps = check_state(jc, 4, jmeshes)
    assert remaps == 8


@pytest.mark.parametrize("cliques", [
    [[0, 1]],
    [[0, 1], [1, 2], [2, 3]],
    [[0, 1, 2], [2, 3, 4]],
])
def test_qcmrf_circuit_probs_equal_jax(jmeshes, cliques):
    """Whole compiled QCMRF circuits on 4 shards: the outcome distribution
    equals JAX's and the closed-form law."""
    jc, m = qcmrf(cliques, seed=5)
    _, got = check_probs(jc, 4, jmeshes)
    np.testing.assert_allclose(got, analytic.joint_outcome_probs(m).numpy(),
                               rtol=0, atol=1e-5)


def test_qcmrf_2e20_amplitudes(jmeshes):
    """The fused path at 2^20 amplitudes (a 10-variable chain, local_n 17
    on 8 shards): JAX's amplitudes and remap count (>= 2), and the
    accepted mass is Z / 2^n."""
    jc, m = qcmrf([[i, i + 1] for i in range(9)], seed=12, scale=0.3,
                  measure=False)
    assert jc.num_qubits == 20
    got, remaps = check_state(jc, 8, jmeshes)
    assert remaps >= 2
    probs = np.abs(got) ** 2
    np.testing.assert_allclose(probs[: 1 << m.n].sum(),
                               float(m.success_rate()), atol=1e-5)


def check_same_item(got, want):
    """One plan item (or op field) equal to JAX's: kinds, qubits and
    conditions exactly, numbers within 1e-12, symbolic angles part for
    part; a lane op's matrix within 1e-6 (the port's op also carries the
    factors of M)."""
    if isinstance(want, jsharded._SymAngle):
        assert isinstance(got, sharded._SymAngle)
        assert set(got.parts) == set(want.parts)
        for k, v in want.parts.items():
            assert abs(got.parts[k] - v) <= 1e-12
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    elif isinstance(want, (tuple, list)):
        if want and want[0] == "lane":
            assert got[0] == "lane" and len(got) == 3
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
            return
        assert len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            check_same_item(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-12
    else:
        assert got == want


@pytest.mark.parametrize("case", ["chain_local11", "lowered_chain",
                                  "chain_dlog0"])
def test_plan_fused_equals_jax(case):
    """``_plan_fused`` gives JAX's plan item for item (op kinds, physical
    qubits, symbolic angle parts within 1e-12) and its remap count
    exactly: a 7-variable QCMRF chain at local_n 11 on 8 shards, the same
    chain lowered to the basis gates, and a 10-variable chain on one
    shard."""
    nn = 10 if case == "chain_dlog0" else 7
    jc, _ = qcmrf([[i, i + 1] for i in range(nn - 1)], seed=3, scale=0.3,
                  measure=False)
    if case == "lowered_chain":
        jm = JMRF.create([[i, i + 1] for i in range(nn - 1)], theta=(
            -np.abs(np.random.RandomState(3).randn(4 * (nn - 1))) * 0.3))
        jc = jcompiler.QCMRF(jm, jcompiler.compile_qcmrf(
            jm, with_measurements=False)).lowered()
    dlog = 0 if case == "chain_dlog0" else 3
    local_n = jc.num_qubits - dlog
    want, jremaps = jsharded._plan_fused(jc, local_n, dlog)
    got, remaps = sharded._plan_fused(port_circuit(jc), local_n, dlog)
    assert remaps == jremaps
    if dlog:
        assert remaps >= 2
    assert [i[0] for i in got] == [i[0] for i in want]
    for g, w in zip(got, want):
        if g[0] == "ops":
            assert [o[0] for o in g[1]] == [o[0] for o in w[1]]
        check_same_item(g, w)


def test_plan_folds_uniform_into_first_sandwich():
    """The write-only uniform init folds INTO the head sandwich group of
    the plan (``sandwichku``) at one shard and at 8: no standalone
    ``init_uniform`` pass remains (tests/test_sharded.py's plan pin)."""
    jc, _ = qcmrf([[i, i + 1] for i in range(9)], seed=12, scale=0.3,
                  measure=False)
    circ = port_circuit(jc)
    n = circ.num_qubits
    for dlog in (0, 3):
        plan, _ = sharded._plan_fused(circ, n - dlog, dlog)
        head = plan[0]
        assert head[0] == "ops" and head[1][0][0] == "sandwichku"
        kinds = [o[0] for e in plan if e[0] == "ops" for o in e[1]]
        assert "init_uniform" not in kinds


def test_a_shard_with_carrier_0_comes_out_all_zero():
    """The uniform init's carrier: a shard whose untouched device bits are
    not all 0 gets carrier 0, and its write-only pass (and the plain
    uniform planes) write an all-zero shard, whatever the planes held;
    carrier c scales the state by c."""
    nq, folded = 10, (0, 1, 2, 3)
    rng = np.random.RandomState(0)
    out = tuple(torch.from_numpy(rng.randn(8, 128).astype(np.float32))
                for _ in range(2))
    re, im = kernels.apply_hdh_sandwich_multi_uniform(
        nq, folded, 8, ((((0, 1),),),), ((0.3,),), (0.1,),
        out=out, carrier=0.0)
    assert not re.any() and not im.any()
    ref = kernels.apply_hdh_sandwich_multi_uniform(
        nq, folded, 8, ((((0, 1),),),), ((0.3,),), (0.1,), device="cpu")
    half = kernels.apply_hdh_sandwich_multi_uniform(
        nq, folded, 8, ((((0, 1),),),), ((0.3,),), (0.1,), device="cpu",
        carrier=0.5)
    torch.testing.assert_close(half[0], ref[0] * 0.5, rtol=0, atol=1e-7)
    u = kernels.uniform_planes(nq, folded, device="cpu", carrier=0.0)
    assert not u[0].any() and not u[1].any()
    # in the engine: an H wall on the local qubits only (device bits
    # untouched) leaves every shard but the first all zero
    c = JCircuit(12)
    for q in range(10):
        c.h(q)
    re, im = sharded.run_statevector_sharded(port_circuit(c), MESHES[4])
    assert all(not r.any() for r in re[1:]) and re[0].abs().min() > 0


def test_plan_cache_hit_and_miss(jmeshes):
    """A repeated gate stream hits the plan cache (no new entry, the
    planner's remap count reported again, the same state); another
    circuit misses."""
    jc, _ = qcmrf([[0, 1], [1, 2]], seed=9)
    circ = port_circuit(jc)
    before = len(sharded._SV_PLAN_CACHE)
    r1 = sharded.run_statevector_sharded(circ, MESHES[4])
    remaps = sharded.LAST_REMAP_COUNT
    assert len(sharded._SV_PLAN_CACHE) == before + 1
    r2 = sharded.run_statevector_sharded(circ, MESHES[4])
    assert len(sharded._SV_PLAN_CACHE) == before + 1
    assert sharded.LAST_REMAP_COUNT == remaps
    torch.testing.assert_close(sharded.gather(r1[0]), sharded.gather(r2[0]),
                               rtol=0, atol=0)
    other, _ = qcmrf([[0, 1, 2]], seed=9)
    sharded.run_statevector_sharded(port_circuit(other), MESHES[4])
    assert len(sharded._SV_PLAN_CACHE) == before + 2


def wiring(case):
    """tests/test_sharded.py's wiring cases, built by the JAX package."""
    if case == "permuted":
        n = 6
        c = JCircuit(n, num_clbits=n)
        for q in range(n):
            c.h(q)
        c.rz(0.9, 5).cx(5, 0).cp(0.6, 4, 1).cx(2, 3)
        for q, k in enumerate([3, 5, 0, 4, 2, 1]):
            c.measure(q, k)
        return c
    if case == "subset":
        c = JCircuit(6, num_clbits=3)
        for q in range(6):
            c.h(q)
        c.cx(5, 1).rz(0.4, 4)
        c.measure(5, 0).measure(1, 2).measure(3, 1)
        return c
    if case == "smaller_than_mesh":
        c = JCircuit(5, num_clbits=1)
        for q in range(5):
            c.h(q)
        c.cx(4, 2).rz(0.7, 3)
        c.measure(3, 0)
        return c
    if case == "identity_subset":
        c = JCircuit(5, num_clbits=5)
        for q in range(5):
            c.h(q)
        c.cx(4, 0)
        for q in range(4):  # qubit 4 stays unmeasured AND superposed
            c.measure(q, q)
        return c
    if case == "identity_subset_local":
        c = JCircuit(5, num_clbits=5)
        for q in range(5):
            c.h(q)
        c.cx(4, 1)
        for q in (0, 2, 3, 4):  # qubit 1, a local bit, stays unmeasured
            c.measure(q, q)
        return c
    if case == "workspace":
        return qcmrf([[0, 1], [1, 2]], seed=11)[0]
    if case == "no_measurements":
        return qcmrf([[0, 1], [1, 2]], seed=3, measure=False)[0]
    # permuted wiring on the fused path: 14 qubits, local_n 12 on 4 shards
    n = 14
    c = JCircuit(n, num_clbits=n)
    rng = np.random.RandomState(2)
    for q in range(n):
        c.h(q)
    for q in (13, 12, 3, 9):
        c.rz(float(rng.uniform(-np.pi, np.pi)), q)
    c.cx(13, 0).cp(0.6, 12, 1).cx(2, 11).sx(12).cx(12, 8)
    for q, k in enumerate(rng.permutation(n)):
        c.measure(q, int(k))
    return c


@pytest.mark.parametrize("case", ["permuted", "subset", "smaller_than_mesh",
                                  "identity_subset", "identity_subset_local",
                                  "workspace",
                                  "no_measurements", "permuted_fused"])
def test_outcome_probs_wiring_equals_jax(jmeshes, case):
    """Every wiring route of ``sharded_outcome_probs`` equals JAX's and
    the dense engine's distribution: keyed over key space (one part an
    owner), the register smaller than the mesh (a 1-tuple), identity
    subsets whose stray mass (on a device bit, on a local bit) reroutes
    them, the workspace and no-measurement
    fast paths (the shards' |psi|^2)."""
    jc = wiring(case)
    parts, got = check_probs(jc, 4, jmeshes)
    circ = port_circuit(jc)
    want = dense.outcome_probs(circ, dense.run_statevector(circ,
                                                           device="cpu"))
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL)
    assert np.isclose(got.sum(), 1.0, atol=1e-6)
    assert len(parts) == (1 if case == "smaller_than_mesh" else 4)
    if case in ("workspace", "no_measurements"):
        assert parts[0].shape == ((1 << jc.num_qubits) // 4,)
    if case == "permuted_fused":
        assert sharded.LAST_REMAP_COUNT >= 1


def test_keyed_marginalization_31_clbit_guard():
    """Non-identity wiring past 31 clbits raises before the statevector
    runs, with JAX's message (the port's keys are int64, but both
    packages refuse the same inputs)."""
    c = Circuit(num_qubits=4, num_clbits=33)
    c.h(0)
    c.measure(0, 32)
    with pytest.raises(ValueError, match="31 clbits"):
        sharded.sharded_outcome_probs(c, MESHES[8])


def test_engine_refuses_more_device_bits_than_qubits():
    c = Circuit(3)
    c.h(0)
    with pytest.raises(ValueError, match="more device bits than qubits"):
        sharded.run_statevector_sharded(c, MESHES[8])


def test_local_permutation_by_bit_swaps():
    """The final local permutation, a run of 5-axis bit swaps, equals the
    transpose of the (2,) * L view at every axes order of a random case
    (the card's copy kernels take at most 25 axes, so the engine never
    makes that view)."""
    rng = np.random.RandomState(4)
    L = 9
    x = torch.from_numpy(rng.randn(1 << L).astype(np.float32))
    for _ in range(5):
        axes = tuple(int(a) for a in rng.permutation(L))
        t = x.clone()
        sharded._permute_local(t, axes, L)
        want = x.reshape((2,) * L).permute(axes).reshape(-1)
        assert torch.equal(t, want)


def test_stray_mass_is_the_masked_sum():
    """The identity fast path's stray-mass check, a sum of strided views
    of one shard, equals the sum under the mask "any listed qubit is 1"
    within 1e-12, for local bits and device bits set or clear in the
    shard."""
    rng = np.random.RandomState(6)
    L = 10
    x = torch.arange(1 << L)
    for _ in range(40):
        qubits = sorted(int(q) for q in rng.choice(L + 2, rng.randint(1, 7),
                                                   replace=False))
        d = int(rng.randint(4))
        p = torch.from_numpy(rng.rand(1 << L))
        mask = torch.zeros(1 << L, dtype=torch.bool)
        for q in qubits:
            mask |= (((x >> q) & 1) == 1) if q < L else bool((d >> (q - L))
                                                              & 1)
        got = sharded._stray_mass(p, qubits, L, d)
        assert abs(float(got - p[mask].sum())) <= 1e-12, (qubits, d)


def test_fused_mesh_of_one_equals_the_single_device_engine():
    """On a mesh of one device there is no exchange: the fused plan's
    state equals ``planes.run_statevector`` bit for bit."""
    _, m = qcmrf([[i, i + 1] for i in range(5)], seed=1, scale=0.3)
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf

    circ = compile_qcmrf(m, with_measurements=False)
    re, im = sharded.run_statevector_sharded(circ, sharded.Mesh((CPU,)))
    assert sharded.LAST_REMAP_COUNT == 0
    wr, wi = planes.run_statevector(circ, device="cpu")
    assert torch.equal(re[0], wr.reshape(-1))
    assert torch.equal(im[0], wi.reshape(-1))
