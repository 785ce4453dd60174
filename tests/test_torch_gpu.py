"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked ``gpu`` and skips where PyTorch sees no CUDA
device. The file imports no JAX, so on a machine without it run it with
``python -m pytest --noconftest tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf, grid_mrf  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.ops import circuit_kernel  # noqa: E402
from qcmrf_tpu_torch.ops import kernels, sampler_kernel  # noqa: E402
from qcmrf_tpu_torch.runners import run_experiment  # noqa: E402
from qcmrf_tpu_torch.sim import analytic, batch, dense, planes  # noqa: E402
from qcmrf_tpu_torch.utils import moebius  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def model(dev, rows=3, cols=4, seed=1, scale=0.3):
    g = grid_mrf(rows, cols, device=dev)
    rng = np.random.RandomState(seed)
    return g.with_theta(-np.abs(rng.randn(g.dimension)).astype(np.float32)
                        * scale)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def test_sampler_kernel_matches_plain_version(dev):
    m = MRF.create([[0, 1, 2], [2, 3], [4], [1, 4]], device=dev,
                   theta=-np.abs(np.random.RandomState(2).randn(18)) * 0.5)
    kc = sampler_kernel.keep_prob_values(m.cliques, m.n, m.theta,
                                         m.beta)[None].repeat(3, 1)
    for mode in sampler_kernel.MODES:
        for shots in (1, 1000, 4099):
            before = sampler_kernel.LAUNCHES["sampler"]
            got = sampler_kernel.sample_call(5, m.cliques, m.n, kc, shots,
                                             mode, 3)
            assert sampler_kernel.LAUNCHES["sampler"] == before + 1
            want = sampler_kernel.sample_call_reference(
                5, m.cliques, m.n, kc, shots, mode, 3)
            for g, w in zip(as_tuple(got), as_tuple(want)):
                assert g.is_cuda and torch.equal(g, w), (mode, shots)


def check_table(cl, n, coef, beta):
    """The table kernel on the card: equal to its split plain version bit
    for bit (both ``fuse_amp`` values), each value within ``split_gap``
    of the chain's, and two launches bit-equal."""
    before = kernels.LAUNCHES["logpot"]
    got = kernels.logpot_table(cl, n, coef, beta)
    assert kernels.LAUNCHES["logpot"] == before + 1
    assert got.is_cuda and got.shape == (coef.shape[0], 1 << n)
    assert torch.equal(got, kernels.logpot_table_split_reference(
        cl, n, coef, beta))
    assert torch.equal(got, kernels.logpot_table(cl, n, coef, beta))
    gap = (got - kernels.logpot_table_reference(cl, n, coef, beta)).abs()
    assert bool((gap.amax(dim=-1) <= kernels.split_gap(coef, beta)).all())
    assert torch.equal(
        kernels.logpot_table(cl, n, coef, beta, True),
        kernels.logpot_table_split_reference(cl, n, coef, beta, True))


def test_table_and_lse_kernels_match_plain_versions(dev):
    m = model(dev)
    coef = kernels.coefficient_table(
        m.cliques, m.n, torch.stack([m.theta, 0.5 * m.theta]))
    check_table(m.cliques, m.n, coef, 1.7)
    got = kernels.combine_lse(*kernels.lse_partials(m.cliques, m.n, coef,
                                                    1.7))
    want = kernels.combine_lse(*kernels.lse_partials_reference(
        m.cliques, m.n, coef, 1.7))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_cuda_models_go_through_the_kernels(dev):
    m = model(dev)
    counts = dict(kernels.LAUNCHES)
    p, delta = analytic.postselected_probs(m)
    assert kernels.LAUNCHES["logpot"] == counts["logpot"] + 1
    assert kernels.LAUNCHES["lse"] == counts["lse"] + 1
    assert p.is_cuda and abs(float(p.sum()) - 1.0) < 1e-5
    cpu = MRF.create(m.cliques, theta=m.theta.cpu(), device="cpu")
    assert abs(float(delta) - float(cpu.success_rate())) < 1e-6
    keys = batch.batched_sample_outcomes([[0, 1], [1, 2]],
                                         [[-0.1] * 8] * 4, 0, 300,
                                         device=dev)
    assert keys.is_cuda and keys.shape == (4, 300)


def test_wrappers_raise_on_bad_inputs(dev):
    cl, n = ((0, 1),), 2
    with pytest.raises(ValueError):  # float64 coefficients
        kernels.logpot_table(cl, n, torch.zeros(1, 4, dtype=torch.float64,
                                                device=dev), 1.0)
    with pytest.raises(ValueError):  # not contiguous
        kernels.lse_partials(cl, n, torch.zeros(4, 2, device=dev).T, 1.0)


def test_circuit_kernel_matches_plain_version(dev):
    suite = generate_suite(0.1)
    cases = [(C, np.asarray(suite.thetas[j], np.float32))
             for j, C in enumerate(suite.graphs)]
    rng = np.random.RandomState(3)
    for nn in (7, 8):  # widths 14 (shared memory) and 16 (global scratch)
        C = [[i, i + 1] for i in range(nn - 1)]
        cases.append((C, -np.abs(rng.randn(2, 4 * (nn - 1))) * 0.4))
    cases.append(([[0, 1, 2], [2, 3], [3, 4, 5]], -np.abs(
        rng.randn(3, 20)) * 0.5))  # width 10, mixed sizes (cmax 3)
    for C, thetas in cases:
        before = circuit_kernel.LAUNCHES["circuit"]
        got = circuit_kernel.batched_circuit_probs(C, thetas, device=dev)
        assert circuit_kernel.LAUNCHES["circuit"] == before + 1
        want = circuit_kernel.batched_circuit_probs_reference(C, thetas,
                                                              device=dev)
        assert got.is_cuda and got.shape == want.shape
        # 2e-5 at the suite's widths (<= 10, values ~1e-3); at widths 14
        # and 16 the values average 2^-13 and 2^-15, so 1e-6 there
        atol = 2e-5 if got.shape[1] <= 1 << 10 else 1e-6
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_circuit_kernel_one_launch_for_many_structures(dev):
    """Every suite structure, the width-14 and width-16 chains and a
    mixed-size structure in one launch (the 16-wide chain's state in the
    global scratch beside shared-memory circuits), each against its plain
    version; beta != 1 reaches the kernel's rotation pairs."""
    suite = generate_suite(0.1)
    rng = np.random.RandomState(4)
    cases = [(C, suite.thetas[j]) for j, C in enumerate(suite.graphs)]
    for nn in (7, 8):
        C = [[i, i + 1] for i in range(nn - 1)]
        cases.append((C, -np.abs(rng.randn(2, 4 * (nn - 1))) * 0.4))
    cases.append(([[0, 1, 2], [2, 3], [3, 4, 5]],
                  -np.abs(rng.randn(3, 20)) * 0.5))
    for beta in (1.0, 0.7):
        before = circuit_kernel.LAUNCHES["circuit"]
        got = circuit_kernel.batched_circuits_probs(cases, beta, dev)
        assert circuit_kernel.LAUNCHES["circuit"] == before + 1
        for (C, thetas), g in zip(cases, got):
            want = circuit_kernel.batched_circuit_probs_reference(
                C, thetas, beta, device=dev)
            assert g.is_cuda and g.shape == want.shape
            atol = 2e-5 if g.shape[1] <= 1 << 10 else 1e-6
            torch.testing.assert_close(g, want, rtol=0, atol=atol)


@pytest.mark.parametrize("nq", [8, 24, 28])
def test_dense_lane_kernel_holds_to_float64(dev, nq):
    """The dense lane kernel within a relative 2-norm of 2e-6 of the
    float64 product, and within 4x float32 torch.matmul's error on the
    same input, on a random M, the 7-H wall and the lowered qcmrf28
    chain's densest lane op given without its factors; and within 1e-5
    of its plain version."""
    from qcmrf_tpu_torch.circuits.compiler import QCMRF

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(24)
    H = np.asarray(dense.GATES_1Q["h"], np.complex64)
    wall = np.eye(128, dtype=np.complex64)
    for q in range(7):
        wall = kernels._lane_gate_matrix(H, q) @ wall
    theta = -np.abs(np.random.RandomState(0).randn(52)) * 0.3
    ops = planes.fuse_ops(QCMRF.build(
        [[i, i + 1] for i in range(13)], theta=theta,
        with_measurements=False).lowered(style="fused"))
    densest = max((op for op in ops if op[0] == "lane"),
                  key=lambda op: np.count_nonzero(op[1]))
    M = ((rng.randn(128, 128) + 1j * rng.randn(128, 128)) / 16).astype(
        np.complex64)
    for lane_op in (M, wall, densest[1]):
        src = unit_planes(nq, 2, dev)
        before = kernels.LAUNCHES["lane"]
        got = kernels.apply_lane(src[0].clone(), src[1].clone(), lane_op)
        assert kernels.LAUNCHES["lane"] == before + 1
        rel = kernels.lane_relative_error(lane_op, src, got)
        X = torch.cat([p.reshape(-1, 128) for p in src], 1)
        f32 = kernels.lane_relative_error(
            lane_op, src, X @ kernels.lane_stacked_w(lane_op, dev))
        assert kernels.lane_accurate(rel, f32), (rel, f32)
        want = kernels.apply_lane_reference(src[0].clone(), src[1].clone(),
                                            lane_op)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        del got, want, X, src
    torch.cuda.empty_cache()


def rand_planes(nq, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    re = torch.randn(1 << nq, generator=g).reshape(-1, 128)
    im = torch.randn(1 << nq, generator=g).reshape(-1, 128)
    return re.to(dev), im.to(dev)


def rand_profiles(nq, a_lo, k, seed):
    rng = np.random.RandomState(seed)
    free = [q for q in range(nq) if not a_lo <= q < a_lo + k]
    nts, nas = [], []
    for _ in range(k):
        terms = tuple(
            tuple((int(p), int(rng.randint(2))) for p in
                  rng.choice(free, rng.randint(1, 4), replace=False))
            for _ in range(rng.randint(0, 5)))
        nts.append(terms)
        nas.append(tuple(rng.randn(len(terms))))
    nbs = tuple(rng.randn(k))
    mu = ((((free[0], 1),), ((free[1], 0), (free[2], 1))), (0.4, -0.8), 0.3)
    return tuple(nts), tuple(nas), nbs, mu


@pytest.mark.parametrize("with_mu", [True, False])
def test_sandwich_kernels_match_plain_versions(dev, with_mu):
    nq = 14
    for k, a_lo in ((1, 13), (1, 0), (2, 7), (3, 2), (4, 9), (5, 7),
                    (6, 3), (7, 7), (7, 0)):
        nts, nas, nbs, mu = rand_profiles(nq, a_lo, k, 10 * k + a_lo)
        if not with_mu:
            mu = ((), (), 0.0)
        before = dict(kernels.LAUNCHES)
        planes_in = rand_planes(nq, k, dev)
        got = kernels.apply_hdh_sandwich_multi(*planes_in, a_lo, nts, nas,
                                               nbs, *mu)
        assert got[0] is planes_in[0]  # in place
        want = kernels.apply_hdh_sandwich_multi_reference(
            *rand_planes(nq, k, dev), a_lo, nts, nas, nbs, *mu)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        folded = tuple(q for q in range(nq)
                       if q % 3 and not a_lo <= q < a_lo + k)
        got = kernels.apply_hdh_sandwich_multi_uniform(
            nq, folded, a_lo, nts, nas, nbs, *mu, device=dev)
        want = kernels.apply_hdh_sandwich_multi_uniform_reference(
            nq, folded, a_lo, nts, nas, nbs, *mu, device=dev)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert kernels.LAUNCHES["hdh_multi"] == before["hdh_multi"] + 1
        assert (kernels.LAUNCHES["hdh_multi_uniform"]
                == before["hdh_multi_uniform"] + 1)


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_probability_form_matches_plain_version(dev, k):
    """The read-write sandwich kernel's probability form at width 24
    against its plain version (the amplitude pass, then re * re + im * im),
    in place into the real plane; one launch."""
    nq, a_lo = 24, 24 - 11
    nts, nas, nbs, mu = rand_profiles(nq, a_lo, k, 10 * k + 3)
    before = dict(kernels.LAUNCHES)
    re, im = rand_planes(nq, k, dev)
    got = kernels.apply_hdh_sandwich_multi_probs(re, im, a_lo, nts, nas,
                                                 nbs, *mu)
    assert got is re
    want = kernels.apply_hdh_sandwich_multi_probs_reference(
        *rand_planes(nq, k, dev), a_lo, nts, nas, nbs, *mu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES["hdh_multi_probs"] == (
        before["hdh_multi_probs"] + 1)
    assert kernels.LAUNCHES["hdh_multi"] == before["hdh_multi"]


@pytest.mark.parametrize("nq,groups", [(24, (7, 7)), (26, (7, 7)),
                                       (26, (7, 1)), (24, (1, 1)),
                                       (24, (7, 7, 2))])
def test_merged_uniform_kernel_matches_the_launches_it_replaces(dev, nq,
                                                                groups):
    """The write-only kernel over the groups' adjacent ancillas (K = their
    sum, up to 16), in both forms, against the launches it replaces: the
    write-only pass of the first group, then the read-write pass of each
    other group; max|diff| / max|ref| <= 1e-6, one launch each."""
    k = sum(groups)
    a_lo = nq - k
    nts, nas, nbs, mu = rand_profiles(nq, a_lo, k, nq + k)
    folded = tuple(q for q in range(a_lo) if q % 3)
    before = dict(kernels.LAUNCHES)
    re, im = kernels.apply_hdh_sandwich_multi_uniform(
        nq, folded, a_lo, nts[:groups[0]], nas[:groups[0]],
        nbs[:groups[0]], *mu, device=dev)
    t = groups[0]
    for g in groups[1:]:
        kernels.apply_hdh_sandwich_multi(re, im, a_lo + t, nts[t:t + g],
                                         nas[t:t + g], nbs[t:t + g])
        t += g
    want = torch.complex(re, im).reshape(-1)
    merged = (nq, folded, a_lo, nts, nas, nbs) + mu
    got = kernels.apply_hdh_sandwich_multi_uniform(*merged, device=dev)
    got = torch.complex(*got).reshape(-1)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-6, err
    del got
    probs = kernels.apply_hdh_sandwich_multi_uniform_probs(*merged,
                                                           device=dev)
    want = want.abs() ** 2
    assert probs.shape == (1 << nq,)
    err = float((probs - want).abs().max() / want.max())
    assert err <= 1e-6, err
    ran = {key: kernels.LAUNCHES[key] - before[key] for key in before}
    assert ran["hdh_multi_uniform"] == 2
    assert ran["hdh_multi"] == len(groups) - 1
    assert ran["hdh_multi_uniform_probs"] == 1
    assert ran["hdh_multi_probs"] == 0


def test_write_only_pass_rejects_misaligned_planes(dev):
    """The write-only kernel stores float4: output planes that do not start
    on a 16-byte boundary are refused before the launch, and aligned ones
    still run."""
    nq, shape = 12, (1 << 12) // 128
    buf = torch.empty(2 * (1 << nq) + 4, dtype=torch.float32, device=dev)
    args = (nq, (0, 1), 4, ((((0, 1),),),), ((0.3,),), (0.1,))
    before = kernels.LAUNCHES["hdh_multi_uniform"]
    for off in (1, 2, 3):
        re = buf[off:off + (1 << nq)].view(shape, 128)
        im = buf[off + (1 << nq):off + (2 << nq)].view(shape, 128)
        with pytest.raises(ValueError, match="16-byte"):
            kernels.apply_hdh_sandwich_multi_uniform(*args, out=(re, im))
    assert kernels.LAUNCHES["hdh_multi_uniform"] == before
    re = buf[4:4 + (1 << nq)].view(shape, 128)
    im = buf[4 + (1 << nq):4 + (2 << nq)].view(shape, 128)
    got = kernels.apply_hdh_sandwich_multi_uniform(*args, out=(re, im))
    want = kernels.apply_hdh_sandwich_multi_uniform_reference(*args,
                                                              device=dev)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_simulate_probs_routes(dev):
    """chain15's stream (width 30) runs as one write-only pass in its
    probability form over the 14 fresh ancillas of its two groups:
    hdh_multi_uniform_probs once, no other sandwich launch; its
    post-selected probabilities within 1e-4 of the analytic law. A lowered
    stream has no probability form."""
    from qcmrf_tpu_torch.circuits.lower import lower

    if torch.cuda.mem_get_info(dev)[0] < 12 * 2**30:
        pytest.skip("needs 12 GiB of free device memory for 2^30 values")
    n = 15
    m = chain_mrf(n, device=dev).with_theta(
        -np.abs(np.random.RandomState(7).randn(4 * (n - 1))).astype(
            np.float32) * 0.25)
    circ = compile_qcmrf(m, with_measurements=False)
    before = dict(kernels.LAUNCHES)
    probs = planes.simulate_probs(circ, device=dev)
    torch.cuda.synchronize()
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert ran["hdh_multi_uniform_probs"] == 1
    assert ran["hdh_multi_uniform"] == 0
    assert ran["hdh_multi_probs"] == 0 and ran["hdh_multi"] == 0
    p, delta = analytic.postselected_probs(m)
    want = p * delta
    post_rel = float((probs[: 1 << n] - want).abs().max() / want.max())
    assert probs.numel() == 1 << 30 and post_rel <= 1e-4, post_rel
    del probs
    torch.cuda.empty_cache()
    low = lower(compile_qcmrf(MRF.create(
        [[0, 1], [2, 3]], theta=-np.abs(np.random.RandomState(1).randn(8))
        * 0.5, device=dev), with_measurements=False))
    before = dict(kernels.LAUNCHES)
    got = planes.simulate_probs(low, device=dev)
    assert kernels.LAUNCHES["hdh_multi_probs"] == before["hdh_multi_probs"]
    want = dense.simulate_probs(low, dtype=torch.complex128, device=dev)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)


def test_simulate_probs_keeps_the_read_write_form(dev):
    """Width 24: a second group whose profile conditions on the first
    group's ancilla is not absorbed, so the stream ends in the read-write
    probability form (hdh_multi_kernel<k, true>) after the write-only
    amplitude pass; max|diff| / max|ref| <= 1e-6 against the dense
    engine in complex128."""
    from qcmrf_tpu_torch.circuits.ir import Circuit

    c = Circuit(24)
    for q in range(16):
        c.h(q)
    c.h(16).cp(0.7, 0, 16).rz(0.3, 16).cp(-0.4, 5, 16).h(16)
    c.h(17).cp(-0.9, 1, 17).cp(0.5, 16, 17).h(17)
    assert [op[0] for op in planes.fold_fresh(planes.fuse_ops(c))] == [
        "sandwichku", "sandwich"]
    before = dict(kernels.LAUNCHES)
    got = planes.simulate_probs(c, device=dev)
    torch.cuda.synchronize()
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert ran["hdh_multi_uniform"] == 1 and ran["hdh_multi_probs"] == 1
    assert ran["hdh_multi_uniform_probs"] == 0 and ran["hdh_multi"] == 0
    want = dense.simulate_probs(c, dtype=torch.complex128, device=dev)
    err = float((got.double() - want).abs().max() / want.max())
    assert err <= 1e-6, err


def test_plane_engine_matches_dense_on_card(dev):
    for nn in (6, 8):  # widths 12 and 16
        rng = np.random.RandomState(nn)
        m = MRF.create([[i, i + 1] for i in range(nn - 1)],
                       theta=-np.abs(rng.randn(4 * (nn - 1))) * 0.3)
        circ = compile_qcmrf(m, with_measurements=False)
        re, im = planes.run_statevector(circ, device=dev)
        want = dense.run_statevector(circ, device=dev)
        torch.testing.assert_close(torch.complex(re, im).reshape(-1), want,
                                   rtol=0, atol=1e-5)


def test_statevector_engine_on_card(dev):
    suite = generate_suite(0.1)
    before = circuit_kernel.LAUNCHES["circuit"]
    counts = run_experiment.run_suite(suite, shots=500,
                                      engine="statevector", device=dev)
    assert circuit_kernel.LAUNCHES["circuit"] == before + 1
    assert len(counts) == 70 and all(sum(c.values()) == 500 for c in counts)


def complete_model(n, dev, seed=11, scale=0.02):
    """K_n pairwise, theta = -|randn(RandomState(seed))| * scale."""
    cl = [[i, j] for i in range(n) for j in range(i + 1, n)]
    theta = -np.abs(np.random.RandomState(seed).randn(4 * len(cl))) * scale
    return MRF.create(cl, theta=theta, device=dev)


def mixed_model(n, dev, seed=5, scale=0.3):
    """A ring of 3-, 4- and 5-variable cliques over n variables."""
    cl, v, i = [], 0, 0
    while v < n - 1:
        c = (3, 4, 5)[i % 3]
        cl.append([u % n for u in range(v, v + c)])
        v, i = v + c - 1, i + 1
    d = sum(1 << len(C) for C in cl)
    theta = -np.abs(np.random.RandomState(seed).randn(d)) * scale
    return MRF.create(cl, theta=theta, device=dev)


def tie_model(n, dev):
    """Chain whose cliques reward unequal neighbours; in float32 the two
    alternating states tie exactly at 0, the earliest being 0101..."""
    return chain_mrf(n, theta=np.tile([-0.5, 0.0, 0.0, -0.5], n - 1),
                     device=dev)


@pytest.mark.parametrize("n", [16, 20])
def test_map_kernel_matches_plain_version(dev, n):
    """The split screens, the chain decides: ids and values equal the
    plain version's exactly, on every model, three rows in one launch,
    theta = 0 (every state a candidate) and the tie; two launches are
    bit-equal."""
    for m in (complete_model(n, dev), mixed_model(n, dev), tie_model(n, dev),
              wide_model(n, dev), complete_model(n, dev).with_theta(
                  np.zeros(2 * n * (n - 1), np.float32))):
        coef = kernels.moebius_coefficients(m)[None]
        coef = torch.cat([coef, 0.5 * coef, -coef])
        parts = kernels.lse_geometry(1 << n)[0]
        cand = torch.zeros((3, parts), dtype=torch.int64, device=dev)
        before = kernels.LAUNCHES["map"]
        v, x = kernels.map_partials(m.cliques, n, coef, m.beta, cand)
        assert kernels.LAUNCHES["map"] == before + 1
        wv, wx = kernels.map_partials_reference(m.cliques, n, coef, m.beta)
        assert torch.equal(x, wx) and torch.equal(v, wv)
        assert bool((cand >= 1).all()) and int(cand.sum()) <= 3 << n
        v2, x2 = kernels.map_partials(m.cliques, n, coef, m.beta)
        assert torch.equal(v, v2) and torch.equal(x, x2)
        if not bool(m.theta.any()):
            assert int(cand.sum()) == 3 << n
    m = tie_model(n, dev)
    best, sid = kernels.combine_map(*kernels.map_partials(
        m.cliques, n, kernels.moebius_coefficients(m)[None], m.beta))
    alternating = int("01" * (n // 2), 2)
    assert int(sid[0]) == alternating and float(best[0]) == 0.0


@pytest.mark.parametrize("n", [16, 20])
def test_moments_kernel_matches_plain_version(dev, n):

    for m in (complete_model(n, dev), mixed_model(n, dev)):
        coef = kernels.moebius_coefficients(m)[None]
        lnz = kernels.log_partition(m).reshape(1)
        masks = torch.from_numpy(
            moebius.monomial_masks(m.cliques, n)).to(dev)
        before = kernels.LAUNCHES["moments"]
        got = kernels.monomial_moments(m.cliques, n, coef, m.beta, lnz, masks)
        assert kernels.LAUNCHES["moments"] == before + 1
        want = kernels.monomial_moments_reference(m.cliques, n, coef, m.beta,
                                                  lnz, masks)
        # float32 per-block sums of p(x) against float64 sums: 1e-6
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert abs(float(got[0, 0]) - 1.0) < 1e-5  # the empty monomial
        # one launch: the split plain version's order throughout
        assert torch.equal(got, kernels.monomial_moments_split_reference(
            m.cliques, n, coef, m.beta, lnz, masks))


def table_model(n, dev):
    """A ring of 3-, 4- and 5-variable cliques over n variables (one
    clique of all n below 5)."""
    if n < 5:
        theta = -np.abs(np.random.RandomState(n).randn(1 << n)) * 0.4
        return MRF.create([list(range(n))], theta=theta, device=dev)
    return mixed_model(n, dev)


@pytest.mark.parametrize("n", [1, 5, 10, 12, 16, 20])
def test_table_kernel_is_the_split_bit_for_bit(dev, n):
    """Three coefficient rows in one launch: one sub-block below n = 10
    (n = L, threads past 2^L idle at n < 8), sub-blocks of 2^10 at n = 12
    and 16, several a block at n = 20."""
    m = table_model(n, dev)
    coef = kernels.coefficient_table(
        m.cliques, n, torch.stack([m.theta, 0.5 * m.theta, -m.theta]))
    check_table(m.cliques, n, coef, m.beta)


def map_cases(n, dev):
    """(model, what) of the MAP route checks: the tie (two states of one
    chain value), a random complete graph and theta = 0 (every state of
    value 0, so the earliest id, 0, wins)."""
    if n == 1:
        return [(MRF.create([[0]], theta=[0.3, 0.3], device=dev), "tie"),
                (MRF.create([[0]], theta=[-0.2, 0.1], device=dev), "one"),
                (MRF.create([[0]], theta=[0.0, 0.0], device=dev), "zero")]
    k = complete_model(n, dev, scale=0.3)
    return [(tie_model(n, dev), "tie"), (k, "complete"),
            (k.with_theta(np.zeros(k.dimension, np.float32)), "zero")]


@pytest.mark.parametrize("n", [1, 4, 8, 9, 16])
def test_map_routes_return_the_chains_earliest_maximum(dev, n):
    """``map_state`` and ``map_state_streaming`` on the card (the map
    kernel at every n, since the card's table is the split's) give the
    chain's maximum and its earliest id, ties and theta = 0 included."""
    from qcmrf_tpu_torch.models import sample

    for m, what in map_cases(n, dev):
        coef = kernels.moebius_coefficients(m)[None]
        chain = kernels.logpot_table_reference(m.cliques, n, coef, 1.0)[0]
        want = int(torch.argmax(chain))
        before = dict(kernels.LAUNCHES)
        assert int(sample.map_state(m)) == want, what
        lp = m.beta * chain
        sid, val = kernels.map_state_streaming(m)
        assert sid == int(torch.argmax(lp)) and val == float(lp[sid]), what
        assert kernels.LAUNCHES["map"] == before["map"] + 2
        assert kernels.LAUNCHES["logpot"] == before["logpot"]
        if what == "zero":
            assert want == 0 and sid == 0
        if what == "tie" and n > 1:
            assert sid == int("01" * (n // 2), 2) << (n % 2)


def wide_model(n, dev, draws=700, seed=4, scale=0.05):
    """Random 4-variable cliques over n variables: at n = 20, about 650
    cliques, whose tables pass the default 48 KB of shared memory, and
    about 1900 monomials."""
    rng = np.random.RandomState(seed)
    cl = sorted({tuple(sorted(rng.choice(n, 4, replace=False).tolist()))
                 for _ in range(draws)})
    theta = -np.abs(np.random.RandomState(seed + 1).randn(16 * len(cl)))
    return MRF.create([list(C) for C in cl], theta=theta * scale, n=n,
                      device=dev)


def test_wide_structure_kernels_match_plain_versions(dev, monkeypatch):
    """Every streaming kernel opts in to more than 48 KB of shared memory,
    and a monomial list longer than one launch takes is split over
    launches with the same result."""
    from qcmrf_tpu_torch.ops import _build

    n = 20
    m = wide_model(n, dev)
    cl, beta = m.cliques, m.beta
    assert _build.structure_bytes(len(cl), 4) > 48 * 1024
    coef = kernels.moebius_coefficients(m)[None]
    check_table(cl, n, coef, beta)
    lnz = kernels.combine_lse(*kernels.lse_partials(cl, n, coef, beta))
    torch.testing.assert_close(lnz, kernels.combine_lse(
        *kernels.lse_partials_reference(cl, n, coef, beta)), rtol=0,
        atol=1e-5)
    v, x = kernels.map_partials(cl, n, coef, beta)
    wv, wx = kernels.map_partials_reference(cl, n, coef, beta)
    assert torch.equal(x, wx) and torch.equal(v, wv)
    masks = torch.from_numpy(moebius.monomial_masks(cl, n)).to(dev)
    assert masks.numel() > 1500
    # |beta theta^T phi| reaches ~30 here, where the chain's float32
    # table sits about 7e-6 from the exact moments (its rounding, common
    # to many states, does not average out): the oracle is the chain in
    # float64 on the same float32 coefficients
    want = kernels.monomial_moments_reference(cl, n, coef.double(), beta,
                                              lnz, masks)
    before = kernels.LAUNCHES["moments"]
    got = kernels.monomial_moments(cl, n, coef, beta, lnz, masks)
    assert kernels.LAUNCHES["moments"] == before + 1
    assert torch.equal(got, kernels.monomial_moments_split_reference(
        cl, n, coef, beta, lnz, masks))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    monkeypatch.setattr(kernels, "moments_per_launch", lambda cliques, n: 500)
    split = kernels.monomial_moments(cl, n, coef, beta, lnz, masks)
    assert (kernels.LAUNCHES["moments"]
            == before + 1 + -(-masks.numel() // 500))
    torch.testing.assert_close(split, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(split, got, rtol=0, atol=1e-12)


def test_infer_k16_streaming_matches_elimination(dev, tmp_path, monkeypatch):
    """K16 through the lse, map and fused lnz_moments kernels (the
    streaming route, forced by the width cap) against variable
    elimination on the card."""
    import json

    from qcmrf_tpu_torch.models import capability
    from qcmrf_tpu_torch.runners import infer_cli

    graph = tmp_path / "k16.json"
    graph.write_text(json.dumps(
        [[i, j] for i in range(16) for j in range(i + 1, 16)]))
    queries = tmp_path / "q.jsonl"
    queries.write_text("\n".join(json.dumps(q) for q in (
        {"query": "lnz"}, {"query": "lnz", "evidence": "0=1,5=0"},
        {"query": "prob", "of": "3=1", "evidence": "0=1"},
        {"query": "map"}, {"query": "map", "evidence": "0=1,5=0"},
        {"query": "marginals"}, {"query": "marginals", "evidence": "0=1"},
        {"query": "mmap", "max_vars": "0,1,2"})))
    argv = ["--graph", str(graph), "--theta-scale", "0.3", "--theta-seed",
            "11", "--queries", str(queries), "--platform", "gpu"]
    want = infer_cli.main(argv)
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    before = dict(kernels.LAUNCHES)
    got = infer_cli.main(argv)
    for k in ("lse", "map", "lnz_moments"):
        assert kernels.LAUNCHES[k] > before[k], k
    # the marginals take the fused sweep, not lse + moments
    assert kernels.LAUNCHES["moments"] == before["moments"]
    for g, w in zip(got, want):
        assert g["backend"] == "streaming" and w["backend"] == "elimination"
        for k in ("lnz", "log_mass", "prob", "beta_logpot"):
            if k in w:
                assert abs(g[k] - w[k]) <= 1e-4, (w["query"], k)
        for k in ("state_id", "state_bits", "max_vars"):
            assert g.get(k) == w.get(k), (w["query"], k)
        if "marginals" in w:
            np.testing.assert_allclose(g["marginals"], w["marginals"],
                                       rtol=0, atol=1e-5)


def unit_planes(nq, seed, dev):
    re, im = rand_planes(nq, seed, dev)
    scale = float(torch.sqrt((re * re).sum() + (im * im).sum()))
    return re / scale, im / scale


def random_terms(rng, count, nq):
    return tuple(tuple((int(p), int(rng.randint(2))) for p in rng.choice(
        nq, rng.randint(0, 4), replace=False)) for _ in range(count))


def test_gate_kernels_match_plain_versions(dev):
    """diag (1, 12 and 64 terms, an empty term, conditions on bit 23), the
    masked rotation, rowq at q = 7, 15, 23, row2 at q_lo = 7, 22, the lane
    op (embedded H, the 7-H wall, a random M) and the copy, each against
    its plain version at width 24 on unit-norm planes, within 1e-5."""
    nq = 24
    rng = np.random.RandomState(24)
    H = dense.GATES_1Q["h"]
    wall = np.eye(128, dtype=np.complex64)
    for q in range(7):
        wall = kernels._lane_gate_matrix(np.asarray(H, np.complex64),
                                         q) @ wall
    U = (rng.randn(2, 2) + 1j * rng.randn(2, 2)).astype(np.complex64)
    U4 = (rng.randn(4, 4) + 1j * rng.randn(4, 4)).astype(np.complex64)
    M = ((rng.randn(128, 128) + 1j * rng.randn(128, 128)) / 16).astype(
        np.complex64)
    cases = []
    special = (((23, 1), (4, 0)), ())  # the top bit; no condition
    for count in (1, 12, 64):
        terms = special[:1] if count == 1 else (
            random_terms(rng, count - 2, nq) + special)
        angles = tuple(rng.uniform(-np.pi, np.pi, count))
        cases.append(("diag", kernels.apply_diagonal_profile,
                      kernels.apply_diagonal_profile_reference,
                      (terms, angles, 0.3)))
    cases.append(("diag", kernels.apply_masked_rotation,
                  kernels.apply_masked_rotation_reference,
                  (((23, 1), (7, 0)), -0.2, 1.3)))
    for q in (7, 15, 23):
        cases.append(("row_gate", kernels.apply_1q,
                      kernels.apply_1q_reference, (U, q, nq)))
    for q_lo in (7, 22):
        cases.append(("row_gate", kernels.apply_2q_row_pair,
                      kernels.apply_2q_row_pair_reference, (U4, q_lo)))
    for lane_op in (kernels._lane_gate_matrix(np.asarray(H, np.complex64),
                                              3), wall, M):
        cases.append(("lane", kernels.apply_lane,
                      kernels.apply_lane_reference, (lane_op,)))
    for name, fn, plain, args in cases:
        before = kernels.LAUNCHES[name]
        got = fn(*unit_planes(nq, 2, dev), *args)
        assert kernels.LAUNCHES[name] == before + 1, name
        want = plain(*unit_planes(nq, 2, dev), *args)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # width 8: two rows, a partial tile of the lane kernel
    for fn, plain, args in ((kernels.apply_lane, kernels.apply_lane_reference,
                             (M,)),
                            (kernels.apply_1q, kernels.apply_1q_reference,
                             (U, 7, 8)),
                            (kernels.apply_diagonal_profile,
                             kernels.apply_diagonal_profile_reference,
                             ((((7, 1),), ((0, 0), (5, 1))), (0.4, -1.1)))):
        torch.testing.assert_close(fn(*unit_planes(8, 5, dev), *args),
                                   plain(*unit_planes(8, 5, dev), *args),
                                   rtol=0, atol=1e-5)
    src = unit_planes(nq, 3, dev)
    out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
    before = kernels.LAUNCHES["copy"]
    assert kernels.copy_planes(*src, out=out) is out
    assert kernels.LAUNCHES["copy"] == before + 1
    assert torch.equal(out[0], src[0]) and torch.equal(out[1], src[1])


def random_factors(rng, count):
    factors = kernels.identity_factors()
    for q in rng.choice(7, count, replace=False):
        a = rng.randn(2, 2) + 1j * rng.randn(2, 2)
        factors[q] = np.linalg.qr(a)[0].astype(np.complex64)
    return factors


@pytest.mark.parametrize("nq", [8, 24, 28])
def test_lane_factored_kernel_matches_plain_version(dev, nq):
    """The factored lane kernel (one launch a pass) against its plain
    version within 1e-5 on unit-norm planes: random unitary factors on 1, 3
    and 7 lane qubits, and the lowered qcmrf28 chain's first, last and
    densest lane passes."""
    from qcmrf_tpu_torch.circuits.compiler import QCMRF

    rng = np.random.RandomState(nq)
    theta = -np.abs(np.random.RandomState(0).randn(52)) * 0.3
    ops = planes.fuse_ops(QCMRF.build(
        [[i, i + 1] for i in range(13)], theta=theta,
        with_measurements=False).lowered(style="fused"))
    lanes = [op for op in ops if op[0] == "lane"]
    densest = max(lanes, key=lambda op: np.count_nonzero(op[1]))
    cases = [random_factors(rng, c) for c in (1, 3, 7)]
    cases += [op[2] for op in (lanes[0], lanes[-1], densest)]
    for factors in cases:
        before = kernels.LAUNCHES["lane_factored"]
        got = kernels.apply_lane_factored(*unit_planes(nq, 2, dev), factors)
        assert kernels.LAUNCHES["lane_factored"] == before + 1
        want = kernels.apply_lane_factored_reference(*unit_planes(nq, 2, dev),
                                                     factors)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        del got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("nq", [7, 24, 28])
def test_copy_kernel_is_exact(dev, nq):
    src = unit_planes(nq, 3, dev)
    out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
    before = kernels.LAUNCHES["copy"]
    assert kernels.copy_planes(*src, out=out) is out
    assert kernels.LAUNCHES["copy"] == before + 1
    assert torch.equal(out[0], src[0]) and torch.equal(out[1], src[1])


def test_lowered_chain_matches_unlowered_on_card(dev):
    """bench.py's chain at width 20, lowered (fused style): every pass
    kind, one launch per op of its kind (every lane op the factored
    kernel, none the dense one), the full state (global phase included)
    within 1e-4 in 2-norm of the unlowered chain's."""
    from qcmrf_tpu_torch.circuits.compiler import QCMRF

    theta = -np.abs(np.random.RandomState(0).randn(36)) * 0.3
    q = QCMRF.build([[i, i + 1] for i in range(9)], theta=theta,
                    with_measurements=False)
    low = q.lowered()
    kinds = {}
    for op in planes.fuse_ops(low):
        kinds[op[0]] = kinds.get(op[0], 0) + 1
    before = dict(kernels.LAUNCHES)
    re, im = planes.run_statevector(low, device=dev)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["lane_factored"] - before["lane_factored"]
            == kinds["lane"])
    assert kernels.LAUNCHES["lane"] == before["lane"]
    assert kernels.LAUNCHES["diag"] - before["diag"] == kinds["diag"]
    assert (kernels.LAUNCHES["row_gate"] - before["row_gate"]
            == kinds["rowq"] + kinds.get("row2", 0))
    assert (kernels.LAUNCHES["hdh_multi"] - before["hdh_multi"]
            == kinds["sandwich"])
    want = torch.complex(*planes.run_statevector(q.circuit, device=dev))
    diff = torch.complex(re, im) - want
    assert float(torch.linalg.vector_norm(diff.reshape(-1))) <= 1e-4


@pytest.mark.parametrize("n", [16, 20])
def test_lnz_moments_kernel_matches_plain_version(dev, n):
    """The fused kernel (one launch) against its plain version and against
    the lse + moments kernels: lnZ within 1e-5, moments within 1e-6. The
    moments kernel evaluates states by the split, as the lse kernel does,
    so it is normalised by the lse kernel's lnZ: by the chain's (another
    rounding of the table) its probabilities sum to 1 only within about
    1e-6."""

    for m in (complete_model(n, dev), mixed_model(n, dev)):
        coef = kernels.moebius_coefficients(m)[None]
        masks = moebius.device_masks(m.cliques, n, dev)
        before = kernels.LAUNCHES["lnz_moments"]
        M, S = kernels.lnz_moments_partials(m.cliques, n, coef, m.beta, masks)
        assert kernels.LAUNCHES["lnz_moments"] == before + 1
        assert M.is_cuda and S.shape == (1, M.shape[1], masks.numel())
        lnz, mono = kernels.combine_lnz_moments(M, S)
        want_lnz, want = kernels.combine_lnz_moments(
            *kernels.lnz_moments_partials_reference(m.cliques, n, coef,
                                                    m.beta, masks))
        torch.testing.assert_close(lnz, want_lnz, rtol=0, atol=1e-5)
        torch.testing.assert_close(mono, want, rtol=0, atol=1e-6)
        lnz2 = kernels.log_partition(m).reshape(1)
        torch.testing.assert_close(lnz, lnz2.double(), rtol=0, atol=1e-5)
        torch.testing.assert_close(mono, kernels.monomial_moments(
            m.cliques, n, coef, m.beta, lnz2, masks), rtol=0, atol=1e-6)


def split_cases(dev):
    """(what, model) of the split kernels' checks: a sub-block of all 2^n
    states below 10 variables (n < L = 12), one of 2^10 and 2^11."""
    return [(f"chain n={n}", MRF.create(
        [[i, i + 1] for i in range(n - 1)] + [[0, n - 1]], device=dev,
        theta=-np.abs(np.random.RandomState(n).randn(4 * n)) * 0.4))
        for n in (3, 5, 8, 9)] + [
        ("mixed n=11", mixed_model(11, dev)),
        ("mixed n=23", mixed_model(23, dev, scale=0.1))]


def test_split_kernels_at_small_n_and_three_rows(dev):
    """lse and lnz_moments on three coefficient rows in one launch, n from
    3 (8 states, threads past them idle) to 23 (sub-blocks of 2^11): lnZ
    within 1e-5 and moments within 1e-6 of the plain versions."""
    for what, m in split_cases(dev):
        thetas = torch.stack([m.theta, 0.5 * m.theta, 1.5 * m.theta])
        coef = kernels.coefficient_table(m.cliques, m.n, thetas)
        before = dict(kernels.LAUNCHES)
        got = kernels.combine_lse(*kernels.lse_partials(m.cliques, m.n, coef,
                                                        m.beta))
        want = kernels.combine_lse(*kernels.lse_partials_reference(
            m.cliques, m.n, coef, m.beta))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        masks = moebius.device_masks(m.cliques, m.n, dev)
        lnz, mono = kernels.combine_lnz_moments(*kernels.lnz_moments_partials(
            m.cliques, m.n, coef, m.beta, masks))
        want_lnz, want_mono = kernels.combine_lnz_moments(
            *kernels.lnz_moments_partials_reference(m.cliques, m.n, coef,
                                                    m.beta, masks))
        assert kernels.LAUNCHES["lse"] == before["lse"] + 1, what
        assert kernels.LAUNCHES["lnz_moments"] == before["lnz_moments"] + 1
        assert lnz.shape == (3,) and mono.shape == (3, masks.numel())
        torch.testing.assert_close(lnz, want_lnz, rtol=0, atol=1e-5)
        torch.testing.assert_close(mono, want_mono, rtol=0, atol=1e-6)


def test_split_kernels_are_deterministic(dev):
    """No float atomics: two launches on the same inputs are bit-equal."""
    for m in (complete_model(20, dev), mixed_model(16, dev)):
        coef = kernels.moebius_coefficients(m)[None]
        masks = moebius.device_masks(m.cliques, m.n, dev)
        for run in (lambda: kernels.lse_partials(m.cliques, m.n, coef,
                                                 m.beta),
                    lambda: kernels.lnz_moments_partials(
                        m.cliques, m.n, coef, m.beta, masks)):
            a, b = run(), run()
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_lse_past_2_31_matches_elimination(dev):
    """A 32-variable chain (state ids past 2^31): the lse kernel's lnZ
    within 1e-4 of variable elimination."""
    from qcmrf_tpu_torch.models import elimination

    m = MRF.create([[i, i + 1] for i in range(31)], device=dev,
                   theta=-np.abs(np.random.RandomState(32).randn(124)) * 0.3)
    coef = kernels.moebius_coefficients(m)[None]
    lnz = float(kernels.combine_lse(*kernels.lse_partials(
        m.cliques, m.n, coef, m.beta))[0])
    assert abs(lnz - float(elimination.log_partition(m))) <= 1e-4


def test_lnz_moments_split_over_launches(dev, monkeypatch):
    """A mask list longer than one launch takes: every launch with mask 0,
    the result that of one launch."""

    n = 20
    m = wide_model(n, dev)
    coef = kernels.moebius_coefficients(m)[None]
    masks = moebius.device_masks(m.cliques, n, dev)
    one = kernels.combine_lnz_moments(*kernels.lnz_moments_partials(
        m.cliques, n, coef, m.beta, masks))
    monkeypatch.setattr(kernels, "moments_per_launch",
                        lambda cliques, n: 500)
    before = kernels.LAUNCHES["lnz_moments"]
    split = kernels.combine_lnz_moments(*kernels.lnz_moments_partials(
        m.cliques, n, coef, m.beta, masks))
    assert (kernels.LAUNCHES["lnz_moments"] - before
            == 1 + -(-(masks.numel() - 500) // 499))
    torch.testing.assert_close(split[0], one[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(split[1], one[1], rtol=0, atol=1e-6)


def test_lnz_gradient_on_card_is_beta_mu(dev):
    """autograd.grad of lnZ on the card is beta * E_p[phi] of the two
    sweeps; the value-only call takes the lse sweep alone."""
    from qcmrf_tpu_torch.models import moments

    base = complete_model(16, dev, scale=0.2)
    m = MRF.create(base.cliques, theta=base.theta, beta=1.3, device=dev)
    theta = m.theta.clone().requires_grad_()
    before = dict(kernels.LAUNCHES)
    (g,) = torch.autograd.grad(moments.log_partition_streaming(
        m.with_theta(theta)), theta)
    assert kernels.LAUNCHES["lnz_moments"] == before["lnz_moments"] + 1
    assert kernels.LAUNCHES["lse"] == before["lse"]
    want = m.beta * moments.clique_moments_streaming(
        m, lnZ=kernels.log_partition(m))
    torch.testing.assert_close(g, want, rtol=0, atol=1e-5)
    before = dict(kernels.LAUNCHES)
    moments.log_partition_streaming(m)
    assert kernels.LAUNCHES["lnz_moments"] == before["lnz_moments"]
    assert kernels.LAUNCHES["lse"] == before["lse"] + 1


def test_nll_backward_on_card(dev):
    """MRF.nll(x).backward() on the card gives beta (E_p[phi] -
    E_data[phi]), and the kernels refuse a tensor whose gradient they
    would lose."""
    from qcmrf_tpu_torch.evaluation.estimators import (
        clique_marginals_from_samples)
    from qcmrf_tpu_torch.models import moments

    m = mixed_model(16, dev)
    x = torch.randint(0, 1 << 16, (3000,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    theta = m.theta.clone().requires_grad_()
    m.with_theta(theta).nll(x).backward()
    want = m.beta * (moments.clique_moments_streaming(
        m, lnZ=kernels.log_partition(m))
        - clique_marginals_from_samples(m, x).float())
    torch.testing.assert_close(theta.grad, want, rtol=0, atol=1e-5)
    coef = kernels.moebius_coefficients(m.with_theta(theta))[None]
    with pytest.raises(ValueError, match="no backward"):
        kernels.lse_partials(m.cliques, m.n, coef, m.beta)


def test_train_cli_on_card(dev, tmp_path):
    """A small fit through train_cli on the card: one fused launch a step,
    the fit within 1e-4 of the same run on the CPU."""
    import json

    from qcmrf_tpu_torch.runners import train_cli

    ids = tmp_path / "ids.json"
    ids.write_text(json.dumps(
        np.random.RandomState(3).randint(0, 1 << 8, 2047).tolist()))
    argv = ["--graph", "chain:8", "--data", str(ids), "--steps", "12",
            "--lr", "0.1"]
    before = kernels.LAUNCHES["lnz_moments"]
    card = json.loads(open(train_cli.main(
        argv + ["--outdir", str(tmp_path / "gpu")])).read())
    assert kernels.LAUNCHES["lnz_moments"] == before + 12
    cpu = json.loads(open(train_cli.main(
        argv + ["--platform", "cpu", "--outdir", str(tmp_path / "cpu")])
    ).read())
    np.testing.assert_allclose(card["theta"], cpu["theta"], rtol=0,
                               atol=1e-4)
    assert abs(card["final_nll"] - cpu["final_nll"]) <= 1e-5


def test_fma_peak_kernel_matches_plain_version(dev):
    from qcmrf_tpu_torch.runners import bench

    """Short chains of the chaotic x -> x * x - 1.5, value by value within
    1e-3 of float64 (a step more or fewer moves them by O(1)); the full
    chain's parity from 0 at b = -1; the rate run's ones."""
    x = torch.ones(1 << 20, device=dev)
    before = kernels.LAUNCHES["fma_peak"]
    got = kernels.fma_chain_max(x)
    assert kernels.LAUNCHES["fma_peak"] == before + 1
    assert float(got) == float(kernels.fma_chain_max_reference(x)) == 1.0
    g = torch.Generator(device=dev).manual_seed(18)
    y = torch.rand(1 << 16, generator=g, device=dev) * 2 - 1
    out = torch.empty_like(y)
    for steps in (1, 15, 16):
        want = y.double()
        for _ in range(steps):
            want = want * want - 1.5
        top = kernels.fma_chain_max(y, -1.5, steps=steps, out=out)
        torch.testing.assert_close(out.double(), want, rtol=0, atol=1e-3)
        assert float(top) == float(out.max())
        assert float((want * want - 1.5 - want).abs().max()) > 1.0
    z = torch.zeros(1 << 12, device=dev)
    for steps, value in ((kernels.FMA_CHAIN, 0.0),
                         (kernels.FMA_CHAIN - 1, -1.0)):
        out = torch.empty_like(z)
        kernels.fma_chain_max(z, -1.0, steps=steps, out=out)
        assert bool((out == value).all())
    assert bench.fma_peak_tflops(dev, reps=2) > 1.0


# ---- slice 3b: the samplers ------------------------------------------------------


def pam_n24(dev):
    """bench.py's PAM model: the 24-chain with 6 triangles, theta =
    -|randn(RandomState(7))| * 0.5."""
    cl = ([[i, i + 1] for i in range(23)]
          + [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(6)])
    d = sum(1 << len(C) for C in cl)
    theta = -np.abs(np.random.RandomState(7).randn(d)).astype(np.float32) * 0.5
    return MRF.create(cl, theta=theta, device=dev)


def perturbed_rows(m, rows, seed):
    """``rows`` Gumbel-perturbed coefficient rows of ``m``, as PAM draws
    them."""
    from qcmrf_tpu_torch.models import sample

    g = torch.Generator(device=m.device).manual_seed(seed)
    th = sample._gumbel(g, (rows, m.dimension), m.device) + m.beta * m.theta
    return kernels.coefficient_table(m.cliques, m.n, th)


@pytest.mark.parametrize("which", ["pam_n24", "K27"])
def test_map_kernel_rows_equal_single_row_launches(dev, which):
    """16 independent perturbed models in one launch == 16 launches of one
    row each (torch.equal)."""
    if which == "K27":
        m = complete_model(27, dev)
    else:
        m = pam_n24(dev)
    coef = perturbed_rows(m, 16, 1)
    before = kernels.LAUNCHES["map"]
    v, x = kernels.map_partials(m.cliques, m.n, coef, 1.0)
    assert kernels.LAUNCHES["map"] == before + 1
    for r in range(16):
        v1, x1 = kernels.map_partials(m.cliques, m.n, coef[r:r + 1], 1.0)
        assert torch.equal(v1[0], v[r]) and torch.equal(x1[0], x[r]), r


def test_map_kernel_splits_rows_past_the_grid_limit(dev):
    """70 000 rows (grid.y takes 65 535): two launches, every row equal to
    the plain version's."""
    m = chain_mrf(8, theta=-np.abs(np.random.RandomState(2).randn(28)),
                  device=dev)
    coef = perturbed_rows(m, 70_000, 2)
    before = kernels.LAUNCHES["map"]
    v, x = kernels.map_partials(m.cliques, m.n, coef, 1.0)
    assert kernels.LAUNCHES["map"] == before + 2
    wv, wx = kernels.map_partials_reference(m.cliques, m.n, coef, 1.0)
    assert torch.equal(v, wv) and torch.equal(x, wx)


def wide_chain(n, extra=()):
    """An n-chain with triangles every 5 variables and ``extra`` cliques."""
    return ([[i, i + 1] for i in range(n - 1)]
            + [[i, i + 1, i + 2] for i in range(0, n - 2, 5)] + list(extra))


@pytest.mark.parametrize("case", ["suite", "evidence", "clamped", "K12",
                                  "K27", "K40",
                                  "word_general", "small_general", "wide",
                                  "device_delta", "wide_device_delta"])
def test_gibbs_kernel_matches_plain_version(dev, case):
    """At the main path's own thin and burn (eval --mode gibbs: thin 10,
    burn 10 on a suite graph's 10 chains; train's chain: thin 10, burn 100,
    on K12 and K27) the sampled rows equal the plain version's, and are
    the chains' states after sweeps burn + i * thin; where two runs part,
    the first differing decision lies within 2 ulp of its p1. The same
    on the general loop: sites of 39 items (K40), a 64-variable word with
    a 6-variable clique, 7 free sites and a 6-variable clique (a ring
    group of 4 sweeps), every site clamped, past 64 variables (the state
    in shared memory, clamped sites) and with a 16-variable clique (its
    differences in device memory)."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    ev = None
    chains, num, thin, burn = 10, 15, 10, 100
    if case in ("K12", "K27", "K40"):
        m = complete_model(int(case[1:]), dev)
        chains = 4 if case != "K12" else chains
        num = 5
    elif case in ("word_general", "small_general", "wide", "device_delta",
                  "wide_device_delta"):
        n = {"word_general": 64, "small_general": 8,
             "device_delta": 20}.get(case, 70)
        big = {"wide": [], "word_general": [[5, 9, 20, 33, 47, 63]],
               "small_general": [[0, 2, 3, 4, 6, 7]],
               "device_delta": [list(range(2, 18))]}.get(
                   case, [list(range(2, 34, 2))])
        cl = wide_chain(n, big)
        m = MRF.create(cl, theta=-np.abs(np.random.RandomState(6).randn(
            sum(1 << len(c) for c in cl))) * 0.4, device=dev)
        chains, num, burn = 3, 6, 10
        ev = torch.full((n,), -1, dtype=torch.int8)
        ev[1], ev[n - 3] = 1, 0
    else:
        suite = generate_suite(0.1)
        m = MRF.create(suite.graphs[5], theta=suite.thetas[5][0], device=dev)
        burn = 10
        if case == "evidence":
            ev = torch.tensor([-1, 1, -1, -1, 0], dtype=torch.int8)
        elif case == "clamped":
            ev = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int8)
    rng = np.random.RandomState(4)
    thetas = (m.theta[None] - torch.from_numpy(np.abs(rng.randn(
        chains, m.dimension)).astype(np.float32)).to(dev) * 0.3).contiguous()
    args = (11, m.cliques, m.n, thetas, m.beta, num, thin, burn)
    ids = range(3, 3 + chains)
    before = gibbs_kernel.LAUNCHES["gibbs"]
    got = gibbs_kernel.gibbs_chains(*args, evidence_mask=ev, chain_ids=ids)
    assert gibbs_kernel.LAUNCHES["gibbs"] == before + 1
    want = gibbs_kernel.gibbs_chains_reference(*args, evidence_mask=ev,
                                               chain_ids=ids)
    assert got.is_cuda and got.shape == want.shape == (chains, num, m.n)
    for c, s, v, u, p1 in gibbs_kernel.partings(
            *args, got, want, evidence_mask=ev, chain_ids=ids):
        assert gibbs_kernel.within_ulps(u, p1), (c, s, v, u, p1)
    if ev is not None:
        clamped = torch.nonzero(ev >= 0)[:, 0].tolist()
        for v in clamped:
            assert bool((got[..., v] == ev[v]).all()), v
    pack = gibbs_kernel.chain_pack(((m.cliques, m.n, None if ev is None else
                                     tuple(ev.tolist())),))
    from qcmrf_tpu_torch.ops import _build
    in_shared = pack.shared_bytes(True) <= _build.SHARED_BYTES_LIMIT
    assert pack.reg_state == (m.n <= 64)
    assert in_shared == ("delta" not in case)
    fast = case in ("suite", "evidence", "K12", "K27")
    assert bool(pack.structs[0, 8]) == fast


def test_gibbs_multi_launch_equals_per_graph_launches(dev):
    """The suite's 70 chains in one launch (eval --mode gibbs's call) equal
    the seven per-graph launches with the same chain ids (torch.equal),
    and eval --mode gibbs makes exactly that one chain launch."""
    from qcmrf_tpu_torch.evaluation import harness
    from qcmrf_tpu_torch.ops import gibbs_kernel

    suite = generate_suite(0.1)
    models, idx, alone = [], 0, []
    for j, C in enumerate(suite.graphs):
        cl = tuple(tuple(c) for c in C)
        n = max(v for c in C for v in c) + 1
        th = torch.tensor(np.asarray(suite.thetas[j], np.float32),
                          device=dev)
        models.append((cl, n, th))
        alone.append(gibbs_kernel.gibbs_chains(
            5, cl, n, th, 1.0, 20, 10, 10,
            chain_ids=range(idx, idx + th.shape[0])))
        idx += th.shape[0]
    before = gibbs_kernel.LAUNCHES["gibbs"]
    rows = gibbs_kernel.gibbs_chains_multi(5, models, 1.0, 20, 10, 10)
    assert gibbs_kernel.LAUNCHES["gibbs"] == before + 1
    for a, b in zip(alone, rows):
        assert torch.equal(a, b)
    before = gibbs_kernel.LAUNCHES["gibbs"]
    res = harness.evaluate_suite(suite, mode="gibbs", num_samples=200,
                                 device=dev)
    assert gibbs_kernel.LAUNCHES["gibbs"] == before + 1 and len(res) == 7


def test_gibbs_thresholds_match_plain_version(dev):
    """The kernel's threshold T(k * 2^-24) of every k < 2^24 equals the
    plain version's computed on the card; the CPU's float64 logarithm may
    part from the card's in the last bit, so there a threshold is equal or
    one float32 step away."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    got = gibbs_kernel.device_thresholds(dev)
    k = torch.arange(1 << 24, dtype=torch.int64)
    assert torch.equal(got, gibbs_kernel.thresholds_of(k.to(dev)))
    cpu, got = gibbs_kernel.thresholds_of(k), got.cpu()
    lo, hi = torch.minimum(cpu, got), torch.maximum(cpu, got)
    assert torch.equal(torch.nextafter(lo, hi), hi)


def test_gibbs_latency_probe(dev):
    """The probe times every step, at a clock an H100 can run."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    lat = gibbs_kernel.latency_cycles(dev, steps=256)
    assert all(lat[k] > 0 for k in gibbs_kernel.LATENCY_STEPS), lat
    assert 0.5 < lat["sm_ghz"] < 2.5, lat


def test_samplers_on_card(dev):
    """The public samplers on the card: PAM's two forms equal from one
    generator seed, FFBS on the 40-chain within 0.02 of elimination's
    marginals, sample_conditional's evidence clamped by every method."""
    from qcmrf_tpu_torch.models import elimination, sample
    from qcmrf_tpu_torch.ops import gibbs_kernel

    m = pam_n24(dev)
    ids = sample.sample_pam(3, m, 16)
    bits = sample.sample_pam_streaming(3, m, 16)
    assert ids.is_cuda and torch.equal(
        bits, ((ids.long()[:, None] >> (23 - torch.arange(24, device=dev)))
               & 1).int())
    ce = chain_mrf(40, theta=-np.abs(np.random.RandomState(9).randn(156)),
                   device=dev)
    S = elimination.sample_exact_elim(0, ce, 65536).float()
    for v in (0, 17, 39):
        assert abs(float(S[:, v].mean())
                   - float(elimination.conditional_prob(ce, v, 1))) < 0.02
    before = gibbs_kernel.LAUNCHES["gibbs"]
    for method in ("exact", "gibbs", "pam"):
        b = sample.sample_conditional(1, m, 20, {0: 1, 5: 0}, method=method)
        assert b.is_cuda and b.shape == (20, 24)
        assert bool((b[:, 0] == 1).all() and (b[:, 5] == 0).all())
    assert gibbs_kernel.LAUNCHES["gibbs"] == before + 1


def test_build_fails_loudly(dev, tmp_path, monkeypatch):
    """A source nvcc refuses stops the build with its log: no library,
    no fallback."""
    from qcmrf_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not _build.library_path().exists()


def disjoint_blocks(dev):
    """The past-both-caps flagship: K27 and a disjoint 21-variable chain,
    n = 48, 371 cliques, theta = -|randn(RandomState(1))| * 0.3."""
    A = [[i, j] for i in range(27) for j in range(i + 1, 27)]
    B = [[i + 27, i + 28] for i in range(20)]
    theta = -np.abs(np.random.RandomState(1).randn(4 * (len(A) + len(B))))
    return MRF.create(A + B, theta=(theta * 0.3).astype(np.float32),
                      device=dev)


@pytest.mark.parametrize("case", ["blocks48", "suite", "small_general",
                                  "wide80", "device_delta"])
def test_ais_mode_matches_plain_version(dev, case):
    """The chain kernel's AIS mode in one launch against its plain version:
    the final states equal row for row (where a chain parts, the plain
    run has a decision within 2 ulp of p1) and the log-weights within 1e-5
    relative, on the word path's fast loop (the n = 48 blocks; a suite
    graph, whose ring groups of 6 sweeps hold rung boundaries), its general
    loop (a 6-variable clique), the state in shared memory (an 80-variable
    chain with triangles) and D in device memory (a 16-variable clique)."""
    from qcmrf_tpu_torch.ops import _build, gibbs_kernel as gk

    M, T, spt, beta = 16, 8, 1, 1.0
    if case == "blocks48":
        m = disjoint_blocks(dev)
    elif case == "suite":
        suite = generate_suite(0.1)
        m = MRF.create(suite.graphs[5], theta=suite.thetas[5][0], device=dev)
        T, spt, beta = 7, 2, 0.9
    else:
        n = {"small_general": 8, "wide80": 80, "device_delta": 20}[case]
        big = {"small_general": [[0, 2, 3, 4, 6, 7]],
               "device_delta": [list(range(2, 18))]}.get(case, [])
        cl = wide_chain(n, big)
        m = MRF.create(cl, theta=-np.abs(np.random.RandomState(6).randn(
            sum(1 << len(c) for c in cl))) * 0.4, device=dev)
        M, T, spt = 8, 5, 3
    args = (13, m.cliques, m.n, m.theta, beta, M, T, spt)
    ids = range(5, 5 + M)
    before = gk.LAUNCHES["gibbs_ais"]
    logw, bits = gk.ais_chains(*args, chain_ids=ids)
    assert gk.LAUNCHES["gibbs_ais"] == before + 1
    want_w, want_b = gk.ais_chains_reference(*args, chain_ids=ids)
    assert bits.is_cuda and bits.shape == want_b.shape == (M, m.n)
    parts = gk.ais_partings(13, m.cliques, m.n, m.theta, beta, T, spt,
                            bits, want_b, chain_ids=ids)
    for c, s, v, u, p1 in parts:
        assert gk.within_ulps(u, p1), (c, s, v, u, p1)
    same = (bits == want_b).all(dim=1)
    err = (logw - want_w).abs() / want_w.abs().clamp(min=1.0)
    assert float(err[same].max()) <= 1e-5
    pack = gk.chain_pack(((m.cliques, m.n, None),))
    assert pack.reg_state == (m.n <= 64)
    assert bool(pack.structs[0, 8]) == (case in ("blocks48", "suite"))
    in_shared = pack.shared_bytes(True) <= _build.SHARED_BYTES_LIMIT
    assert in_shared == (case != "device_delta")
    # the runtime's occupancy of the instantiation this launch ran
    assert gk.ais_resident_blocks(m.cliques, m.n, dev) >= 1


def test_ais_estimators_on_card(dev):
    """Every AIS estimate is one launch of the AIS mode, on the card, and
    agrees with the exact answer at the JAX tests' bars."""
    from qcmrf_tpu_torch.models import ais, elimination
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk

    m = model(dev, 3, 3, seed=1, scale=0.4)
    before = gk.LAUNCHES["gibbs_ais"]
    lnz, d = ais.ais_log_partition(0, m, 256, 128, return_diagnostics=True)
    assert gk.LAUNCHES["gibbs_ais"] == before + 1 and lnz.is_cuda
    exact = float(elimination.log_partition(m))
    assert abs(float(lnz) - exact) < max(4 * float(d["stderr"]), 0.02)
    mu, d = ais.ais_clique_marginals(3, m, 512, 96, return_diagnostics=True)
    err = (mu - elimination.clique_marginals(m)).abs()
    assert float(d["ess"]) > 64 and float(err.max()) < 0.08
    # the JAX test's event model: a 6-chain closed by (0, 3)
    cl = [[i, i + 1] for i in range(5)] + [[0, 3]]
    me = MRF.create(cl, theta=-np.abs(np.random.RandomState(8).randn(
        24)).astype(np.float32) * 0.4, device=dev)
    p, d = ais.ais_event_prob(0, me, 2, 1, 512, 64, return_diagnostics=True)
    assert float(d["ess"]) > 51.2
    assert abs(float(p) - float(elimination.conditional_prob(me, 2, 1,
                                                             {}))) < 0.05
    raw = mtrain._from_theta(torch.full((m.dimension,), -0.5, device=dev),
                             True).requires_grad_()
    step = mtrain.make_ais_train_step(m, mtrain.adam([raw], 0.1),
                                      elimination.clique_marginals(m), 64, 8)
    info = step(0, 1)
    assert not info["skipped"] and gk.LAUNCHES["gibbs_ais"] == before + 4


@pytest.mark.parametrize("g", range(7))
def test_density_engine_on_card_matches_cpu_tensors(dev, g):
    """The density engine on the card against the same code on CPU
    tensors (1e-5), a graph's 10 reps batched against single evolutions
    (1e-6) and its noiseless diagonal against the circuit kernel (1e-5)."""
    from qcmrf_tpu_torch.noise import physical

    suite = generate_suite(0.1)
    model_ = physical.load_physical("torino", 0.1)
    C, thetas = suite.graphs[g], suite.thetas[g]
    mults = physical.rep_multipliers(model_, g, len(thetas))
    lams = [model_.lam[g] * u for u in mults]
    mrfs = [MRF.create(C, theta=t, device=dev) for t in thetas]
    one = physical.gate_noisy_probs(mrfs[0], lams[0])
    host = physical.gate_noisy_probs(
        MRF.create(C, theta=thetas[0], device="cpu"), lams[0])
    assert one.is_cuda and one.dtype == torch.float64
    assert float((one.cpu() - host).abs().max()) <= 1e-5
    batch = physical.gate_noisy_probs_batch(mrfs, lams)
    for r in range(len(mrfs)):
        single = physical.gate_noisy_probs(mrfs[r], lams[r])
        assert float((batch[r] - single).abs().max()) <= 1e-6
    clean = physical.gate_noisy_probs_batch(mrfs, [0.0] * len(mrfs))
    sv = circuit_kernel.batched_circuits_probs([(C, thetas)], device=dev)[0]
    assert float((clean - sv.double()).abs().max()) <= 1e-5


@pytest.mark.parametrize("engine", ["noisy:torino", "calibrated:torino"])
def test_noise_engines_on_card(dev, tmp_path, engine):
    """``run --engine noisy:torino | calibrated:torino`` on the card at
    1 000 shots, then ``eval`` on the card: the hardware schema, and each
    graph's mean delta-hat within 0.03 of its expected mean acceptance
    (about 4 sigma of 1 000 shots over 10 reps)."""
    from qcmrf_tpu_torch.noise import backends, channels, physical
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.runners import eval as run_eval

    out = run_experiment.main([
        "--scale", "0.1", "--shots", "1000", "--platform", "gpu",
        "--engine", engine, "--outdir", str(tmp_path / "res_0.1")])
    import json

    d = json.loads(open(out).read())
    assert set(d) == {"quasi_dists", "metadata"}
    assert len(d["quasi_dists"]) == 70
    before = dict(kernels.LAUNCHES)
    results = run_eval.main([
        "--results", out.rsplit("/", 1)[1], "--scale", "0.1", "--res-root",
        str(tmp_path), "--platform", "gpu"])
    assert kernels.LAUNCHES["logpot"] > before["logpot"]
    assert kernels.LAUNCHES["lse"] > before["lse"]
    suite = generate_suite(0.1)
    for g, (C, res) in enumerate(zip(suite.graphs, results)):
        mrfs = [MRF.create(C, theta=t, device=dev) for t in suite.thetas[g]]
        n, width = mrfs[0].n, mrfs[0].n + len(C) + 1
        bits = backends.measured_bits(mrfs[0])
        if engine == "noisy:torino":
            pre = backends.preset("torino")
            qs = [channels.apply_readout_confusion(
                backends.noisy_outcome_probs(m, pre).double(),
                [pre.readout] * len(bits), width, bits, invert=True)
                for m in mrfs]
        else:
            pm = physical.load_physical("torino", 0.1)
            mults = physical.rep_multipliers(pm, g, len(mrfs))
            probs = physical.gate_noisy_probs_batch(
                mrfs, [pm.lam[g] * u for u in mults])
            qs = [physical.expected_quasi(m, pm, g, probs[r], mults[r])
                  for r, m in enumerate(mrfs)]
        want = np.mean([float(q[: 1 << n].sum() / q.sum()) for q in qs])
        assert abs(res.mean_delta - want) <= 0.03, (C, res.mean_delta, want)
        assert res.mean_f > 0.9


# ---- the state-id offset of rows 2-7, and one sweep over a mesh ----------


def split_ranges(n, pieces):
    parts = kernels.lse_geometry(1 << n)[0]
    per = parts // pieces
    return [(i * per, per) for i in range(pieces)]


@pytest.mark.parametrize("pieces", [2, 4])
def test_offset_ranges_concatenate_to_the_whole_sweep(dev, pieces):
    """Rows 2, 4, 5, 6 and 7 split into block ranges by ``x0_blocks``:
    the pieces, concatenated in range order, are the single sweep's
    outputs bit for bit (n = 16, 64 blocks), and each piece equals its
    plain version at its offset."""
    m = model(dev, 4, 4)
    cl, n, beta = m.cliques, m.n, m.beta
    coef = kernels.moebius_coefficients(m)[None]
    masks = moebius.device_masks(cl, n, dev)
    lnz = kernels.combine_lse(*kernels.lse_partials(cl, n, coef, beta))
    rng = split_ranges(n, pieces)
    whole = [kernels.logpot_table(cl, n, coef, beta),
             *kernels.lse_partials(cl, n, coef, beta),
             *kernels.map_partials(cl, n, coef, beta),
             kernels.monomial_moment_partials(cl, n, coef, beta, lnz, masks),
             *kernels.lnz_moments_partials(cl, n, coef, beta, masks)]
    parts = [[kernels.logpot_table(cl, n, coef, beta, False, x0, b),
              *kernels.lse_partials(cl, n, coef, beta, x0, b),
              *kernels.map_partials(cl, n, coef, beta, None, x0, b),
              kernels.monomial_moment_partials(cl, n, coef, beta, lnz,
                                               masks, x0, b),
              *kernels.lnz_moments_partials(cl, n, coef, beta, masks, x0,
                                            b)]
             for x0, b in rng]
    for k, w in enumerate(whole):
        assert torch.equal(torch.cat([p[k] for p in parts], dim=1), w), k
    x0, b = rng[-1]
    assert torch.equal(parts[-1][0], kernels.logpot_table_split_reference(
        cl, n, coef, beta, False, x0, b))
    v, x = kernels.map_partials_reference(cl, n, coef, beta, x0, b)
    assert torch.equal(parts[-1][3], v) and torch.equal(parts[-1][4], x)


def test_offset_table_slice_past_2_31(dev):
    """A 34-variable chain's table slice of its last block (ids past 2^33)
    equals the split plain version there."""
    m = chain_mrf(34, device=dev).with_theta(
        -np.abs(np.random.RandomState(5).randn(4 * 33)).astype(np.float32)
        * 0.3)
    coef = kernels.moebius_coefficients(m)[None]
    last = kernels.lse_geometry(1 << 34)[0] - 1
    got = kernels.logpot_table(m.cliques, 34, coef, 1.0, False, last, 1)
    want = kernels.logpot_table_split_reference(m.cliques, 34, coef, 1.0,
                                                False, last, 1)
    assert torch.equal(got, want)


def test_mesh_sweep_on_one_card(dev):
    """Four shards on the one card: lnZ and MAP equal the single sweep."""
    from qcmrf_tpu_torch.parallel import sharded

    m = model(dev, 4, 5)
    mesh = sharded.Mesh((dev,) * 4)
    assert torch.equal(sharded.sharded_log_partition(m, mesh),
                       kernels.log_partition(m))
    assert sharded.sharded_map_state(m, mesh) == \
        kernels.map_state_streaming(m)


def scrambled_wide(n):
    """An H wall, then 1q gates on both device qubits of a 4-shard mesh, a
    sweep of sx and rz over every row qubit, twice, and two cx: Belady's
    victims leave a general permutation of the local bits to restore (a
    3-cycle through bits 7, local_n - 3 and local_n - 1)."""
    from qcmrf_tpu_torch.circuits.ir import Circuit

    c = Circuit(n)
    rng = np.random.RandomState(7)
    for q in range(n):
        c.h(q)
    for _ in range(2):
        c.sx(n - 1).sx(n - 2)
        for q in range(7, n - 2):
            c.sx(q).rz(float(rng.uniform(-np.pi, np.pi)), q)
    c.cx(n - 1, 3).cx(n - 2, n - 3)
    return c


def test_table_upload_waits_across_streams(dev):
    """A diagonal pass's profile table uploaded first on one stream, behind
    a sleep of about half a second, and read at once by the same pass on
    another stream (as the shards of the sharded engine share one cached
    table): the reading stream waits for the upload's event, so its pass
    equals the plain version within 1e-5, as the gate kernels' tests ask.
    Without that wait it reads the copy before it lands."""
    kernels._uploaded.cache_clear()
    rng = np.random.RandomState(11)
    terms = tuple(((q, 1), (q + 1, 0)) for q in range(12))
    angles = tuple(float(a) for a in rng.uniform(-3, 3, len(terms)))
    base = float(rng.uniform(-3, 3))
    shape = kernels.plane_shape(16)
    re, im = (torch.randn(shape, device=dev) for _ in range(2))
    want = kernels.apply_diagonal_profile_reference(re.clone(), im.clone(),
                                                    terms, angles, base)
    first, second = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    first.wait_stream(torch.cuda.current_stream(dev))
    second.wait_stream(torch.cuda.current_stream(dev))
    scratch = tuple(torch.zeros(shape, device=dev) for _ in range(2))
    # a table of the same size first: a new pinned host block is allocated
    # by a call that waits for the card, which would let the sleep end
    # before the upload is queued; after this one the block is reused
    with torch.cuda.stream(first):
        kernels.apply_diagonal_profile(*scratch, terms, angles[::-1], base)
    torch.cuda.synchronize()
    with torch.cuda.stream(first):
        torch.cuda._sleep(1_000_000_000)
        kernels.apply_diagonal_profile(*scratch, terms, angles, base)
    with torch.cuda.stream(second):
        kernels.apply_diagonal_profile(re, im, terms, angles, base)
    torch.cuda.synchronize()
    for g, w in zip((re, im), want):
        assert float((g - w).abs().max()) <= 1e-5


def test_sharded_engine_qcmrf28_equals_single_card(dev):
    """bench.py's 14-variable chain (28 qubits) through the gate-level
    sharded engine on one shard and on four shards of the card equals the
    single-card plane engine within 1e-6; four shards exchange >= 2
    times."""
    from qcmrf_tpu_torch.parallel import sharded

    theta = -np.abs(np.random.RandomState(0).randn(4 * 13)) * 0.3
    m = MRF.create([[i, i + 1] for i in range(13)], theta=theta, device=dev)
    circ = compile_qcmrf(m, with_measurements=False)
    wr, wi = planes.run_statevector(circ, device=dev)
    for D in (1, 4):
        re, im = sharded.run_statevector_sharded(
            circ, sharded.Mesh((dev,) * D))
        if D == 4:
            assert sharded.LAST_REMAP_COUNT >= 2
        for got, want in ((re, wr), (im, wi)):
            assert float((sharded.gather(got) - want.view(-1)).abs()
                         .max()) <= 1e-6
        del re, im


def test_sharded_engine_general_permutation_at_local_28(dev):
    """A 30-qubit circuit on four shards (local_n = 28) whose restore ends
    in a general permutation of the 28 local bits (a view of 28 axes
    passes the card's copy kernels' 25-dimension limit; the engine swaps
    bits through 5-axis views): equal to the single-card engine within
    1e-5."""
    from qcmrf_tpu_torch.parallel import sharded

    c = scrambled_wide(30)
    plan, _ = sharded._plan_fused(c, 28, 2)
    axes = [p for p in plan if p[0] == "perm"][0][1]
    assert sum(a != k for k, a in enumerate(axes)) >= 3
    mesh = sharded.Mesh((dev,) * 4)
    re, im = sharded.run_statevector_sharded(c, mesh)
    torch.cuda.synchronize()
    got_re, got_im = sharded.gather(re), sharded.gather(im)
    del re, im
    wr, wi = planes.run_statevector(c, device=dev)
    assert float((got_re - wr.view(-1)).abs().max()) <= 1e-5
    assert float((got_im - wi.view(-1)).abs().max()) <= 1e-5


def test_uniform_carrier_on_card(dev):
    """The write-only uniform sandwich kernel takes the carrier: 0 writes
    an all-zero state over whatever the planes held, 0.5 halves the
    carrier-1 state, each equal to the plain version within 1e-7."""
    args = (20, (0, 1, 2, 3, 4), 9, ((((0, 1),), ((2, 0), (3, 1))),
                                     (((1, 1),),)),
            ((0.3, -0.2), (0.7,)), (0.1, -0.4), (((5, 1),),), (0.25,), 0.05)
    full = kernels.apply_hdh_sandwich_multi_uniform(*args, device=dev)
    for carrier in (0.0, 0.5):
        out = tuple(torch.randn(full[0].shape, device=dev) for _ in range(2))
        got = kernels.apply_hdh_sandwich_multi_uniform(
            *args, out=out, carrier=carrier)
        want = kernels.apply_hdh_sandwich_multi_uniform_reference(
            *args, device=dev, carrier=carrier)
        for g, w, f in zip(got, want, full):
            assert float((g - w).abs().max()) <= 1e-7
            assert float((g - carrier * f).abs().max()) <= 1e-7
        if carrier == 0.0:
            assert not got[0].any() and not got[1].any()


def test_sharded_outcome_probs_qcmrf32_identity_path(dev):
    """The 16-variable chain with its measurements (32 qubits, identity
    wiring, the workspace qubit unmeasured) on four shards of the card
    takes the identity fast path: four parts of 2^30, total mass within
    1e-4 of 1, the accepted mass within 1e-5 of Z / 2^n. Its peak stays
    within 40 GiB: 32 GiB of planes, each freed as it is squared, and a
    stray-mass check by strided views (no index tensor of 2^30)."""
    from qcmrf_tpu_torch.parallel import sharded

    theta = -np.abs(np.random.RandomState(0).randn(4 * 15)) * 0.3
    m = MRF.create([[i, i + 1] for i in range(15)], theta=theta, device=dev)
    circ = compile_qcmrf(m)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    parts = sharded.sharded_outcome_probs(circ, sharded.Mesh((dev,) * 4))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    assert len(parts) == 4 and all(p.numel() == 1 << 30 for p in parts)
    total = sum(float(p.double().sum()) for p in parts)
    acc = float(parts[0][: 1 << m.n].double().sum())
    del parts
    torch.cuda.empty_cache()
    assert abs(total - 1.0) <= 1e-4
    assert abs(acc - float(m.success_rate())) <= 1e-5
    assert peak <= 40, peak


def test_sharded_outcome_probs_on_card(dev):
    """``sharded_outcome_probs`` on four shards of the card (a keyed
    reduce-scatter over key space) equals the plane engine's outcome
    distribution within 1e-6 for a permuted wiring of 14 qubits."""
    from qcmrf_tpu_torch.circuits.ir import Circuit
    from qcmrf_tpu_torch.parallel import sharded

    n = 14
    c = Circuit(n, num_clbits=n)
    for q in range(n):
        c.h(q)
    c.rz(0.9, 13).cx(13, 0).cp(0.6, 12, 1).cx(2, 11).sx(12).cx(12, 8)
    for q, k in enumerate(np.random.RandomState(2).permutation(n)):
        c.measure(q, int(k))
    parts = sharded.sharded_outcome_probs(c, sharded.Mesh((dev,) * 4))
    want = planes.simulate_probs(c, device=dev)
    assert len(parts) == 4
    assert float((sharded.gather(parts) - want).abs().max()) <= 1e-6
