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
    kc = sampler_kernel.keep_prob_coefficients(m)[None].repeat(3, 1)
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


def test_table_and_lse_kernels_match_plain_versions(dev):
    m = model(dev)
    coef = kernels.coefficient_table(
        m.cliques, m.n, torch.stack([m.theta, 0.5 * m.theta]))
    for fuse_amp in (False, True):
        torch.testing.assert_close(
            kernels.logpot_table(m.cliques, m.n, coef, 1.7, fuse_amp),
            kernels.logpot_table_reference(m.cliques, m.n, coef, 1.7,
                                           fuse_amp),
            rtol=1e-6, atol=1e-6)
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
    assert circuit_kernel.LAUNCHES["circuit"] == before + 7
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
    for m in (complete_model(n, dev), mixed_model(n, dev), tie_model(n, dev)):
        coef = kernels.moebius_coefficients(m)[None]
        before = kernels.LAUNCHES["map"]
        v, x = kernels.map_partials(m.cliques, n, coef, m.beta)
        assert kernels.LAUNCHES["map"] == before + 1
        wv, wx = kernels.map_partials_reference(m.cliques, n, coef, m.beta)
        assert torch.equal(x, wx)
        torch.testing.assert_close(v, wv, rtol=1e-6, atol=0)
    best, sid = kernels.combine_map(v, x)
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
    torch.testing.assert_close(
        kernels.logpot_table(cl, n, coef, beta),
        kernels.logpot_table_reference(cl, n, coef, beta),
        rtol=1e-6, atol=1e-6)
    lnz = kernels.combine_lse(*kernels.lse_partials(cl, n, coef, beta))
    torch.testing.assert_close(lnz, kernels.combine_lse(
        *kernels.lse_partials_reference(cl, n, coef, beta)), rtol=0,
        atol=1e-5)
    v, x = kernels.map_partials(cl, n, coef, beta)
    wv, wx = kernels.map_partials_reference(cl, n, coef, beta)
    assert torch.equal(x, wx)
    torch.testing.assert_close(v, wv, rtol=1e-6, atol=0)
    masks = torch.from_numpy(moebius.monomial_masks(cl, n)).to(dev)
    assert masks.numel() > 1500
    want = kernels.monomial_moments_reference(cl, n, coef, beta, lnz, masks)
    before = kernels.LAUNCHES["moments"]
    got = kernels.monomial_moments(cl, n, coef, beta, lnz, masks)
    assert kernels.LAUNCHES["moments"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    monkeypatch.setattr(kernels, "moments_per_launch", lambda K, cmax: 500)
    got = kernels.monomial_moments(cl, n, coef, beta, lnz, masks)
    assert (kernels.LAUNCHES["moments"]
            == before + 1 + -(-masks.numel() // 500))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


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
    moments kernel evaluates states by the per-state chain, as the plain
    lse does, so it is normalised by the chain's lnZ: by the lse kernel's
    (the split, another order of float32 sums) its probabilities sum to
    1 only within about 1e-6."""

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
        chain = kernels.combine_lse(*kernels.lse_partials_reference(
            m.cliques, n, coef, m.beta))
        torch.testing.assert_close(mono, kernels.monomial_moments(
            m.cliques, n, coef, m.beta, chain, masks), rtol=0, atol=1e-6)


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
                        lambda K, cmax, reserve=0: 500)
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
