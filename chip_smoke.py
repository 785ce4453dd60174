"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``qcmrf_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version on the card at the main paths'
shapes, times both, and drives the port's main paths, each with the
kernels' launch counters reset just before it and read just after:

* ``run`` (analytic engine) samples the 70-circuit suite (scale 0.1,
  10 000 shots) and ``eval`` scores it, both on the GPU;
* ``run --engine statevector`` runs the 70 gate-level circuits through the
  whole-circuit kernel (one launch per graph) and ``eval`` scores them;
* ``infer`` answers a batch of lnz, prob, map, mmap and marginals queries,
  with and without evidence, on bench.py's K27 complete graph (every
  query through the streaming lse, map and fused lnz_moments kernels, no
  moments launch), checked against the log-potential table on the card;
  a 32-variable chain's streaming MAP and lnZ (ids past 2^31) are held
  against elimination;
* the plane engine runs the 16-variable QCMRF chain at 32 qubits (three
  fused sandwich passes over 32 GiB of planes, in place), checked against
  the post-selected amplitudes of the log-potential kernel;
* the plane engine runs bench.py's 14-variable chain at 28 qubits lowered
  to the ``[cx, id, rz, sx, x]`` basis (``QCMRF.lowered``): about 2500
  diag, lane, row and sandwich passes, checked against the unlowered
  chain's state, global phase included; the unfused per-gate path and
  random circuits over the whole gate set are held against the fused
  stream and the dense engine at 20 qubits;
* ``train`` fits bench.py's K27 model for 5 steps through ``train_cli``
  on 20 000 ids drawn by ``sample_exact`` on the card, every gradient
  through the fused lnZ + moments kernel (one launch a step, each loss
  held against lnZ of the lse kernel); the K27 step is timed beside the
  lse + moments sweeps it replaces, the gradient held against the two
  sweeps' moments, and the table and elimination routes driven too;
* the copy and gate-pass rates at 28 qubits and the float32 FMA peak
  (``runners/bench.py``).

The lse and lnz_moments kernels evaluate states through the
block-invariant split: their bounds come from the split's operation
count, printed beside the per-state chain's count.

Every failed check raises, so the exit code is non-zero. The
second-to-last line is a JSON object with one entry per kernel (its time,
its plain version's time and the least time the card could take for the
same work); the last line is ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where PyTorch sees no CUDA device.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SAMPLE_SEED = 1234
N_SHOTS_CHECK = 1 << 20      # kernel vs plain version, all four modes
N_SHOTS_RATE = 1 << 27       # bench.py's operating point: 1 GiB of outputs

# NVIDIA's data sheet, H100 SXM at its 700 W limit: device memory rate and
# float32 rate outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12

GATE_WIDTHS = (20, 24, 26, 28, 30, 32)   # bench.py's chains, and 32
SANDWICH_WIDTH = 24
INFER_N = 27                             # bench.py's wide model, K27
GATE_PASS_WIDTH = 24     # the generic gate kernels against plain versions
LOWERED_WIDTH = 28       # bench.py's qcmrf28 chain, lowered: the main run
SMALL_WIDTH = 20         # the per-gate path and the random-circuit fuzz


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float operations over the float32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def chain_flops(cliques) -> int:
    """Float operations of one Moebius-chain evaluation of every clique:
    the constant, then one product and one sum per non-empty subset."""
    return sum(1 + 2 * ((1 << len(C)) - 1) for C in cliques)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events
    around ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    print(f"  ok: {what}")


def grid_model(rows: int, cols: int, seed: int, dev):
    from qcmrf_tpu_torch.models.mrf import grid_mrf

    template = grid_mrf(rows, cols, device=dev)
    rng = np.random.RandomState(seed)
    theta = -np.abs(rng.randn(template.dimension)).astype(np.float32) * 0.3
    return template.with_theta(theta)


def plain_sampler_shots(cliques, n, coef) -> int:
    """Largest power of two <= N_SHOTS_RATE whose plain-version run fits
    in 80% of the free device memory, scaled from a 2^20-shot run."""
    from qcmrf_tpu_torch.ops import sampler_kernel as sk

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sk.sample_call_reference(SAMPLE_SEED, cliques, n, coef,
                                   N_SHOTS_CHECK, "parts")
    del out
    per_shot = (torch.cuda.max_memory_allocated() - base) / N_SHOTS_CHECK
    free = torch.cuda.mem_get_info()[0]
    shots = N_SHOTS_RATE
    while shots > N_SHOTS_CHECK and per_shot * shots > 0.8 * free:
        shots //= 2
    return shots


def phase_sampler(dev, report):
    from qcmrf_tpu_torch.ops import kernels, sampler_kernel as sk

    print("[sampler] n=20 grid 4x5, theta = -|randn(RandomState(0))| * 0.3")
    mrf = grid_model(4, 5, 0, dev)
    cl, n = mrf.cliques, mrf.n
    coef = sk.keep_prob_coefficients(mrf)[None]
    err = 0
    for shots in (N_SHOTS_CHECK, N_SHOTS_CHECK + 77):
        for mode in sk.MODES:
            got = sk.sample_call(SAMPLE_SEED, cl, n, coef, shots, mode)
            want = sk.sample_call_reference(SAMPLE_SEED, cl, n, coef, shots,
                                            mode)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            mode_err = max(int((g.long() - w.long()).abs().max())
                           for g, w in zip(got, want))
            err = max(err, mode_err)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"kernel == plain version, mode {mode}, {shots} shots "
                    f"(max |kernel - plain| = {mode_err})")
        flags = sk.sample_call(SAMPLE_SEED, cl, n, coef, shots, "flags")
        count = sk.sample_call(SAMPLE_SEED, cl, n, coef, shots, "count")
        require(int(count[0]) == int(flags.sum()),
                f"count {int(count[0])} == flags.sum(), {shots} shots")

    delta = math.exp(float(kernels.log_partition(mrf)) - n * math.log(2.0))
    x, a = sk.sample_call(SAMPLE_SEED, cl, n, coef, N_SHOTS_RATE, "parts")
    acc = int((a == 0).sum())
    sigma = math.sqrt(delta * (1 - delta) / N_SHOTS_RATE)
    z = (acc / N_SHOTS_RATE - delta) / sigma
    require(abs(z) <= 5.0,
            f"acceptance {acc}/{N_SHOTS_RATE} = {acc / N_SHOTS_RATE:.6e} vs "
            f"delta {delta:.6e} from the lse kernel: {z:+.2f} sigma")
    require(int(x.min()) >= 0 and int(x.max()) < (1 << n), "x in [0, 2^n)")
    del x, a

    ms = {}
    for mode in ("parts", "flags", "count"):
        ms[mode] = cuda_ms(lambda: sk.sample_call(
            SAMPLE_SEED, cl, n, coef, N_SHOTS_RATE, mode), reps=10)
        print(f"  kernel {mode}: {ms[mode]:.3f} ms per {N_SHOTS_RATE} shots "
              f"= {N_SHOTS_RATE / ms[mode] / 1e6:.3f} G shots/s")
    plain_shots = plain_sampler_shots(cl, n, coef)
    plain_ms = cuda_ms(lambda: sk.sample_call_reference(
        SAMPLE_SEED, cl, n, coef, plain_shots, "parts"), reps=2)
    print(f"  plain parts: {plain_ms:.3f} ms per {plain_shots} shots = "
          f"{plain_shots / plain_ms / 1e6:.3f} G shots/s")
    torch.cuda.empty_cache()
    # per shot: 8 bytes of outputs; per clique the chain, the uniform's
    # scaling and the comparison (the Philox integer work is not counted)
    report["sampler"] = dict(
        **bound(8 * N_SHOTS_RATE,
                N_SHOTS_RATE * (chain_flops(cl) + 2 * len(cl))),
        max_abs_err=float(err),
        err_shape=f"(1, {N_SHOTS_CHECK}) and (1, {N_SHOTS_CHECK + 77}) "
                  f"shots, all modes {list(sk.MODES)}, n=20 K=31",
        ms=ms["parts"], plain_ms=plain_ms,
        shape=f"(1, {N_SHOTS_RATE}) shots, parts mode, n=20 K=31",
        plain_shape=f"(1, {plain_shots}) shots, parts mode")


def phase_logpot(dev, report):
    from qcmrf_tpu_torch.ops import kernels

    for rows, cols, seed in ((4, 5, 0), (4, 6, 1)):
        mrf = grid_model(rows, cols, seed, dev)
        coef = kernels.moebius_coefficients(mrf)[None]
        args = (mrf.cliques, mrf.n, coef, mrf.beta)
        got = kernels.logpot_table(*args)
        want = kernels.logpot_table_reference(*args)
        err = float((got - want).abs().max())
        print(f"[logpot] n={mrf.n} grid {rows}x{cols}: max |kernel - plain| "
              f"= {err:.3e}")
        require(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
                 f"log-potential kernel == plain version, n={mrf.n} "
                 "(rtol 1e-6, atol 1e-6)")
        amp = kernels.logpot_table(*args, fuse_amp=True)
        amp_want = kernels.logpot_table_reference(*args, fuse_amp=True)
        require(torch.allclose(amp, amp_want, rtol=1e-5, atol=0.0),
                f"amplitude epilogue == plain version, n={mrf.n} (rtol 1e-5)")
        total = float(kernels.gibbs_probs(mrf).double().sum())
        require(abs(total - 1.0) <= 1e-5,
                f"gibbs_probs sums to 1 within 1e-5 ({total:.8f})")
        ms = cuda_ms(lambda: kernels.logpot_table(*args), reps=10)
        plain_ms = cuda_ms(lambda: kernels.logpot_table_reference(*args),
                           reps=3)
        print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"for 2^{mrf.n} states")
        del got, want, amp, amp_want
        # per state: 4 bytes written, the clique chains and beta
        report["logpot"] = dict(
            **bound(4 << mrf.n, (chain_flops(mrf.cliques) + 1) << mrf.n),
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            shape=f"(1, 2^{mrf.n}) table, grid {rows}x{cols}")
    torch.cuda.empty_cache()


def split_ops(cliques, n: int, masks: int = 0) -> int:
    """Float operations of one split sweep over 2^n states: lse_kernel's,
    or with ``masks`` monomials lnz_moments_kernel's. The monomial
    coefficients once (an add a coefficient entry); per sub-block of 2^L
    states the plan's tests and adds (2 a monomial), the subset-sum
    transform (L 2^(L-1) adds) and, with masks, the superset sums and a
    test and an add a monomial; per state beta, the max, the difference
    and the exp (counted as one), and for lse the sum."""
    from qcmrf_tpu_torch.ops import kernels

    cl = tuple(tuple(C) for C in cliques)
    L = kernels.split_bits(n)
    plan = kernels.split_plan(cl, n, L)
    per_sub = (2 * len(plan.hm) + (L << (L - 1)) * (2 if masks else 1)
               + 2 * masks)
    return (len(plan.coef_index) + (per_sub << (n - L))
            + ((4 if masks else 5) << n))


def lse_row(what: str, mrf, reps: int) -> dict:
    """The lse kernel on one model: two launches bit-equal, lnZ within
    1e-4 of the table kernel's logsumexp and of its plain version; its
    time and its plain version's, and its bound from the split's count
    (the per-state chain's count beside it)."""
    from qcmrf_tpu_torch.ops import kernels

    coef = kernels.moebius_coefficients(mrf)[None]
    args = (mrf.cliques, mrf.n, coef, mrf.beta)
    m1, s1 = kernels.lse_partials(*args)
    m2, s2 = kernels.lse_partials(*args)
    require(torch.equal(m1, m2) and torch.equal(s1, s2),
            f"{what}: two lse launches give bit-equal partials")
    lnz = float(kernels.combine_lse(m1, s1)[0])
    table = kernels.logpot_table(*args)[0]
    from_table = float(torch.logsumexp(table, dim=0))
    del table
    torch.cuda.empty_cache()
    print(f"[lnZ] {what}: lse kernel {lnz:.6f}, logsumexp of the table "
          f"kernel {from_table:.6f}")
    require(abs(lnz - from_table) <= 1e-4,
            f"{what}: lse kernel == torch.logsumexp(log-potential table) "
            "within 1e-4")
    plain = float(kernels.combine_lse(
        *kernels.lse_partials_reference(*args))[0])
    err = abs(lnz - plain)
    require(err <= 1e-4, f"{what}: lse kernel == plain version within 1e-4 "
                         f"({err:.3e})")
    ms = cuda_ms(lambda: kernels.lse_partials(*args), reps=reps)
    plain_ms = cuda_ms(lambda: kernels.lse_partials_reference(*args), reps=1)
    torch.cuda.empty_cache()
    # device memory sees only the partials; per state the chains cost
    # chain_flops + 5 (beta, max, difference, exp, sum)
    n = mrf.n
    nbytes = 8 * kernels.lse_geometry(1 << n)[0]
    ops = split_ops(mrf.cliques, n)
    chain = (chain_flops(mrf.cliques) + 5) << n
    b = bound(nbytes, ops)
    print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms for 2^{n} states; "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) from the split's "
          f"{ops:.4e} operations (the chain's {chain:.4e}: "
          f"{bound(nbytes, chain)['bound_ms']:.3f} ms)")
    return dict(**b, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                split_ops=ops, chain_ops=chain,
                chain_bound_ms=bound(nbytes, chain)["bound_ms"])


def phase_lnz(dev, report):
    """The streaming logsumexp (``lse_kernel``, the block-invariant split)
    at n = 28 (grid 4x7) and on bench.py's K27 (2^27 states, K = 351),
    where the infer batch spends its lse sweeps."""
    from qcmrf_tpu_torch.models.mrf import MRF

    row = lse_row("n=28 grid 4x7", grid_model(4, 7, 2, dev), reps=20)
    k27 = MRF.create(complete_cliques(INFER_N), theta=k27_theta(),
                     device=dev)
    report["lse"] = dict(**row, shape="(1, 2^28) states, grid 4x7", k27=dict(
        **lse_row(f"K{INFER_N}, K={len(k27.cliques)}", k27, reps=20),
        shape=f"(1, 2^{INFER_N}) states, K{INFER_N} pairwise"))


def phase_suite_shapes(dev):
    """Kernel vs plain version at the shapes ``run``/``eval`` give them:
    one graph's 10 reps per launch."""
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.ops import kernels, sampler_kernel as sk

    suite = generate_suite(0.1)
    print("[suite shapes] the 7 graphs x 10 reps of scale 0.1")
    for j, C in enumerate(suite.graphs):
        cl = tuple(tuple(c) for c in C)
        n = max(v for c in C for v in c) + 1
        th = torch.tensor(suite.thetas[j], dtype=torch.float32, device=dev)
        kc = sk.keep_prob_table(cl, n, th, 1.0)
        got = sk.sample_call(0, cl, n, kc, 10_000, "parts", 10 * j)
        want = sk.sample_call_reference(0, cl, n, kc, 10_000, "parts", 10 * j)
        mc = kernels.coefficient_table(cl, n, th)
        lp = kernels.logpot_table(cl, n, mc, 1.0)
        lp_want = kernels.logpot_table_reference(cl, n, mc, 1.0)
        lz = kernels.combine_lse(*kernels.lse_partials(cl, n, mc, 1.0))
        lz_want = kernels.combine_lse(
            *kernels.lse_partials_reference(cl, n, mc, 1.0))
        require(all(torch.equal(g, w) for g, w in zip(got, want))
                and torch.allclose(lp, lp_want, rtol=1e-6, atol=1e-6)
                and torch.allclose(lz, lz_want, rtol=0.0, atol=1e-6),
                f"graph {C}: sampler identical, table and lnZ within 1e-6")


def counters():
    from qcmrf_tpu_torch.ops import circuit_kernel, kernels, sampler_kernel

    return (sampler_kernel.LAUNCHES, kernels.LAUNCHES, circuit_kernel.LAUNCHES)


def reset_counts() -> None:
    for c in counters():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def phase_main_path(dev, engine: str, needs):
    """``run --engine <engine>`` then ``eval`` of the 70 circuits on the
    GPU; returns the launch counts of that run."""
    from qcmrf_tpu_torch.runners import eval as run_eval
    from qcmrf_tpu_torch.runners import run_experiment

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        run_experiment.main([
            "--scale", "0.1", "--shots", "10000", "--platform", "gpu",
            "--engine", engine, "--sample-seed", "0",
            "--outdir", os.path.join(tmp, "res_0.1"), "--res-root", tmp])
        results = run_eval.main([
            "--results", f"result_{engine}_0.1.json", "--scale", "0.1",
            "--res-root", tmp, "--platform", "gpu", "--kl"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    print(f"[main path, {engine}] run + eval of 70 circuits on the GPU: "
          f"{seconds:.2f} s; launches {launches}")
    require(len(results) == 7, "7 graphs evaluated")
    for r in results:
        require(r.mean_f >= 0.99, f"graph {r.graph}: mean fidelity "
                                  f"{r.mean_f:.4f} >= 0.99")
        worst = max(abs(a - b) for a, b in zip(r.successes, r.exact_deltas))
        require(worst <= 0.02, f"graph {r.graph}: |delta-hat - delta| "
                               f"<= 0.02 (worst {worst:.4f})")
    for name, want in needs.items():
        count = launches[name]
        require(count > 0 if want is None else count == want,
                f"kernel {name} launched {count} times"
                + ("" if want is None else f" (expected {want})"))
    return launches


def chain_model(nn: int, dev):
    """bench.py's gate-level chain: nn variables, width 2 nn, theta =
    -|randn(RandomState(0))| * 0.3."""
    from qcmrf_tpu_torch.models.mrf import MRF

    theta = -np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3
    return MRF.create([[i, i + 1] for i in range(nn - 1)], theta=theta,
                      device=dev)


def phase_circuit_kernel(dev, report):
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.ops import circuit_kernel as ck

    suite = generate_suite(0.1)
    cases = [(C, np.asarray(suite.thetas[j], np.float32))
             for j, C in enumerate(suite.graphs)]
    chain8 = chain_model(8, "cpu")  # width 16: the kernel's widest
    cases.append((chain8.cliques, np.stack(
        [chain8.theta.numpy(), 0.5 * chain8.theta.numpy()])))
    print("[circuit kernel] the 7 suite graphs x 10 reps (scale 0.1) and "
          "the 8-variable chain (width 16)")
    err = 0.0
    for C, thetas in cases:
        got = ck.batched_circuit_probs(C, thetas, device=dev)
        want = ck.batched_circuit_probs_reference(C, thetas, device=dev)
        e = float((got - want).abs().max())
        err = max(err, e)
        # 2e-5 at the suite's widths (<= 10, values ~1e-3); at width 16
        # the values average 2^-15 ~ 3e-5, so 1e-6 there
        tol = 2e-5 if got.shape[1] <= 1 << 10 else 1e-6
        require(torch.allclose(got, want, rtol=0, atol=tol),
                f"graph {[list(c) for c in C]}: kernel == plain version "
                f"within {tol:.0e} (max |diff| {e:.2e}), shape "
                f"{tuple(got.shape)}")

    def suite70(fn):
        return lambda: [fn(C, suite.thetas[j], device=dev)
                        for j, C in enumerate(suite.graphs)]

    ms = cuda_ms(suite70(ck.batched_circuit_probs), reps=20)
    plain_ms = cuda_ms(suite70(ck.batched_circuit_probs_reference), reps=1)
    nbytes = flops = 0
    for j, C in enumerate(suite.graphs):
        n = max(v for c in C for v in c) + 1
        N = 1 << (n + len(C) + 1)
        B = len(suite.thetas[j])
        nbytes += B * (8 * sum(1 << len(c) for c in C) + 4 * N)
        flops += B * N * (6 * len(C) + 3)
    print(f"  suite70_gate_level_ms: kernel {ms:.3f} ms (7 launches), "
          f"plain {plain_ms:.3f} ms")
    report["circuit"] = dict(
        **bound(nbytes, flops), max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape="the 7 suite graphs, (10, 2^w) each, w <= 10: 7 launches "
              "(suite70_gate_level_ms)")
    torch.cuda.empty_cache()


def random_profiles(nq, a_lo, k, seed, with_mu):
    rng = np.random.RandomState(seed)
    free = [q for q in range(nq) if not a_lo <= q < a_lo + k]
    nts, nas = [], []
    for _ in range(k):
        terms = tuple(
            tuple((int(p), int(rng.randint(2))) for p in
                  rng.choice(free, rng.randint(1, 4), replace=False))
            for _ in range(rng.randint(1, 6)))
        nts.append(terms)
        nas.append(tuple(rng.randn(len(terms))))
    mu = ((((free[0], 1),), ((free[3], 0), (free[5], 1))), (0.4, -0.8), 0.3)
    return (tuple(nts), tuple(nas), tuple(rng.randn(k)),
            mu if with_mu else ((), (), 0.0))


def random_planes(nq, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = ((1 << nq) // 128, 128)
    return (torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))


def phase_sandwich_kernels(dev, report):
    """Each sandwich kernel against its plain version at width 24, with mu
    = 0 and mu != 0; times at that width. The multi kernel is held at k =
    1 (one sandwich on the top ancilla), 2 (the pair) and 7."""
    from qcmrf_tpu_torch.ops import kernels as K

    nq = SANDWICH_WIDTH
    N = 1 << nq
    cases = {
        # name: (kernel, plain, a_lo, k, bytes per value)
        "hdh_single": (K.apply_hdh_sandwich, K.apply_hdh_sandwich_reference,
                       nq - 1, 1, 16),
        "hdh_pair": (K.apply_hdh_sandwich_multi,
                     K.apply_hdh_sandwich_multi_reference, nq - 7, 2, 16),
        "hdh_multi": (K.apply_hdh_sandwich_multi,
                      K.apply_hdh_sandwich_multi_reference, nq - 11, 7, 16),
        "hdh_multi_uniform": (K.apply_hdh_sandwich_multi_uniform,
                              K.apply_hdh_sandwich_multi_uniform_reference,
                              nq - 11, 7, 8),
    }
    folded = tuple(range(nq - 12))  # the variables of the 12-chain
    print(f"[sandwich kernels] width {nq}: kernel vs plain version, "
          "random profiles, mu = 0 and mu != 0")
    for name, (fn, plain, a_lo, k, bpv) in cases.items():
        err = 0.0
        for with_mu in (False, True):
            nts, nas, nbs, mu = random_profiles(nq, a_lo, k, 7 * k + a_lo,
                                                with_mu)
            if name == "hdh_multi_uniform":
                def run(f):
                    return f(nq, folded, a_lo, nts, nas, nbs, *mu,
                             device=dev)
            elif name == "hdh_single":
                def run(f):
                    return f(*random_planes(nq, 5, dev), a_lo, nts[0],
                             nas[0], nbs[0], *mu)
            else:
                def run(f):
                    return f(*random_planes(nq, 5, dev), a_lo, nts, nas,
                             nbs, *mu)
            got, want = run(fn), run(plain)
            e = max(float((g - w).abs().max()) for g, w in zip(got, want))
            err = max(err, e)
            require(all(torch.allclose(g, w, rtol=0, atol=1e-5)
                        for g, w in zip(got, want)),
                    f"{name} (k={k}, ancillas from {a_lo}, mu "
                    f"{'!= 0' if with_mu else '= 0'}): kernel == plain "
                    f"version within 1e-5 (max |diff| {e:.2e})")
            del got, want
        planes = random_planes(nq, 6, dev)
        if name == "hdh_multi_uniform":
            def time_kernel():
                return fn(nq, folded, a_lo, nts, nas, nbs, *mu, out=planes)

            def time_plain():
                return plain(nq, folded, a_lo, nts, nas, nbs, *mu,
                             out=planes)
        elif name == "hdh_single":
            def time_kernel():
                return fn(*planes, a_lo, nts[0], nas[0], nbs[0], *mu)

            def time_plain():
                return plain(*planes, a_lo, nts[0], nas[0], nbs[0], *mu)
        else:
            def time_kernel():
                return fn(*planes, a_lo, nts, nas, nbs, *mu)

            def time_plain():
                return plain(*planes, a_lo, nts, nas, nbs, *mu)
        ms = cuda_ms(time_kernel, reps=20)
        plain_ms = cuda_ms(time_plain, reps=3)
        b = bound(bpv * N, N * (6 * k + 6))
        print(f"  {name}: max |kernel - plain| {err:.2e}; kernel {ms:.4f} "
              f"ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) at 2^{nq} values")
        report.setdefault("sandwich_w24", {})[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
            shape=f"2^{nq} values, k={k}, ancillas from {a_lo}")
        del planes
    torch.cuda.empty_cache()


def plain_ops(ops, nq, dev):
    """The fused stream through the plain versions."""
    from qcmrf_tpu_torch.ops import kernels as K

    re = im = None
    for op in ops:
        if op[0] == "sandwichku":
            _, folded, a, nts, nas, nbs, mt, ma, mb = op
            re, im = K.apply_hdh_sandwich_multi_uniform_reference(
                nq, folded, a, nts, nas, nbs, mt, ma, mb, device=dev)
        elif op[0] == "sandwichk":
            _, a, nts, nas, nbs, mt, ma, mb = op
            K.apply_hdh_sandwich_multi_reference(re, im, a, nts, nas, nbs,
                                                 mt, ma, mb)
        elif op[0] == "sandwich":
            _, a, nt, na, nb, mt, ma, mb = op
            K.apply_hdh_sandwich_reference(re, im, a, nt, na, nb, mt, ma, mb)
        else:
            raise AssertionError(f"unexpected op {op[0]}")
    return re, im


def pass_bytes(ops, nq) -> int:
    """Bytes the fused passes must move: a write-only pass writes both
    planes, a read-write pass reads and writes them."""
    return sum((8 if op[0] == "sandwichku" else 16) << nq for op in ops)


def diag_flops(terms, nq) -> int:
    """A diagonal pass: the phase's complex product per value, and a rotor
    composed (8 operations) at every state where a term holds."""
    total = 6 << nq
    for conds in terms:
        held = {}
        if all(held.setdefault(p, w) == w for p, w in conds):
            total += 8 << (nq - len(held))
    return total


def pass_flops(ops, nq) -> int:
    """Float operations of the fused passes: a complex multiply-add is 8;
    a lane op given with its factors does 2 a value for each factor that
    is not the identity (a 2x2 butterfly, as a rowq pass), a bare lane op
    (the dense product) 128, a row pass 2^K, a sandwich 6 per ancilla
    level plus its phase."""
    from qcmrf_tpu_torch.ops import kernels as K

    total = 0
    for op in ops:
        if op[0] == "lane" and len(op) == 3:
            total += 16 * bin(K.lane_factor_mask(op[2])).count("1") << nq
        elif op[0] == "lane":
            total += 1024 << nq
        elif op[0] in ("rowq", "row2"):
            total += (16 if op[0] == "rowq" else 32) << nq
        elif op[0] == "diag":
            total += diag_flops(op[1], nq)
        else:
            k = (len(op[3]) if op[0] == "sandwichku" else
                 1 if op[0] == "sandwich" else len(op[2]))
            total += (6 * k + 6) << nq
    return total


def dense_lanes(ops) -> list:
    """The stream with each lane op stripped of its factors: the dense
    product's count, the yardstick before the factored pass."""
    return [op[:2] if op[0] == "lane" else op for op in ops]


def stream_bound(ops, nq) -> dict:
    """The least time of a stream of passes: each pass bound by its bytes
    or its operations, summed; ``bound_by`` says which bound them."""
    each = [bound(pass_bytes([op], nq), pass_flops([op], nq)) for op in ops]
    by = {b["bound_by"] for b in each}
    return dict(bound_ms=sum(b["bound_ms"] for b in each),
                bound_by=by.pop() if len(by) == 1 else "bytes and operations")


def plain_gate_width(dev) -> int:
    """Largest gate-level width whose plain run fits in 80% of the free
    device memory, scaled from the peak of a width-20 run."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.sim import planes

    ops = planes.fuse_ops(compile_qcmrf(chain_model(10, "cpu"),
                                        with_measurements=False))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = plain_ops(ops, 20, dev)
    del out
    per_value = (torch.cuda.max_memory_allocated() - base) / (1 << 20)
    free = torch.cuda.mem_get_info()[0]
    width = 20
    for w in GATE_WIDTHS:
        if per_value * (1 << w) <= 0.8 * free:
            width = w
    return width


def norm_float64(re, im, chunk=1 << 27) -> float:
    total = 0.0
    fr, fi = re.view(-1), im.view(-1)
    for s in range(0, fr.numel(), chunk):
        total += float((fr[s:s + chunk].double() ** 2).sum()
                       + (fi[s:s + chunk].double() ** 2).sum())
    return total


def phase_gate_level(dev, report):
    """bench.py's gate-level chains on the plane engine at widths 20-32;
    the width-32 run is this path's counted main run."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.sim import dense, planes

    print("[gate level] QCMRF chains, theta = -|randn(RandomState(0))| * "
          "0.3, planes in place")
    plain_w = plain_gate_width(dev)
    rows = {}
    for w in GATE_WIDTHS:
        nn = w // 2
        mrf = chain_model(nn, dev)
        circ = compile_qcmrf(mrf, with_measurements=False)
        t0 = time.perf_counter()
        ops = planes.fuse_ops(circ)
        plan_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if w == max(GATE_WIDTHS):
            reset_counts()
            re, im = planes.run_statevector(circ, device=dev)
            torch.cuda.synchronize()
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated()
            print(f"  width {w}: main-path run, launches {launches}, peak "
                  f"memory {peak / 2**30:.3f} GiB")
            # sandwichku, then sandwichk (k=7) and sandwich (k=1)
            for name, want in (("hdh_multi_uniform", 1), ("hdh_multi", 2)):
                require(launches[name] == want,
                        f"kernel {name} launched {launches[name]} times in "
                        f"the width-{w} run (expected {want})")
            report["main_gate_level"] = launches
            check_width32(mrf, re, im, dev)
            # each pass alone at the main path's shape, on these planes
            for op in ops:
                ms = cuda_ms(lambda op=op: planes.apply_ops(re, im, [op], w),
                             reps=3)
                b = bound(pass_bytes([op], w), pass_flops([op], w))
                print(f"  width {w} pass {op[0]}: {ms:.3f} ms, bound "
                      f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
                report.setdefault("pass_w32", {})[op[0]] = dict(ms=ms, **b)
            del re, im
        elif w == SANDWICH_WIDTH:
            re, im = planes.run_statevector(circ, device=dev)
            want = dense.run_statevector(circ, device=dev)
            got = torch.complex(re, im).reshape(-1)
            e = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=0, atol=1e-5),
                    f"width {w}: planes == dense oracle on the card within "
                    f"1e-5 (max |diff| {e:.2e})")
            del re, im, want, got
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: planes.run_ops(ops, w, dev),
                     reps=3 if w >= 30 else 5)
        b = bound(pass_bytes(ops, w), pass_flops(ops, w))
        row = dict(ms=ms, passes=len(ops), gates=len(circ.gates),
                   plan_ms=plan_ms, **b)
        if w == plain_w:
            torch.cuda.empty_cache()
            row["plain_ms"] = cuda_ms(lambda: plain_ops(ops, w, dev),
                                      reps=1)
        rows[w] = row
        print(f"  qcmrf{w}_gate_level_ms {ms:.3f} (bound {b['bound_ms']:.3f}"
              f" ms, {b['bound_by']}); passes {len(ops)} "
              f"{[op[0] for op in ops]}; gates {len(circ.gates)}; planner "
              f"{plan_ms:.1f} ms on the host"
              + (f"; plain {row['plain_ms']:.3f} ms" if "plain_ms" in row
                 else ""))
        torch.cuda.empty_cache()
    report["gate_level"] = rows
    report["gate_plain_width"] = plain_w


def check_width32(mrf, re, im, dev) -> None:
    from qcmrf_tpu_torch.ops import kernels as K

    n = mrf.n
    w = re.numel().bit_length() - 1
    amp = K.postselected_amplitudes(mrf)
    got_re = re.view(-1)[: 1 << n]
    got_im = im.view(-1)[: 1 << n]
    rel = float(((got_re - amp).abs() / amp.abs()).max())
    imag = float(got_im.abs().max())
    require(rel <= 1e-4, f"width {w}: the first 2^{n} amplitudes == "
                         f"postselected_amplitudes (max relative error "
                         f"{rel:.2e} <= 1e-4)")
    require(imag <= 1e-6, f"width {w}: their imaginary parts <= 1e-6 "
                          f"(max {imag:.2e})")
    norm = norm_float64(re, im)
    require(abs(norm - 1.0) <= 1e-4, f"width {w}: norm {norm:.8f} within "
                                      "1e-4 of 1 (float64 over chunks)")


def complete_cliques(n: int):
    return [[i, j] for i in range(n) for j in range(i + 1, n)]


def k27_theta() -> np.ndarray:
    """bench.py's wide model: theta = -|randn(RandomState(11))| * 0.02,
    in float32 as bench.py rounds it."""
    d = 4 * len(complete_cliques(INFER_N))
    return -np.abs(np.random.RandomState(11).randn(d)).astype(
        np.float32) * np.float32(0.02)


def mixed_cliques(n: int):
    """A ring of 3-, 4- and 5-variable cliques over n variables."""
    cl, v, i = [], 0, 0
    while v < n - 1:
        c = (3, 4, 5)[i % 3]
        cl.append([u % n for u in range(v, v + c)])
        v, i = v + c - 1, i + 1
    return cl


def random_cliques(n: int, draws: int, size: int, seed: int):
    """Distinct random ``size``-variable cliques over n variables: at n =
    20, 700 draws of 4 give tables past 48 KB of shared memory and about
    1900 monomials."""
    rng = np.random.RandomState(seed)
    return [list(C) for C in sorted(
        {tuple(sorted(rng.choice(n, size, replace=False).tolist()))
         for _ in range(draws)})]


def seeded_model(cliques, seed, scale, dev, n=None):
    from qcmrf_tpu_torch.models.mrf import MRF

    d = sum(1 << len(C) for C in cliques)
    theta = -np.abs(np.random.RandomState(seed).randn(d)) * scale
    return MRF.create(cliques, theta=theta, n=n, device=dev)


def tie_chain(n: int, dev):
    """Chain rewarding unequal neighbours with dyadic theta: the two
    alternating states tie exactly at 0; the earliest is 0101..."""
    from qcmrf_tpu_torch.models.mrf import chain_mrf

    return chain_mrf(n, theta=np.tile([-0.5, 0.0, 0.0, -0.5], n - 1),
                     device=dev)


def infer_kernel_args(mrf):
    """(cliques, n, coef, beta, lnz, masks) of the two sweeps."""
    from qcmrf_tpu_torch.utils import moebius
    from qcmrf_tpu_torch.ops import kernels

    coef = kernels.moebius_coefficients(mrf)[None]
    lnz = kernels.log_partition(mrf).reshape(1)
    masks = torch.from_numpy(moebius.monomial_masks(mrf.cliques, mrf.n)).to(
        mrf.device)
    return mrf.cliques, mrf.n, coef, mrf.beta, lnz, masks


def timed_once(fn):
    """(result, milliseconds) of one call of ``fn``, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_map_and_moments(mrf, what: str, times=None) -> dict:
    """The map and moments kernels against their plain versions on one
    model; returns the largest differences. With ``times`` (a dict), also
    times each kernel (CUDA events over 5 calls after a warm-up) and each
    plain version (the one call that the check makes)."""
    from qcmrf_tpu_torch.ops import kernels

    args = infer_kernel_args(mrf)
    cl, n, coef, beta, lnz, masks = args
    (wv, wx), plain_map = timed_once(
        lambda: kernels.map_partials_reference(*args[:4]))
    v, x = kernels.map_partials(*args[:4])
    map_err = float((v - wv).abs().max())
    rel = float(((v - wv).abs() / wv.abs().clamp(min=1e-30)).max())
    require(torch.equal(x, wx) and rel <= 1e-6,
            f"{what}: map kernel == plain version: the same ids in all "
            f"{x.shape[1]} blocks, values within 1e-6 relative ({rel:.2e})")
    want, plain_mom = timed_once(
        lambda: kernels.monomial_moments_reference(*args))
    got = kernels.monomial_moments(*args)
    mom_err = float((got - want).abs().max())
    require(mom_err <= 1e-6,
            f"{what}: moments kernel == plain version within 1e-6 "
            f"absolute ({mom_err:.2e}, {masks.numel()} monomials)")
    del wv, wx, got, want
    torch.cuda.empty_cache()
    if times is not None:
        times["map"] = (cuda_ms(lambda: kernels.map_partials(*args[:4]),
                                reps=5), plain_map)
        times["moments"] = (cuda_ms(lambda: kernels.monomial_moments(*args),
                                    reps=5), plain_mom)
    return dict(map=map_err, moments=mom_err)


def oracle_pair_moments(t, lnz, n: int, sel=None, chunk=1 << 20):
    """E[x_i x_j] (E[x_i] on the diagonal) from the float64 table ``t`` by
    masked sums, in chunks of states: the streaming kernels' oracle."""
    dev = t.device
    shifts = (n - 1) - torch.arange(n, device=dev)
    M = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for s in range(0, t.numel(), chunk):
        xs = torch.arange(s, min(s + chunk, t.numel()), device=dev)
        B = ((xs[:, None] >> shifts) & 1).double()
        p = torch.exp(t[s:s + chunk] - lnz)
        if sel is not None:
            p = p * sel[s:s + chunk]
        M += B.T @ (B * p[:, None])
    return M


def pairwise_marginals(M, cliques) -> torch.Tensor:
    """Theta-layout clique marginals of a pairwise model from E[x_i x_j]:
    entries (x_i, x_j) = 00, 01, 10, 11, x_i slowest."""
    rows = []
    for i, j in cliques:
        mi, mj, mij = M[i, i], M[j, j], M[i, j]
        rows.append(torch.stack([1 - mi - mj + mij, mj - mij, mi - mij,
                                 mij]))
    return torch.cat(rows)


INFER_QUERIES = (
    {"query": "lnz"},
    {"query": "lnz", "evidence": "0=1,5=0"},
    {"query": "prob", "of": "3=1", "evidence": "0=1"},
    {"query": "map"},
    {"query": "map", "evidence": "0=1,5=0"},
    {"query": "marginals"},
    {"query": "marginals", "evidence": "0=1"},
    {"query": "mmap", "max_vars": "0,1,2"},
)


def phase_infer(dev, report) -> dict:
    """``infer`` on the K27 complete graph (width 27 > 25: every query goes
    to the streaming sweeps) against the table of the log-potential kernel;
    the kernels against their plain versions at n = 20 and at K27; a
    32-variable chain (state ids past 2^31) against elimination. Returns
    the launch counts of the K27 batch."""
    import contextlib
    import io

    from qcmrf_tpu_torch.utils import moebius
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.runners import infer_cli

    n = INFER_N
    print("[infer] kernels vs plain versions at n=20")
    err = dict(map=0.0, moments=0.0)
    for what, mrf in (
            ("K20", seeded_model(complete_cliques(20), 20, 0.05, dev)),
            ("3/4/5-variable ring n=20",
             seeded_model(mixed_cliques(20), 5, 0.3, dev)),
            ("wide 4-variable cliques n=20",
             seeded_model(random_cliques(20, 700, 4, 4), 5, 0.05, dev)),
            ("tie chain n=20", tie_chain(20, dev))):
        for k, e in check_map_and_moments(mrf, what).items():
            err[k] = max(err[k], e)
    v, x = kernels.combine_map(*kernels.map_partials(
        *infer_kernel_args(tie_chain(20, dev))[:4]))
    require(int(x[0]) == int("01" * 10, 2) and float(v[0]) == 0.0,
            "tie: the earliest of the two maxima (0101...) wins")

    cliques = complete_cliques(n)
    theta = k27_theta()
    with tempfile.TemporaryDirectory() as tmp:
        graph = os.path.join(tmp, "k27.json")
        theta_path = os.path.join(tmp, "theta.json")
        queries = os.path.join(tmp, "queries.jsonl")
        with open(graph, "w") as f:
            json.dump(cliques, f)
        with open(theta_path, "w") as f:
            json.dump(theta.tolist(), f)
        with open(queries, "w") as f:
            f.write("\n".join(json.dumps(q) for q in INFER_QUERIES))
        argv = ["--graph", graph, "--theta", theta_path, "--queries",
                queries, "--platform", "gpu"]
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        explain = subprocess.run(
            [sys.executable, "-m", "qcmrf_tpu_torch", "infer", *argv[:4],
             "--query", "marginals", "--explain"], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300, check=True)
        rep = json.loads(explain.stdout.strip().splitlines()[-1])
        require(rep["selected"] == "streaming" and rep["induced_width"] == n,
                "--explain answers with no CUDA device visible: K27, width "
                f"{rep['induced_width']}, selects {rep['selected']}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            results = infer_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    require(len(out.getvalue().splitlines()) == len(INFER_QUERIES),
            f"{len(INFER_QUERIES)} JSON lines printed")
    print(f"  K27 batch of {len(INFER_QUERIES)} queries through infer_cli: "
          f"{seconds:.3f} s; launches lse {launches['lse']}, map "
          f"{launches['map']}, lnz_moments {launches['lnz_moments']}, "
          f"moments {launches['moments']}")
    for k in ("lse", "map", "lnz_moments"):
        require(launches[k] > 0, f"kernel {k} launched {launches[k]} times "
                                 "in the K27 batch")
    require(launches["moments"] == 0,
            "the marginals went through the fused sweep: moments launched "
            f"{launches['moments']} times in the K27 batch")
    require(all(r["backend"] == "streaming" for r in results),
            "every K27 query went to the streaming sweeps")
    check_k27_answers(results, cliques, theta, dev)
    report["infer_k27_query_s"] = time_k27_queries(cliques, theta, dev)

    print("[infer] K27 kernels and plain versions at the batch's shape")
    mrf = MRF.create(cliques, theta=theta, device=dev)
    times = {}
    for k, e in check_map_and_moments(mrf, "K27", times).items():
        err[k] = max(err[k], e)
    cl = mrf.cliques
    m = moebius.monomial_layout(cl).m
    parts = kernels.lse_geometry(1 << n)[0]
    # per state: the chains and beta; then a compare (map), or the exp of
    # lp - lnZ and a mask test and an add per monomial (moments). Bytes:
    # the partials written (and the masks read)
    b = dict(map=bound(12 * parts, (chain_flops(cl) + 2) << n),
             moments=bound(4 * parts * m + 8 * m,
                           (chain_flops(cl) + 3 + 2 * m) << n))
    for k in ("map", "moments"):
        ms, plain_ms = times[k]
        print(f"  {k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b[k]['bound_ms']:.3f} ms ({b[k]['bound_by']}) at 2^{n} "
              f"states, K={len(cl)}" + (f", {m} monomials"
                                        if k == "moments" else ""))
        report[k] = dict(max_abs_err=err[k], ms=ms, plain_ms=plain_ms,
                         **b[k], shape=f"K{n} pairwise, 2^{n} states"
                         + (f", {m} monomials" if k == "moments" else ""))
    report["infer_k27_batch_s"] = seconds
    phase_chain32(dev)
    return launches


def time_k27_queries(cliques, theta, dev) -> list:
    """Host seconds of each batch query alone (answered as the batch
    answers it, ending in a synchronise): where the batch's time goes."""
    import argparse

    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.runners import infer_cli

    mrf = MRF.create(cliques, theta=theta, device=dev)
    rows = []
    for q in INFER_QUERIES:
        args = argparse.Namespace(query=q["query"],
                                  evidence=q.get("evidence", ""),
                                  of=q.get("of"), max_vars=q.get("max_vars"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_cli._answer(mrf, args, 1.0)
        torch.cuda.synchronize()
        rows.append(dict(query=q, seconds=time.perf_counter() - t0))
        print(f"  {json.dumps(q)}: {rows[-1]['seconds']:.4f} s")
    return rows


def check_k27_answers(results, cliques, theta, dev) -> None:
    """Every K27 answer against the log-potential table (2^27 float32,
    held in float64): lnZ and log masses by logsumexp (1e-4), MAP ids by
    argmax (equal), the probability and the marginals by masked sums
    (1e-5 absolute; evidence-inconsistent rows exactly 0)."""
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels

    n = INFER_N
    mrf = MRF.create(cliques, theta=theta, device=dev)
    t = kernels.all_log_potentials(mrf).double()
    x = torch.arange(1 << n, device=dev)

    def bit(v):
        return (x >> (n - 1 - v)) & 1

    def lse(sel=None):
        return torch.logsumexp(t if sel is None else
                               torch.where(sel, t, -math.inf), dim=0)

    by = {(r["query"], json.dumps(r["evidence"], sort_keys=True)): r
          for r in results}
    lnz = lse()
    e05 = (bit(0) == 1) & (bit(5) == 0)
    e0 = bit(0) == 1
    cases = [
        (by["lnz", "{}"]["lnz"], float(lnz), "lnZ"),
        (by["lnz", '{"0": 1, "5": 0}']["log_mass"], float(lse(e05)),
         "log mass of 0=1,5=0"),
    ]
    for got, want, what in cases:
        require(abs(got - want) <= 1e-4, f"K27 {what}: {got:.6f} vs table "
                                         f"{want:.6f} (1e-4)")
    p = float(torch.exp(lse(e0 & (bit(3) == 1)) - lse(e0)))
    got = by["prob", '{"0": 1}']["prob"]
    require(abs(got - p) <= 1e-5, f"K27 P(x3=1 | x0=1) {got:.8f} vs table "
                                  f"{p:.8f} (1e-5)")
    for ev, sel in (("{}", None), ('{"0": 1, "5": 0}', e05)):
        r = by["map", ev]
        want = int(torch.argmax(t if sel is None else
                                torch.where(sel, t, -math.inf)))
        require(r["state_id"] == want and abs(r["beta_logpot"]
                                              - float(t[want])) <= 1e-4,
                f"K27 MAP {ev}: state {r['state_id']} == table argmax "
                f"{want}, value within 1e-4")
    for ev, sel, lz in (("{}", None, lnz), ('{"0": 1}', e0, lse(e0))):
        got = torch.tensor(by["marginals", ev]["marginals"],
                           dtype=torch.float64, device=dev)
        want = pairwise_marginals(
            oracle_pair_moments(t, lz, n, None if sel is None
                                else sel.double()), cliques)
        e = float((got - want).abs().max())
        require(e <= 1e-5, f"K27 marginals {ev}: within 1e-5 of the table's "
                           f"masked sums (max |diff| {e:.2e})")
        if sel is not None:
            zero = [4 * k + (2 * a + b) for k, (i, j) in enumerate(cliques)
                    for a in (0, 1) for b in (0, 1)
                    if (i == 0 and a == 0) or (j == 0 and b == 0)]
            require(bool((got[zero] == 0).all()),
                    f"K27 marginals {ev}: the {len(zero)} evidence-"
                    "inconsistent entries are exactly 0")
    masses = []
    for a in range(8):
        sel = ((bit(0) == (a >> 2)) & (bit(1) == ((a >> 1) & 1))
               & (bit(2) == (a & 1)))
        masses.append(float(lse(sel)))
    best = int(np.argmax(masses))
    r = by["mmap", "{}"]
    want = {"0": best >> 2, "1": (best >> 1) & 1, "2": best & 1}
    require(r["max_vars"] == want and abs(r["log_mass"] - masses[best])
            <= 1e-4, f"K27 mmap over 0,1,2: {r['max_vars']} == {want}, "
                     f"log mass within 1e-4")
    del t, x
    torch.cuda.empty_cache()


def phase_chain32(dev) -> None:
    """State ids past 2^31: the streaming MAP and lnZ of a 32-variable
    chain against variable elimination on the card."""
    from qcmrf_tpu_torch.models import elimination
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.runners.infer_cli import _logpot_from_bits

    mrf = seeded_model([[i, i + 1] for i in range(31)], 32, 0.3, dev)
    # clique (0, 1) penalises x_0 = 0: the top id bit of the MAP is 1
    mrf = mrf.with_theta(mrf.theta - torch.tensor(
        [2.0, 2.0] + [0.0] * (mrf.dimension - 2), device=dev))
    t0 = time.perf_counter()
    sid, val = kernels.map_state_streaming(mrf)
    lnz = float(kernels.log_partition(mrf))
    seconds = time.perf_counter() - t0
    bits = [(sid >> (31 - v)) & 1 for v in range(32)]
    want = elimination.map_state_bits(mrf).cpu().tolist()
    lnz_e = float(elimination.log_partition(mrf))
    print(f"[chain32] 2^32 states: MAP id {sid} ({sid / 2**31:.3f} x 2^31), "
          f"lnZ {lnz:.6f} vs elimination {lnz_e:.6f}; both sweeps "
          f"{seconds:.3f} s")
    require(sid >= 1 << 31, "chain32: the MAP id lies past 2^31")
    require(bits == want, "chain32: streaming MAP bits == elimination's")
    host = _logpot_from_bits(mrf, bits)
    require(abs(val - host) <= 1e-4, f"chain32: MAP value {val:.6f} == "
                                     f"theta^T phi of its bits {host:.6f}")
    require(abs(lnz - lnz_e) <= 1e-4, "chain32: lnZ within 1e-4 of "
                                      "elimination")


TRAIN_SAMPLES = 20_000   # the train CLI's default sample count
TRAIN_STEPS = 5


def k27_mu_hat() -> np.ndarray:
    """bench.py's moment target of ``train_wide_k27_step_ms``: uniform(0.1,
    0.5) from RandomState(11) after its theta draw."""
    rs = np.random.RandomState(11)
    d = 4 * len(complete_cliques(INFER_N))
    rs.randn(d)
    return rs.uniform(0.1, 0.5, d)


def two_sweep_moments(mrf) -> torch.Tensor:
    """E_p[phi] of the two sweeps: lnZ by the lse kernel, then the
    moments kernel normalised by it (the fused sweep's yardstick)."""
    from qcmrf_tpu_torch.models import moments
    from qcmrf_tpu_torch.ops import kernels

    return moments.clique_moments_streaming(
        mrf, lnZ=kernels.log_partition(mrf))


def fused_vs_references(mrf, what: str, plain: bool = True) -> dict:
    """The lnz_moments kernel on one model against its plain version and
    against the two sweeps (lse, then moments normalised by it): lnZ
    within 1e-4 and every monomial moment within 1e-5. Returns the
    largest differences and the plain version's milliseconds."""
    from qcmrf_tpu_torch.ops import kernels

    cl, n, coef, beta, lnz2, masks = infer_kernel_args(mrf)
    lnz, mono = kernels.combine_lnz_moments(
        *kernels.lnz_moments_partials(cl, n, coef, beta, masks))
    mono2 = kernels.monomial_moments(cl, n, coef, beta, lnz2, masks)
    out = dict(lnz=abs(float(lnz[0]) - float(lnz2[0])),
               moments=float((mono - mono2).abs().max()), plain_ms=None)
    require(out["lnz"] <= 1e-4 and out["moments"] <= 1e-5,
            f"{what}: lnz_moments kernel == lse + moments kernels (lnZ "
            f"{out['lnz']:.2e}, moments {out['moments']:.2e}; 1e-4, 1e-5)")
    if plain:
        (pm, ps), out["plain_ms"] = timed_once(
            lambda: kernels.lnz_moments_partials_reference(cl, n, coef, beta,
                                                           masks))
        plnz, pmono = kernels.combine_lnz_moments(pm, ps)
        e_lnz = abs(float(lnz[0]) - float(plnz[0]))
        e_mom = float((mono - pmono).abs().max())
        require(e_lnz <= 1e-4 and e_mom <= 1e-5,
                f"{what}: lnz_moments kernel == plain version (lnZ "
                f"{e_lnz:.2e}, moments {e_mom:.2e} over {masks.numel()} "
                "monomials; 1e-4, 1e-5)")
        out["lnz"] = max(out["lnz"], e_lnz)
        out["moments"] = max(out["moments"], e_mom)
        del pm, ps
    torch.cuda.empty_cache()
    return out


def run_train_cli(argv, record=False):
    """``train_cli.main(argv)`` on the card with the launch counts reset
    just before and read just after: ``(fitted doc, launches, seconds,
    steps)``. With ``record``, ``steps`` lists each exact step's theta
    before the update, its loss and its launches (the step function is
    wrapped; the CLI is not changed)."""
    import contextlib
    import io

    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.runners import train_cli

    steps = []
    orig = mtrain.make_train_step

    def recording(template, optimizer, nonpositive=True):
        step = orig(template, optimizer, nonpositive)
        raw = optimizer.param_groups[0]["params"][0]

        def wrapped(batch):
            theta = mtrain._to_theta(raw, nonpositive).detach().clone()
            before = read_counts()
            loss = float(step(batch))
            after = read_counts()
            steps.append(dict(theta=theta, loss=loss, launches={
                k: after[k] - before[k] for k in after}))
            return loss

        return wrapped

    if record:
        mtrain.make_train_step = recording
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = train_cli.main(argv + ["--platform", "gpu"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    finally:
        mtrain.make_train_step = orig
    with open(out) as f:
        return json.load(f), launches, seconds, steps


def phase_train(dev, report) -> dict:
    """Exact-MLE training on bench.py's K27 complete graph (width 27 > 25:
    every gradient goes through the fused lnz_moments kernel): data from
    ``sample_exact`` on the card, ``train_cli.main`` for 5 steps, each
    step's loss held against lnZ of the lse kernel; the K27 step timed
    (``train_wide_k27_step_ms``) beside the two sweeps it replaces; the
    kernel against its plain version and the two-sweep kernels at K27 and
    n = 20; the NLL's gradient against beta (mu - mu_hat) of the two
    sweeps; the table and elimination routes of the CLI, and the
    enumeration route of make_lnz_fn. Returns the launch counts of the
    K27 CLI run."""
    from qcmrf_tpu_torch.evaluation.estimators import (
        clique_marginals_from_samples)
    from qcmrf_tpu_torch.models import sample
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.utils import moebius

    n = INFER_N
    cliques = complete_cliques(n)
    mrf = MRF.create(cliques, theta=k27_theta(), device=dev)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "train_k27")
    os.makedirs(out_dir, exist_ok=True)
    graph = os.path.join(out_dir, "k27.json")
    with open(graph, "w") as f:
        json.dump(cliques, f)

    print("[train] K27 (bench.py's wide model): exact MLE through the fused "
          "lnz_moments kernel")
    x, sample_ms = timed_once(lambda: sample.sample_exact(11, mrf,
                                                          TRAIN_SAMPLES))
    require(x.shape == (TRAIN_SAMPLES,) and int(x.min()) >= 0
            and int(x.max()) < 1 << n,
            f"sample_exact: {TRAIN_SAMPLES} K27 state ids in [0, 2^27) on "
            f"the card, {sample_ms:.1f} ms (two-stage draw)")
    data = os.path.join(out_dir, "data.json")
    with open(data, "w") as f:
        json.dump(x.cpu().tolist(), f)
    mu_data = clique_marginals_from_samples(mrf, x)
    mu = two_sweep_moments(mrf).double()
    gap = float((mu_data - mu).abs().max())
    require(gap <= 0.02, f"the samples' clique marginals within 0.02 of the "
                         f"exact ones ({gap:.4f}; 20 000 draws)")

    m_mono = moebius.monomial_layout(mrf.cliques).m
    per_launch = kernels.moments_per_launch(
        len(cliques), 2, reserve=kernels.lnz_moments_reserve(mrf.cliques, n))
    print(f"  K27: {m_mono} monomials, moments_per_launch {per_launch}")
    doc, launches, seconds, steps = run_train_cli(
        ["--graph", graph, "--data", data, "--steps", str(TRAIN_STEPS),
         "--checkpoint-every", str(TRAIN_STEPS),
         "--outdir", os.path.join(out_dir, "cli")], record=True)
    print(f"  train_cli K27, {TRAIN_STEPS} steps: {seconds:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    require(len(steps) == TRAIN_STEPS, f"{TRAIN_STEPS} steps recorded")
    for i, s in enumerate(steps):
        lm = s["launches"]
        require(lm["lnz_moments"] == 1 and lm["lse"] == 0
                and lm["moments"] == 0,
                f"step {i + 1}: lnz_moments launched once, lse and moments "
                "never")
        lnz = float(kernels.log_partition(mrf.with_theta(s["theta"])))
        want = lnz - float(mrf.beta * (s["theta"].double() * mu_data).sum())
        require(abs(s["loss"] - want) <= 1e-4,
                f"step {i + 1}: loss {s['loss']:.6f} == lnZ (lse kernel) - "
                f"beta theta^T mu_hat = {want:.6f} (1e-4)")
    require(doc["final_nll"] == steps[-1]["loss"]
            and len(doc["theta"]) == mrf.dimension
            and os.path.isdir(os.path.join(out_dir, "cli", "ckpt",
                                           str(TRAIN_STEPS))),
            "fitted_model.json holds the last step's loss and 1404 thetas; "
            f"ckpt/{TRAIN_STEPS} written")

    # the K27 step in bench.py's meaning, and the two sweeps it replaces
    raw = mtrain._from_theta(mrf.theta, True).requires_grad_()
    step = mtrain.make_moment_train_step(mrf, mtrain.adam([raw], 5e-2),
                                         k27_mu_hat())
    before = kernels.LAUNCHES["lnz_moments"]
    step_ms = cuda_ms(step, reps=5)
    require(kernels.LAUNCHES["lnz_moments"] - before == 6,
            "make_moment_train_step: one lnz_moments launch a step")
    args = infer_kernel_args(mrf)
    cl, _, coef, beta, _, masks = args
    two_ms = cuda_ms(lambda: kernels.monomial_moments(
        cl, n, coef, beta, kernels.combine_lse(*kernels.lse_partials(
            cl, n, coef, beta)).float(), masks), reps=5)
    fused_ms = cuda_ms(lambda: kernels.lnz_moments_partials(
        cl, n, coef, beta, masks), reps=5)
    print(f"  train_wide_k27_step_ms {step_ms:.3f}; lnz_moments kernel "
          f"{fused_ms:.3f} ms; lse + moments kernels {two_ms:.3f} ms")

    err = fused_vs_references(mrf, "K27")
    plain_ms = err["plain_ms"]
    for what, m in (("K20", seeded_model(complete_cliques(20), 20, 0.05,
                                         dev)),
                    ("3/4/5-variable ring n=20",
                     seeded_model(mixed_cliques(20), 5, 0.3, dev))):
        e = fused_vs_references(m, what)
        err = {k: max(err[k], e[k]) for k in ("lnz", "moments")}

    # the NLL's gradient on the card: the fused sweep as the backward
    theta = mrf.theta.clone().requires_grad_()
    (grad,) = torch.autograd.grad(mrf.with_theta(theta).nll(x), theta)
    want = (mrf.beta * (mu - mu_data)).float()
    g_err = float((grad - want).abs().max())
    require(g_err <= 1e-5, f"K27: autograd.grad of MRF.nll == beta (mu - "
                           f"mu_hat) of the two sweeps within 1e-5 "
                           f"({g_err:.2e})")

    # the other routes: the table (n = 20, _nll's enumeration branch and
    # make_lnz_fn's), and elimination on bit-array data (a 32-chain)
    grid = grid_model(4, 5, 0, dev)
    ids = os.path.join(out_dir, "grid20.json")
    with open(ids, "w") as f:
        json.dump(sample.sample_exact(5, grid, TRAIN_SAMPLES).cpu().tolist(),
                  f)
    gdoc, glaunch, gsec, _ = run_train_cli(
        ["--graph", "grid:4x5", "--data", ids, "--steps", "3",
         "--outdir", os.path.join(out_dir, "grid")])
    require(glaunch["lnz_moments"] == 3 and math.isfinite(gdoc["final_nll"]),
            f"table route (grid 4x5, n=20): 3 steps, 3 lnz_moments launches, "
            f"final nll {gdoc['final_nll']:.4f} ({gsec:.2f} s)")
    gtheta = grid.theta.clone().requires_grad_()
    (g,) = torch.autograd.grad(mtrain.make_lnz_fn(grid)(gtheta), gtheta)
    e = float((g - grid.beta * two_sweep_moments(grid)).abs().max())
    require(e <= 1e-5, f"make_lnz_fn enumeration route (n=20): gradient == "
                       f"beta mu of the two sweeps ({e:.2e})")
    bits = (np.random.RandomState(32).rand(4096, 32) < 0.3).astype(int)
    bpath = os.path.join(out_dir, "chain32_bits.json")
    with open(bpath, "w") as f:
        json.dump(bits.tolist(), f)
    edoc, elaunch, esec, _ = run_train_cli(
        ["--graph", "chain:32", "--data", bpath, "--steps", "3",
         "--outdir", os.path.join(out_dir, "chain32")])
    require(sum(elaunch.values()) == 0 and math.isfinite(edoc["final_nll"]),
            f"elimination route (32-chain, bit-array data): 3 steps, no "
            f"kernel launch, final nll {edoc['final_nll']:.4f} ({esec:.2f} s)")

    # bytes: the partials written and the masks read. Operations: the
    # split's count; the per-state chain's beside it (the chains and beta,
    # a max, the exp of v - M, and a mask test and an add per monomial a
    # state)
    parts = kernels.lse_geometry(1 << n)[0]
    nbytes = 4 * parts * (m_mono + 1) + 8 * m_mono
    ops = split_ops(cliques, n, m_mono)
    chain = (chain_flops(cliques) + 4 + 2 * m_mono) << n
    b = bound(nbytes, ops)
    chain_bound = bound(nbytes, chain)["bound_ms"]
    print(f"  lnz_moments: kernel {fused_ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) from the "
          f"split's {ops:.4e} operations (the chain's {chain:.4e}: "
          f"{chain_bound:.3f} ms) at 2^{n} states, K={len(cliques)}, "
          f"{m_mono} monomials")
    report["lnz_moments"] = dict(
        max_abs_err=max(err["lnz"], err["moments"]),
        lnz_err=err["lnz"], moments_err=err["moments"], ms=fused_ms,
        plain_ms=plain_ms, **b, split_ops=ops, chain_ops=chain,
        chain_bound_ms=chain_bound,
        shape=f"K{n} pairwise, 2^{n} states, {m_mono} monomials")
    report["train"] = dict(
        train_wide_k27_step_ms=step_ms, two_sweep_ms=two_ms,
        cli_seconds=seconds, sample_exact_ms=sample_ms,
        losses=[s["loss"] for s in steps], grad_err=g_err,
        moments_per_launch=per_launch)
    del x, mu, mu_data
    torch.cuda.empty_cache()
    return launches


#: generic gate kernel -> the op kinds of the planner that launch it
GATE_KERNEL_OPS = {"lane_factored": ("lane",),
                   "row_gate": ("rowq", "row2"), "diag": ("diag",),
                   "hdh_multi": ("sandwich", "sandwichk")}


def unit_planes(nq, seed, dev):
    """Random planes of a unit-norm state."""
    re, im = random_planes(nq, seed, dev)
    scale = math.sqrt(norm_float64(re, im))
    return re.div_(scale), im.div_(scale)


def hadamard_wall():
    """The planner's composed lane op of H on qubits 0-6."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.sim.dense import GATES_1Q

    H = np.asarray(GATES_1Q["h"], np.complex64)
    M = np.eye(128, dtype=np.complex64)
    for q in range(7):
        M = K._lane_gate_matrix(H, q) @ M
    return M


def gate_cases(nq):
    """(kernel, label, wrapper, plain version, arguments after the planes)
    of every generic gate case held at width ``nq``."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.sim.dense import GATES_1Q

    rng = np.random.RandomState(nq)
    cases = []
    # a condition on the top bit, and a term with no condition
    special = (((nq - 1, 1), (4, 0)), ())
    for count in (1, 12, 64):
        terms = special[:1] if count == 1 else tuple(
            tuple((int(p), int(rng.randint(2))) for p in
                  rng.choice(nq, rng.randint(1, 4), replace=False))
            for _ in range(count - 2)) + special
        angles = tuple(rng.uniform(-np.pi, np.pi, count))
        cases.append(("diag", f"diag, {count} terms",
                      K.apply_diagonal_profile,
                      K.apply_diagonal_profile_reference,
                      (terms, angles, 0.3)))
    cases.append(("diag", "masked rotation", K.apply_masked_rotation,
                  K.apply_masked_rotation_reference,
                  (((nq - 1, 1), (7, 0)), -0.2, 1.3)))
    U = (rng.randn(2, 2) + 1j * rng.randn(2, 2)).astype(np.complex64) / 2
    for q in (7, 15, nq - 1):
        cases.append(("row_gate", f"rowq q={q}", K.apply_1q,
                      K.apply_1q_reference, (U, q, nq)))
    U4 = (rng.randn(4, 4) + 1j * rng.randn(4, 4)).astype(np.complex64) / 3
    for q_lo in (7, nq - 2):
        cases.append(("row_gate", f"row2 q_lo={q_lo}", K.apply_2q_row_pair,
                      K.apply_2q_row_pair_reference, (U4, q_lo)))
    M = ((rng.randn(128, 128) + 1j * rng.randn(128, 128)) / 16).astype(
        np.complex64)
    H = np.asarray(GATES_1Q["h"], np.complex64)
    for label, lane_op in (("lane, H on qubit 3", K._lane_gate_matrix(H, 3)),
                           ("lane, the 7-H wall", hadamard_wall()),
                           ("lane, random complex M", M)):
        cases.append(("lane", label, K.apply_lane, K.apply_lane_reference,
                      (lane_op,)))
    wall = np.tile(H, (7, 1, 1))
    for label, factors in (
            ("lane_factored, 1 random factor", random_factors(rng, 1)),
            ("lane_factored, 3 random factors", random_factors(rng, 3)),
            ("lane_factored, 7 random factors", random_factors(rng, 7)),
            ("lane_factored, the 7-H wall", wall)):
        cases.append(("lane_factored", label, K.apply_lane_factored,
                      K.apply_lane_factored_reference, (factors,)))
    return cases


def random_factors(rng, count):
    """Lane factors: random unitaries on ``count`` lane qubits, the
    identity on the others."""
    from qcmrf_tpu_torch.ops import kernels as K

    factors = K.identity_factors()
    for q in rng.choice(7, count, replace=False):
        a = rng.randn(2, 2) + 1j * rng.randn(2, 2)
        factors[q] = np.linalg.qr(a)[0].astype(np.complex64)
    return factors


def stream_cases(ops):
    """(kernel, label, wrapper, plain version, arguments after the planes)
    of the lowered width-28 chain's own passes: the first diag pass of
    each term count and the first with a condition on the top bit, the
    rowq passes on the stream's lowest and highest qubit, every row2 pass,
    the first and last lane pass and the one with the most nonzeros."""
    from qcmrf_tpu_torch.ops import kernels as K

    nq = LOWERED_WIDTH
    calls = {
        "diag": ("diag", K.apply_diagonal_profile,
                 K.apply_diagonal_profile_reference, lambda op: op[1:]),
        "rowq": ("row_gate", K.apply_1q, K.apply_1q_reference,
                 lambda op: (op[1], op[2], nq)),
        "row2": ("row_gate", K.apply_2q_row_pair,
                 K.apply_2q_row_pair_reference, lambda op: op[1:]),
        "lane": ("lane_factored", K.apply_lane_factored,
                 K.apply_lane_factored_reference, lambda op: (op[2],)),
    }
    rowq = [op[2] for op in ops if op[0] == "rowq"]
    lanes = [i for i, op in enumerate(ops) if op[0] == "lane"]
    densest = densest_lane(ops)
    picked = {}
    for i, op in enumerate(ops):
        if op[0] == "diag":
            picked.setdefault(f"diag, {len(op[1])} terms", i)
            if any(p == nq - 1 for conds in op[1] for p, _ in conds):
                picked.setdefault(f"diag on bit {nq - 1}", i)
        elif op[0] == "rowq" and op[2] in (min(rowq), max(rowq)):
            picked.setdefault(f"rowq q={op[2]}", i)
        elif op[0] == "row2":
            picked[f"row2 q_lo={op[2]}, pass {i}"] = i
        elif i in (lanes[0], lanes[-1], densest):
            factors = bin(K.lane_factor_mask(op[2])).count("1")
            picked[f"lane, {np.count_nonzero(op[1])} nonzeros, {factors} "
                   f"factors, pass {i}"] = i
    cases = []
    for label, i in picked.items():
        kind, fn, ref, args = calls[ops[i][0]]
        cases.append((kind, f"stream: {label}", fn, ref, args(ops[i])))
    return cases


def densest_lane(ops) -> int:
    """Index of the stream's lane op with the most nonzeros in its M."""
    lanes = [i for i, op in enumerate(ops) if op[0] == "lane"]
    return max(lanes, key=lambda i: np.count_nonzero(ops[i][1]))


#: the case of each kernel whose plain version is timed at width 24
TIMED_CASE = {"diag": "diag, 12 terms", "row_gate": "rowq q=15",
              "lane": "lane, the 7-H wall",
              "lane_factored": "lane_factored, 7 random factors"}


def lane_library(M, nq, dev):
    """One float32 torch.matmul (no TF32) computing the lane op on planes
    stacked as (rows, 256): [re, im] @ [[Mr^T, Mi^T], [-Mi^T, Mr^T]].
    Returns (run, the stacked planes, its output, split): split turns a
    stacked tensor back into a pair of planes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mr = torch.from_numpy(np.ascontiguousarray(M.real)).to(dev)
    mi = torch.from_numpy(np.ascontiguousarray(M.imag)).to(dev)
    W = torch.cat([torch.cat([mr.T, mi.T], 1), torch.cat([-mi.T, mr.T], 1)])
    X = torch.cat(unit_planes(nq, 9, dev), 1)
    out = torch.empty_like(X)

    def split(T):
        return T[:, :128].contiguous(), T[:, 128:].contiguous()
    return (lambda: torch.matmul(X, W, out=out)), X, out, split


def row_library(U, q_lo, k, nq, dev):
    """One float32 torch.matmul (no TF32) computing a row pass on planes
    stacked as (g, [re, im] x 2^k, 2^q_lo): the real block [[Ur, -Ui],
    [Ui, Ur]] times every group. Returns (run, the stacked planes, its
    output, split), as :func:`lane_library`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, S = 1 << k, 1 << q_lo
    U = np.asarray(U, np.complex64)
    W = torch.from_numpy(np.block([[U.real, -U.imag], [U.imag, U.real]])
                         .astype(np.float32)).to(dev)
    re, im = unit_planes(nq, 9, dev)
    shape = re.shape
    X = torch.cat([re.view(-1, n, S), im.view(-1, n, S)], 1)
    del re, im
    out = torch.empty_like(X)

    def split(T):
        return (T[:, :n].contiguous().view(shape),
                T[:, n:].contiguous().view(shape))
    return (lambda: torch.matmul(W, X, out=out)), X, out, split


def hold_library(label, library, apply) -> float:
    """Runs a library call and the kernel (``apply``, in place on the
    same input split into planes) and requires them within 1e-5; returns
    the library call's mean ms."""
    run, X, out, split = library
    run()
    planes_ = split(X)
    apply(*planes_)
    e = max(float((a - b).abs().max()) for a, b in zip(planes_, split(out)))
    require(e <= 1e-5, f"{label}: torch.matmul (float32, no TF32) == kernel "
                       f"within 1e-5 (max |diff| {e:.2e})")
    del planes_
    return cuda_ms(run, reps=3)


def phase_library_calls(dev, ops, report) -> None:
    """At the main run's width 28: the factored lane kernel against
    torch.matmul on the stream's densest lane op (the same function), the
    dense lane kernel against torch.matmul on the random M (and timed
    itself, on the 7-H wall: no main path launches it), and the row kernel
    against torch.matmul on every (K, qubit) of the lowered chain's row
    passes; each library call timed, the row call's time weighted by the
    stream's passes."""
    from qcmrf_tpu_torch.ops import kernels as K

    nq = LOWERED_WIDTH
    densest = ops[densest_lane(ops)]
    report["lane_factored_library_ms"] = hold_library(
        f"lane_factored at width {nq}, the stream's densest lane op "
        f"({np.count_nonzero(densest[1])} nonzeros)",
        lane_library(densest[1], nq, dev),
        lambda re, im: K.apply_lane_factored(re, im, densest[2]))
    M = next(c[4][0] for c in gate_cases(GATE_PASS_WIDTH)
             if c[1] == "lane, random complex M")
    report["lane_library_ms"] = hold_library(
        f"lane at width {nq}, random complex M", lane_library(M, nq, dev),
        lambda re, im: K.apply_lane(re, im, M))
    re, im = unit_planes(nq, 9, dev)
    wall = hadamard_wall()
    report["lane_w28"] = dict(
        ms=cuda_ms(lambda: K.apply_lane(re, im, wall), reps=3),
        library_ms=report["lane_library_ms"],
        shape=f"2^{nq} values, the 7-H wall as a dense M",
        **bound(16 << nq, 1024 << nq))
    del re, im
    torch.cuda.empty_cache()
    print(f"  dense lane kernel at 2^{nq} values: "
          f"{report['lane_w28']['ms']:.4f} ms a pass; torch.matmul "
          f"{report['lane_library_ms']:.4f} ms (random M); the densest "
          f"lane op's torch.matmul {report['lane_factored_library_ms']:.4f} "
          "ms")
    rows = [op for op in ops if op[0] in ("rowq", "row2")]
    by_key = {}
    for op in rows:
        key = (1 if op[0] == "rowq" else 2, op[2])
        if key not in by_key:
            k, q = key
            by_key[key] = hold_library(
                f"row K={k} at qubit {q}, width {nq}",
                row_library(op[1], q, k, nq, dev),
                lambda re, im: (K.apply_1q(re, im, op[1], q) if k == 1 else
                                K.apply_2q_row_pair(re, im, op[1], q)))
            torch.cuda.empty_cache()
    lib = sum(by_key[(1 if op[0] == "rowq" else 2, op[2])]
              for op in rows) / len(rows)
    print(f"  library calls at 2^{nq} values: row {lib:.4f} ms a pass "
          f"(mean over the stream's "
          f"{len(rows)} row passes; by (K, qubit): "
          + ", ".join(f"{k}:{ms:.3f}" for k, ms in sorted(by_key.items()))
          + ")")
    report["row_gate_library_ms"] = lib
    report["row_library_by_qubit"] = {f"K={k} q={q}": ms for (k, q), ms
                                      in sorted(by_key.items())}
    torch.cuda.empty_cache()


def phase_gate_kernels(dev, report):
    """Each generic gate kernel against its plain version on unit-norm
    planes (copies: the passes work in place), atol 1e-5: at width 24,
    where the plain versions are timed, and at the main run's width 28,
    with the lowered chain's own passes; then the library calls at 28."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.sim import planes

    ops = planes.fuse_ops(lowered_chain(LOWERED_WIDTH // 2)[1])
    err = {w: dict(diag=0.0, row_gate=0.0, lane=0.0, lane_factored=0.0,
                   copy=0.0) for w in (GATE_PASS_WIDTH, LOWERED_WIDTH)}
    err[8] = dict(lane=0.0, lane_factored=0.0)
    plain = {}
    # width 8 (two rows): both lane kernels on every lane case, and the
    # copy at width 7 (one row)
    small = [c for c in gate_cases(GATE_PASS_WIDTH) + stream_cases(ops)
             if c[0] in ("lane", "lane_factored")]
    print(f"[gate kernels] width 8: {len(small)} lane cases; the copy at "
          "width 7")
    for kind, label, fn, ref, args in small:
        got = fn(*unit_planes(8, 2, dev), *args)
        want = ref(*unit_planes(8, 2, dev), *args)
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        err[8][kind] = max(err[8][kind], e)
        require(e <= 1e-5, f"{label}, width 8: kernel == plain version "
                           f"within 1e-5 (max |diff| {e:.2e})")
    src = unit_planes(7, 4, dev)
    out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
    K.copy_planes(*src, out=out)
    require(torch.equal(out[0], src[0]) and torch.equal(out[1], src[1]),
            "copy kernel at width 7: both planes copied exactly")
    for nq in (GATE_PASS_WIDTH, LOWERED_WIDTH):
        cases = gate_cases(nq)
        if nq == LOWERED_WIDTH:
            cases += stream_cases(ops)
        print(f"[gate kernels] width {nq}: {len(cases) + 1} cases, kernel vs "
              "plain version on unit-norm planes")
        for kind, label, fn, ref, args in cases:
            got = fn(*unit_planes(nq, 2, dev), *args)
            want = ref(*unit_planes(nq, 2, dev), *args)
            e = max(float((g - w).abs().max()) for g, w in zip(got, want))
            err[nq][kind] = max(err[nq][kind], e)
            require(e <= 1e-5, f"{label}: kernel == plain version within "
                               f"1e-5 (max |diff| {e:.2e})")
            del got, want
            torch.cuda.empty_cache()
            if nq == GATE_PASS_WIDTH and TIMED_CASE[kind] == label:
                planes_ = unit_planes(nq, 3, dev)
                plain[kind] = dict(
                    plain_ms=cuda_ms(lambda: ref(*planes_, *args), reps=3),
                    ms_at_plain_shape=cuda_ms(lambda: fn(*planes_, *args),
                                              reps=10),
                    plain_shape=f"2^{nq} values, {label}")
                del planes_
        src = unit_planes(nq, 4, dev)
        out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
        K.copy_planes(*src, out=out)
        err[nq]["copy"] = max(float((o - s).abs().max())
                              for o, s in zip(out, src))
        require(torch.equal(out[0], src[0]) and torch.equal(out[1], src[1]),
                f"copy kernel at width {nq}: both planes copied exactly")
        if nq == GATE_PASS_WIDTH:
            plain["copy"] = dict(
                plain_ms=cuda_ms(lambda: K.copy_planes_reference(
                    *src, out=out), reps=10),
                ms_at_plain_shape=cuda_ms(lambda: K.copy_planes(
                    *src, out=out), reps=10),
                plain_shape=f"2^{nq} values, both planes")
        del src, out
        torch.cuda.empty_cache()
    for kind, row in plain.items():
        by_width = {w: e[kind] for w, e in sorted(err.items()) if kind in e}
        print(f"  {kind}: max |kernel - plain| {by_width}; plain "
              f"{row['plain_ms']:.3f} ms, kernel "
              f"{row['ms_at_plain_shape']:.4f} ms ({row['plain_shape']})")
        report.setdefault("gate_w24", {})[kind] = dict(
            max_abs_err=max(by_width.values()),
            err_shape=f"max over widths {sorted(by_width)}: {by_width}",
            **row)
    phase_library_calls(dev, ops, report)


def lowered_chain(nn):
    """bench.py's chain of nn variables as a QCMRF, with its lowering to
    the [cx, id, rz, sx, x] basis (fused style)."""
    from qcmrf_tpu_torch.circuits.compiler import QCMRF

    theta = -np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3
    q = QCMRF.build([[i, i + 1] for i in range(nn - 1)], theta=theta,
                    with_measurements=False)
    return q, q.lowered(style="fused")


def diff_norm(a, b, chunk=1 << 26) -> float:
    """2-norm of the difference of two pairs of planes, in float64 over
    chunks."""
    total = 0.0
    for x, y in zip(a, b):
        fx, fy = x.view(-1), y.view(-1)
        for s in range(0, fx.numel(), chunk):
            total += float(((fx[s:s + chunk] - fy[s:s + chunk]).double()
                            ** 2).sum())
    return math.sqrt(total)


def phase_lowered_chain(dev, report) -> dict:
    """The main run: bench.py's width-28 chain lowered to basis gates
    through planes.run_statevector, each kernel's launches equal to its op
    kind's count in the stream, the state against the unlowered chain's.
    Then each kernel's ops of that stream alone, timed. Returns the launch
    counts."""
    from qcmrf_tpu_torch.sim import planes

    nq = LOWERED_WIDTH
    q, low = lowered_chain(nq // 2)
    t0 = time.perf_counter()
    ops = planes.fuse_ops(low)
    plan_ms = (time.perf_counter() - t0) * 1e3
    kinds = {}
    for op in ops:
        kinds[op[0]] = kinds.get(op[0], 0) + 1
    print(f"[lowered chain] qcmrf{nq} lowered: {len(low.gates)} basis gates "
          f"-> {len(ops)} passes {kinds}; planner {plan_ms:.1f} ms")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    re, im = planes.run_statevector(low, device=dev)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = start.elapsed_time(end)
    b_ms = stream_bound(ops, nq)["bound_ms"]
    dense_ms = stream_bound(dense_lanes(ops), nq)["bound_ms"]
    lane_ms = sum(bound(0, pass_flops([op], nq))["bound_ms"]
                  for op in dense_lanes(ops) if op[0] == "lane")
    print(f"  qcmrf{nq}_lowered_gate_level_ms {ms:.1f} ({seconds:.3f} s on "
          f"the host clock, planner included); {len(ops)} passes; bound "
          f"{b_ms:.1f} ms with the lane passes counted by their factors "
          f"(bytes); counted as dense products, as before the factored "
          f"pass: {dense_ms:.1f} ms ({dense_ms - lane_ms:.1f} of bytes, "
          f"{lane_ms:.1f} of lane operations); peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}")
    for k, op_kinds in GATE_KERNEL_OPS.items():
        want = sum(kinds.get(o, 0) for o in op_kinds)
        require(launches[k] == want,
                f"kernel {k} launched {launches[k]} times, the stream's "
                f"{'+'.join(op_kinds)} ops: {want}")
    require(launches["lane"] == 0, f"the dense lane kernel launched "
                                   f"{launches['lane']} times (expected 0)")
    want = planes.run_statevector(q.circuit, device=dev)
    d = diff_norm((re, im), want)
    norm = norm_float64(re, im)
    require(d <= 1e-4, f"width {nq}: lowered state == unlowered chain's "
                       f"(global phase included) within 1e-4 in 2-norm "
                       f"({d:.2e}); norm {norm:.7f}")
    del want
    torch.cuda.empty_cache()
    per_kind = {}
    for k, op_kinds in GATE_KERNEL_OPS.items():
        sub = [op for op in ops if op[0] in op_kinds]
        total = cuda_ms(lambda: planes.apply_ops(re, im, sub, nq), reps=1)
        b = stream_bound(sub, nq)
        per_kind[k] = dict(ms=total / len(sub),
                           bound_ms=b["bound_ms"] / len(sub),
                           bound_by=b["bound_by"], total_ms=total,
                           passes=len(sub))
        print(f"  {k}: {len(sub)} passes {total:.1f} ms, "
              f"{per_kind[k]['ms']:.4f} ms a pass, bound "
              f"{per_kind[k]['bound_ms']:.4f} ms")
    del re, im
    torch.cuda.empty_cache()
    report["lowered"] = dict(
        qcmrf28_lowered_gate_level_ms=ms, host_seconds=seconds,
        passes=len(ops), kinds=kinds, gates=len(low.gates), plan_ms=plan_ms,
        bound_ms=b_ms, dense_lane_bound_ms=dense_ms,
        dense_lane_op_bound_ms=lane_ms, peak_bytes=peak,
        diff_norm=d, launches=launches, per_kernel=per_kind)
    return launches


def phase_small_circuits(dev) -> None:
    """At width 20: the per-gate path (apply_gate, one launch a gate) over
    the lowered chain against the fused stream within 1e-5, and random
    circuits over the whole gate set (tests/test_engine_fuzz.py's mix)
    through the fused kernels against the dense engine on the card within
    5e-5."""
    from qcmrf_tpu_torch.circuits.ir import Circuit
    from qcmrf_tpu_torch.sim import dense, planes

    nq = SMALL_WIDTH
    _, low = lowered_chain(nq // 2)
    re, im = planes.zero_planes(nq, dev)
    for g in low.gates:
        planes.apply_gate(re, im, g, nq)
    fused = planes.run_ops(planes.fuse_ops(low), nq, dev)
    e = max(float((a - b).abs().max()) for a, b in zip((re, im), fused))
    require(e <= 1e-5, f"width {nq}: apply_gate over the {len(low.gates)} "
                       f"lowered gates == the fused stream within 1e-5 "
                       f"(max |diff| {e:.2e})")
    del re, im, fused
    for seed in range(3):
        rng = np.random.RandomState(400 + seed)
        c = Circuit(nq)
        for _ in range(80):
            kind = rng.randint(0, 8)
            if kind == 0:
                c.h(rng.randint(nq))
            elif kind == 1:
                c.x(rng.randint(nq))
            elif kind == 2:
                c.sx(rng.randint(nq))
            elif kind == 3:
                c.rz(float(rng.uniform(-np.pi, np.pi)), rng.randint(nq))
            elif kind == 4:
                a, b = rng.choice(nq, 2, replace=False)
                c.cx(int(a), int(b))
            elif kind == 5:
                a, b = rng.choice(nq, 2, replace=False)
                c.cp(float(rng.uniform(-np.pi, np.pi)), int(a), int(b))
            elif kind == 6:
                c.sxdg(rng.randint(nq))
            else:
                m = rng.randint(1, 4)
                qs = rng.choice(nq, m + 1, replace=False)
                flags = [int(f) * 2 - 1 for f in rng.randint(0, 2, m)]
                c.flags_phase([int(x) for x in qs[:m]], flags,
                              float(rng.uniform(-np.pi, np.pi)), int(qs[m]))
        kinds = sorted({op[0] for op in planes.fuse_ops(c)})
        got = torch.complex(*planes.run_statevector(c, device=dev))
        want = dense.run_statevector(c, device=dev)
        e = float((got.reshape(-1) - want).abs().max())
        require(e <= 5e-5, f"fuzz seed {400 + seed} (width {nq}, 80 gates, "
                           f"passes {kinds}): fused kernels == dense engine "
                           f"within 5e-5 (max |diff| {e:.2e})")
    torch.cuda.empty_cache()


#: short chains of x -> x * x - 1.5 held value by value against float64
FMA_CHECK_STEPS = (1, 15, 16)
FMA_CHECK_TOL = 1e-3


def check_fma_chain(K, dev) -> float:
    """fma_peak_kernel against its plain version on inputs whose result
    depends on the number of FMAs. x -> x * x - 1.5 is chaotic on [-1.5,
    0.75]: on 2^20 random x in [-1, 1] a chain of s steps stays within
    1e-3 of the float64 plain version (float32 rounding grows about 1.6x
    a step) while s - 1 or s + 1 steps lie O(1) away, which the check
    asserts of the oracle itself. At the rate run's length the chain on x
    = 0, b = -1 alternates 0 and -1 exactly, so its parity is checked too.
    Returns the largest |kernel - float64| of the short chains."""
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.rand(1 << 20, generator=g, device=dev) * 2 - 1
    out = torch.empty_like(x)
    oracle = [x.double()]
    for _ in range(max(FMA_CHECK_STEPS) + 1):
        oracle.append(oracle[-1] * oracle[-1] - 1.5)
    worst = 0.0
    for s in FMA_CHECK_STEPS:
        top = K.fma_chain_max(x, -1.5, steps=s, out=out)
        err = float((out.double() - oracle[s]).abs().max())
        sep = min(float((oracle[s + d] - oracle[s]).abs().max())
                  for d in (-1, 1))
        require(err <= FMA_CHECK_TOL < sep / 100 and float(top) == float(
            out.max()), f"fma_peak kernel, {s} steps of x*x - 1.5: "
                        f"max |kernel - float64| {err:.2e} (tolerance "
                        f"{FMA_CHECK_TOL}; a step more or fewer moves "
                        f"{sep:.2f}), block max {float(top)}")
        worst = max(worst, err)
    z = torch.zeros(1 << 20, device=dev)
    for s, want in ((K.FMA_CHAIN, 0.0), (K.FMA_CHAIN - 1, -1.0)):
        K.fma_chain_max(z, -1.0, steps=s, out=out)
        require(bool((out == want).all()),
                f"fma_peak kernel, {s} steps from 0 at b = -1: "
                f"all {want}")
    print(f"  fma_peak: chains of {FMA_CHECK_STEPS} steps within "
          f"{worst:.2e} of float64; {K.FMA_CHAIN} and {K.FMA_CHAIN - 1} "
          "steps from 0 at b = -1 give 0 and -1")
    return worst


def phase_rates(dev, report) -> dict:
    """copy_kernel_gbps and gate_apply_gbps at n = 28: the copy kernel's
    path. Returns the launch counts of these chains."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.runners import bench

    n = LOWERED_WIDTH
    reset_counts()
    copy = bench.copy_kernel_gbps(n, dev)
    lane, row = bench.gate_apply_gbps(n, dev)
    tflops = bench.fma_peak_tflops(dev)
    torch.cuda.synchronize()
    launches = read_counts()
    for k, fn in (("copy", "copy_kernel_gbps"), ("fma_peak",
                                                 "fma_peak_tflops")):
        require(launches[k] > 0, f"kernel {k} launched {launches[k]} times "
                                 f"by {fn}")
    rates = dict(copy_kernel_gbps=copy, gate_lane_gbps=lane,
                 gate_row_gbps=row, gate_row_copy_ratio=row / copy,
                 gate_lane_copy_ratio=lane / copy, fma_peak_tflops=tflops)
    print(f"[rates] n={n}: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in rates.items()))
    # the copy kernel and its library call at the rates' shape, in turns
    # (kernel, copy_, copy_, kernel)
    src = unit_planes(n, 5, dev)
    out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
    runs = {"kernel": lambda: K.copy_planes(*src, out=out),
            "copy_": lambda: (out[0].copy_(src[0]), out[1].copy_(src[1]))}
    times = {"kernel": [], "copy_": []}
    for name in ("kernel", "copy_", "copy_", "kernel"):
        times[name].append(cuda_ms(runs[name], reps=10))
    ms, lib = (sum(times[k]) / 2 for k in ("kernel", "copy_"))
    del src, out, runs
    torch.cuda.empty_cache()
    print(f"  copy kernel {ms:.4f} ms, planes' copy_ {lib:.4f} ms at 2^{n} "
          f"values (in turns: {times})")
    report["rates"] = rates
    report["copy_w28"] = dict(ms=ms, library_ms=lib,
                              shape=f"2^{n} values, both planes",
                              **bound(16 << n, 0))
    err = check_fma_chain(K, dev)
    # the rate run's chain on bench.py's array of ones, and its plain time
    x = torch.ones(bench.FMA_VALUES, dtype=torch.float32, device=dev)
    got = float(K.fma_chain_max(x))
    want, plain_ms = timed_once(lambda: K.fma_chain_max_reference(x))
    require(got == float(want) == 1.0,
            f"fma_peak kernel on ones: max {got}, plain {float(want)}")
    ms = cuda_ms(lambda: K.fma_chain_max(x), reps=10)
    flops = 2 * K.FMA_CHAIN * bench.FMA_VALUES
    print(f"  fma_peak: {tflops:.3f} TFLOP/s float32 (data sheet 67); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms for {bench.FMA_VALUES} "
          f"values")
    report["fma_peak"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              tflops=flops / (ms * 1e-3) / 1e12,
                              **bound(4 * bench.FMA_VALUES, flops),
                              shape=f"({512 * 512}, 128) float32 ones, "
                                    f"{K.FMA_CHAIN} FMAs a value",
                              err_shape=f"2^20 values in [-1, 1], "
                                        f"{FMA_CHECK_STEPS} steps of "
                                        "x*x - 1.5 against float64")
    del x
    torch.cuda.empty_cache()
    return launches


def gate_entry(kind, report, launches) -> dict:
    """A generic gate kernel's line: its mean time and bound per launch in
    the lowered width-28 main run (the copy: at the rates' width 28; the
    dense lane kernel, which the main run no longer launches: at width
    28 on the 7-H wall), its plain version at width 24."""
    w24 = report["gate_w24"][kind]
    if kind in ("copy", "lane"):
        row = report[f"{kind}_w28"]
        return dict(launches=launches, ms=row["ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"],
                    shape=row["shape"], **w24)
    run = report["lowered"]["per_kernel"][kind]
    return dict(launches=launches, ms=run["ms"], bound_ms=run["bound_ms"],
                bound_by=run["bound_by"],
                library_ms=report.get(f"{kind}_library_ms"),
                shape=f"mean per launch over the {run['passes']} passes of "
                      f"the lowered width-{LOWERED_WIDTH} chain "
                      f"({run['total_ms']:.1f} ms in all)", **w24)


REPLACES = {
    "sampler": "qcmrf_tpu/ops/sampler_kernel.py:37",
    "logpot": "qcmrf_tpu/ops/kernels.py:239",
    "lse": "qcmrf_tpu/ops/kernels.py:514",
    "map": "qcmrf_tpu/ops/kernels.py:570",
    "moments": "qcmrf_tpu/ops/kernels.py:817",
    "lnz_moments": "qcmrf_tpu/ops/kernels.py:913",
    "hdh_multi": "qcmrf_tpu/ops/kernels.py:1895",
    "hdh_multi_uniform": "qcmrf_tpu/ops/kernels.py:1895",
    "circuit": "qcmrf_tpu/ops/circuit_kernel.py:108",
    "lane_factored": "qcmrf_tpu/ops/kernels.py:1046",
    "lane": "qcmrf_tpu/ops/kernels.py:1046",
    "row_gate": "qcmrf_tpu/ops/kernels.py:1128",
    "diag": "qcmrf_tpu/ops/kernels.py:1340",
    "copy": "qcmrf_tpu/runners/bench.py:177",
    "fma_peak": "bench.py:405",
}
ALSO_REPLACES = {
    "hdh_multi": ["qcmrf_tpu/ops/kernels.py:1477 (at k=1)",
                  "qcmrf_tpu/ops/kernels.py:1675 (at k=2)"],
    "row_gate": ["qcmrf_tpu/ops/kernels.py:1176 (at K=2)"],
    "diag": ["qcmrf_tpu/ops/kernels.py:1275 (at one term)"],
}
SOURCES = {
    "sampler": "qcmrf_kernels.cu", "logpot": "qcmrf_kernels.cu",
    "lse": "qcmrf_kernels.cu", "map": "qcmrf_kernels.cu",
    "moments": "qcmrf_kernels.cu", "lnz_moments": "qcmrf_kernels.cu",
    "hdh_multi": "circuit_kernels.cu",
    "hdh_multi_uniform": "circuit_kernels.cu",
    "circuit": "circuit_kernels.cu",
    "lane_factored": "gate_kernels.cu", "lane": "gate_kernels.cu",
    "row_gate": "gate_kernels.cu",
    "diag": "gate_kernels.cu", "copy": "gate_kernels.cu",
    "fma_peak": "gate_kernels.cu",
}


#: sandwich kernel -> (its passes in the width-32 chain, its width-24
#: cases whose plain versions are timed, its width-24 cases held against
#: their plain versions)
SANDWICH_PARTS = {
    "hdh_multi": (("sandwichk", "sandwich"), ("hdh_multi", "hdh_single"),
                  ("hdh_single", "hdh_pair", "hdh_multi")),
    "hdh_multi_uniform": (("sandwichku",), ("hdh_multi_uniform",),
                          ("hdh_multi_uniform",)),
}


def sandwich_entry(name, report) -> dict:
    """A sandwich kernel's line: the summed time and bound of its passes
    at the width-32 main path's shape; its plain version, held against
    it, at width 24 on the same k."""
    passes, timed, held = SANDWICH_PARTS[name]
    w32 = [report["pass_w32"][p] for p in passes]
    w24 = [report["sandwich_w24"][c] for c in timed]
    by = {e["bound_by"] for e in w32}
    return dict(
        max_abs_err=max(report["sandwich_w24"][c]["max_abs_err"]
                        for c in held),
        ms=sum(e["ms"] for e in w32),
        plain_ms=sum(e["plain_ms"] for e in w24),
        bound_ms=sum(e["bound_ms"] for e in w32),
        bound_by=by.pop() if len(by) == 1 else "bytes and operations",
        shape=f"its passes {list(passes)} of the width-32 chain (2^32 "
              "values), summed",
        plain_shape="; ".join(e["shape"] for e in w24),
        ms_at_plain_shape=sum(e["ms"] for e in w24),
        bound_ms_at_plain_shape=sum(e["bound_ms"] for e in w24))


KERNEL_NAMES = ("sampler_kernel", "logpot_kernel", "lse_kernel",
                "map_kernel", "moments_kernel", "lnz_moments_kernel",
                "hdh_multi_kernel", "hdh_multi_uniform_kernel",
                "circuit_kernel", "diag_kernel", "row_gate_kernel",
                "lane_kernel", "lane_factored_kernel", "copy_kernel",
                "fma_peak_kernel")


def print_ptxas(path) -> None:
    """Registers and spills of every kernel, from the build's ptxas
    report (a mangled name carries its length before it)."""
    name = None
    for line in (path.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in KERNEL_NAMES
                         if f"{len(k)}{k}" in line), None)
            m = re.search(r"ILi(\d+)E", line)
            if name and m:
                name += f"<{m.group(1)}>"
        elif name and ("registers" in line or "spill" in line):
            print(f"  ptxas {name}: "
                  + line.replace("ptxas info    :", "").strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    from qcmrf_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    path, build_s = _build.build()
    _build.library()
    root = os.path.dirname(os.path.abspath(__file__))
    print(f"[build] {path.relative_to(root)} in {build_s:.1f} s "
          f"({len(_build.sources())} sources in parallel)")
    print_ptxas(path)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)

    report = {}
    phase_sampler(dev, report)
    phase_logpot(dev, report)
    phase_lnz(dev, report)
    phase_suite_shapes(dev)
    launches = phase_main_path(dev, "analytic", {
        "sampler": None, "logpot": None, "lse": None})
    phase_circuit_kernel(dev, report)
    sv = phase_main_path(dev, "statevector", {
        "circuit": 7, "logpot": None, "lse": None})
    infer = phase_infer(dev, report)
    train = phase_train(dev, report)
    phase_sandwich_kernels(dev, report)
    phase_gate_level(dev, report)
    gate = report["main_gate_level"]
    phase_gate_kernels(dev, report)
    lowered = phase_lowered_chain(dev, report)
    phase_small_circuits(dev)
    rates = phase_rates(dev, report)

    kernels_line = []
    for k in ("sampler", "logpot", "lse"):
        kernels_line.append(dict(launches=launches[k], library_ms=None,
                                 **report[k]))
    for k in ("hdh_multi", "hdh_multi_uniform"):
        kernels_line.append(dict(launches=gate[k], library_ms=None,
                                 **sandwich_entry(k, report)))
    kernels_line.append(dict(launches=sv["circuit"], library_ms=None,
                             **report["circuit"]))
    for k in ("map", "moments"):
        kernels_line.append(dict(launches=infer[k], library_ms=None,
                                 **report[k]))
    # no single PyTorch call computes the fused sweep or the FMA chain
    kernels_line.append(dict(launches=train["lnz_moments"], library_ms=None,
                             **report["lnz_moments"]))
    for k in ("lane_factored", "lane", "row_gate", "diag"):
        kernels_line.append(gate_entry(k, report, lowered[k]))
    kernels_line.append(gate_entry("copy", report, rates["copy"]))
    kernels_line.append(dict(launches=rates["fma_peak"], library_ms=None,
                             **report["fma_peak"]))
    for k, entry in zip(("sampler", "logpot", "lse", "hdh_multi",
                         "hdh_multi_uniform", "circuit", "map", "moments",
                         "lnz_moments", "lane_factored", "lane", "row_gate",
                         "diag", "copy",
                         "fma_peak"), kernels_line):
        entry.update(name=k, route="cuda",
                     source=f"qcmrf_tpu_torch/csrc/{SOURCES[k]}",
                     replaces=REPLACES[k])
        if k in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[k]
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels_line, **{
            k: v for k, v in report.items()
            if k in ("gate_level", "gate_plain_width", "sandwich_w24",
                     "pass_w32", "infer_k27_batch_s",
                     "infer_k27_query_s", "gate_w24", "lowered", "rates",
                     "copy_w28", "lane_w28", "lane_library_ms",
                     "lane_factored_library_ms", "row_gate_library_ms",
                     "row_library_by_qubit", "train", "fma_peak")}), f,
                  indent=1, default=str)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
