"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``qcmrf_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version on the card at the main paths'
shapes, times both, and drives the port's three main paths, each with the
kernels' launch counters reset just before it and read just after:

* ``run`` (analytic engine) samples the 70-circuit suite (scale 0.1,
  10 000 shots) and ``eval`` scores it, both on the GPU;
* ``run --engine statevector`` runs the 70 gate-level circuits through the
  whole-circuit kernel (one launch per graph) and ``eval`` scores them;
* the plane engine runs the 16-variable QCMRF chain at 32 qubits (three
  fused sandwich passes over 32 GiB of planes, in place), checked against
  the post-selected amplitudes of the log-potential kernel.

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


def phase_lnz(dev, report):
    from qcmrf_tpu_torch.ops import kernels

    mrf = grid_model(4, 7, 2, dev)
    coef = kernels.moebius_coefficients(mrf)[None]
    args = (mrf.cliques, mrf.n, coef, mrf.beta)
    lnz = float(kernels.combine_lse(*kernels.lse_partials(*args))[0])
    table = kernels.logpot_table(*args)[0]
    from_table = float(torch.logsumexp(table, dim=0))
    del table
    torch.cuda.empty_cache()
    print(f"[lnZ] n=28 grid 4x7: lse kernel {lnz:.6f}, logsumexp of the "
          f"table kernel {from_table:.6f}")
    require(abs(lnz - from_table) <= 1e-4,
            "lse kernel == torch.logsumexp(log-potential table) within 1e-4")
    plain = float(kernels.combine_lse(
        *kernels.lse_partials_reference(*args))[0])
    err = abs(lnz - plain)
    require(err <= 1e-4, f"lse kernel == plain version within 1e-4 "
                         f"({err:.3e})")
    ms = cuda_ms(lambda: kernels.lse_partials(*args), reps=10)
    plain_ms = cuda_ms(lambda: kernels.lse_partials_reference(*args), reps=2)
    print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms for 2^28 states")
    torch.cuda.empty_cache()
    # per state: the chains, beta, and the running max/exp/sum (the exp
    # counted as one operation); device memory sees only the partials
    report["lse"] = dict(
        **bound(8 * kernels.lse_geometry(1 << mrf.n)[0],
                (chain_flops(mrf.cliques) + 5) << mrf.n),
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape="(1, 2^28) states, grid 4x7")


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


def pass_flops(ops, nq) -> int:
    total = 0
    for op in ops:
        k = (len(op[3]) if op[0] == "sandwichku" else
             1 if op[0] == "sandwich" else len(op[2]))
        total += (6 * k + 6) << nq
    return total


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


REPLACES = {
    "sampler": "qcmrf_tpu/ops/sampler_kernel.py:37",
    "logpot": "qcmrf_tpu/ops/kernels.py:239",
    "lse": "qcmrf_tpu/ops/kernels.py:514",
    "hdh_multi": "qcmrf_tpu/ops/kernels.py:1895",
    "hdh_multi_uniform": "qcmrf_tpu/ops/kernels.py:1895",
    "circuit": "qcmrf_tpu/ops/circuit_kernel.py:108",
}
SOURCES = {
    "sampler": "qcmrf_kernels.cu", "logpot": "qcmrf_kernels.cu",
    "lse": "qcmrf_kernels.cu",
    "hdh_multi": "circuit_kernels.cu",
    "hdh_multi_uniform": "circuit_kernels.cu",
    "circuit": "circuit_kernels.cu",
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
                "hdh_multi_kernel", "hdh_multi_uniform_kernel",
                "circuit_kernel")


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
    phase_sandwich_kernels(dev, report)
    phase_gate_level(dev, report)
    gate = report["main_gate_level"]

    kernels_line = []
    for k in ("sampler", "logpot", "lse"):
        kernels_line.append(dict(launches=launches[k], library_ms=None,
                                 **report[k]))
    for k in ("hdh_multi", "hdh_multi_uniform"):
        kernels_line.append(dict(launches=gate[k], library_ms=None,
                                 **sandwich_entry(k, report)))
    kernels_line.append(dict(launches=sv["circuit"], library_ms=None,
                             **report["circuit"]))
    for k, entry in zip(("sampler", "logpot", "lse", "hdh_multi",
                         "hdh_multi_uniform", "circuit"), kernels_line):
        entry.update(name=k, route="cuda",
                     source=f"qcmrf_tpu_torch/csrc/{SOURCES[k]}",
                     replaces=REPLACES[k])
    kernels_line[3]["also_replaces"] = [
        "qcmrf_tpu/ops/kernels.py:1477 (at k=1)",
        "qcmrf_tpu/ops/kernels.py:1675 (at k=2)"]
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels_line, **{
            k: v for k, v in report.items()
            if k in ("gate_level", "gate_plain_width", "sandwich_w24",
                     "pass_w32")}), f, indent=1, default=str)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
