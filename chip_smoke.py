"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``qcmrf_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version on the card at the main path's
shapes, times both, and then drives the port's main path once: the
``run`` command samples the 70-circuit suite (scale 0.1, 10 000 shots) and
the ``eval`` command scores it, both on the GPU, with the kernels' launch
counters reset just before. Every failed check raises, so the exit code
is non-zero. The second-to-last line is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where PyTorch sees no CUDA device.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SAMPLE_SEED = 1234
N_SHOTS_CHECK = 1 << 20      # kernel vs plain version, all four modes
N_SHOTS_RATE = 1 << 27       # bench.py's operating point: 1 GiB of outputs


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
    report["sampler"] = dict(
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
        report["logpot"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                shape=f"(1, 2^{mrf.n}) table, grid "
                                      f"{rows}x{cols}")
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
    report["lse"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
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


def phase_main_path(dev):
    from qcmrf_tpu_torch.ops import kernels, sampler_kernel as sk
    from qcmrf_tpu_torch.runners import eval as run_eval
    from qcmrf_tpu_torch.runners import run_experiment

    counters = (sk.LAUNCHES, kernels.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        run_experiment.main([
            "--scale", "0.1", "--shots", "10000", "--platform", "gpu",
            "--sample-seed", "0", "--outdir", os.path.join(tmp, "res_0.1"),
            "--res-root", tmp])
        results = run_eval.main([
            "--results", "result_analytic_0.1.json", "--scale", "0.1",
            "--res-root", tmp, "--platform", "gpu", "--kl"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {**sk.LAUNCHES, **kernels.LAUNCHES}
    print(f"[main path] run + eval of 70 circuits on the GPU: "
          f"{seconds:.2f} s; launches {launches}")
    require(len(results) == 7, "7 graphs evaluated")
    for r in results:
        require(r.mean_f >= 0.99, f"graph {r.graph}: mean fidelity "
                                  f"{r.mean_f:.4f} >= 0.99")
        worst = max(abs(a - b) for a, b in zip(r.successes, r.exact_deltas))
        require(worst <= 0.02, f"graph {r.graph}: |delta-hat - delta| "
                               f"<= 0.02 (worst {worst:.4f})")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} launched {count} times")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    from qcmrf_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    path, build_s = _build.build()
    _build.library()
    root = os.path.dirname(os.path.abspath(__file__))
    print(f"[build] {path.relative_to(root)} in {build_s:.1f} s")
    for line in (path.parent / "nvcc.log").read_text().splitlines():
        names = [k for k in ("sampler_kernel", "logpot_kernel",
                             "lse_kernel") if k in line]
        if "Compiling entry function" in line and names:
            print(f"  ptxas {names[0]}:")
        elif "registers" in line or "spill" in line:
            print("    " + line.replace("ptxas info    :", "").strip())
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
    launches = phase_main_path(dev)

    replaces = {"sampler": "qcmrf_tpu/ops/sampler_kernel.py:37",
                "logpot": "qcmrf_tpu/ops/kernels.py:239",
                "lse": "qcmrf_tpu/ops/kernels.py:514"}
    kernels_line = [
        dict(name=k, route="cuda",
             source="qcmrf_tpu_torch/csrc/qcmrf_kernels.cu",
             replaces=replaces[k], launches=launches[k], **report[k])
        for k in ("sampler", "logpot", "lse")
    ]
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
