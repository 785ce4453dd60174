"""Times the plane engine's host-bound paths in one source tree, so that two
trees, or two ways of uploading the kernels' tables, can be compared in
one session on one card (run the variants as A, B, B, A).

    python3 qcmrf_tpu_torch/runners/host_ab.py sandwich24 [--root DIR]
    python3 qcmrf_tpu_torch/runners/host_ab.py lowered28 [--sync-upload]
    python3 qcmrf_tpu_torch/runners/host_ab.py streaming27 [--root DIR]
    python3 qcmrf_tpu_torch/runners/host_ab.py lane_circuit [--root DIR]
    python3 qcmrf_tpu_torch/runners/host_ab.py gibbs [--root DIR]

``sandwich24`` runs ``chip_smoke.py``'s width-24 sandwich cases (k = 1, 2
and 7, and the write-only k = 7 form: each held against its plain version,
then timed by CUDA events) with the ``qcmrf_tpu_torch`` package found
under ``DIR`` (default: this checkout), so an older tree unpacked there is
timed by the same code. ``lowered28`` runs bench.py's qcmrf28 chain
lowered to basis gates through ``planes.run_statevector`` twice, timed by
CUDA events and by the host clock; ``--sync-upload`` sends every term and
matrix table up with a plain ``.to(device)``, which waits for the card,
in place of the pinned, non-blocking upload. ``streaming27`` times, with
the package under ``DIR``, the streaming lnZ sweeps where their main paths
run them: the lse sweep at n = 28 (grid 4x7) and on bench.py's K27, the
fused lnZ + moments sweep on K27 (CUDA events, 5 calls after a warm-up),
one exact-MLE step on K27 (``train_wide_k27_step_ms``), the streaming
argmax on K27, the K27 log-potential table (2^27 states), the K27
moments for a given lnZ (379 monomials), ``sample_exact``'s 20 000 draws
on K27, the outcome sampler at bench.py's operating point (the n=20 grid,
2^27 shots, parts mode; the tree's own keep-probability table), and the
K27 ``infer`` batch of ``chip_smoke.py`` through
``infer_cli.main`` (host clock, the second of two runs). ``lane_circuit``
times, with the package under ``DIR``, the dense lane pass at width 28 on
``chip_smoke.py``'s random M (CUDA events, 5 passes after a warm-up), the
suite's 70 gate-level circuits (one ``batched_circuits_probs`` call
where the package has it, else one ``batched_circuit_probs`` call a
graph; CUDA events around the calls, so the host's share counts) and
``run_suite(engine="statevector")`` at 10 000 shots (host clock, 10 runs
after two warm-ups: the two middle values and every run). ``gibbs``
times, with the package under ``DIR``, the chain kernel where its main
paths run it: one K27 chain of 2 000 samples at thin 10, burn 100
(``train``'s; CUDA events, 3 calls after a warm-up), the suite's 70
chains at ``eval --mode gibbs``'s 10 000 samples, thin 10, burn 10 (one
``gibbs_chains_multi`` call where the package has it, else one
``gibbs_chains`` call a graph; CUDA events, 3 calls after a warm-up), and
``evaluate_suite(mode="gibbs")`` at 10 000 samples (host clock, 5 runs
after a warm-up: the middle value and every run). Prints one JSON
line. Needs a CUDA device; the script file is run by its path, not with
``-m``.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sync_upload(K) -> None:
    """Replace the kernels' table upload with a synchronous copy from
    pageable memory."""
    import torch

    @functools.lru_cache(maxsize=64)
    def device_bytes(blob: bytes, device):
        return torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device)

    K._device_bytes = device_bytes


def _streaming27(smoke, K, dev) -> dict:
    """Milliseconds of the streaming lnZ sweeps, the K27 step, the argmax,
    the sampler and the K27 infer batch (see the module docstring)."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from qcmrf_tpu_torch.models import sample
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import sampler_kernel as S
    from qcmrf_tpu_torch.runners import infer_cli
    from qcmrf_tpu_torch.utils import moebius

    cliques = smoke.complete_cliques(smoke.INFER_N)
    k27 = MRF.create(cliques, theta=smoke.k27_theta(), device=dev)
    ms = {}
    for what, m in (("lse_n28", smoke.grid_model(4, 7, 2, dev)),
                    ("lse_k27", k27)):
        coef = K.moebius_coefficients(m)[None]
        ms[what] = smoke.cuda_ms(
            lambda: K.lse_partials(m.cliques, m.n, coef, m.beta), reps=5)
    coef = K.moebius_coefficients(k27)[None]
    masks = moebius.device_masks(k27.cliques, k27.n, dev)
    ms["lnz_moments_k27"] = smoke.cuda_ms(lambda: K.lnz_moments_partials(
        k27.cliques, k27.n, coef, k27.beta, masks), reps=5)
    raw = mtrain._from_theta(k27.theta, True).requires_grad_()
    step = mtrain.make_moment_train_step(k27, mtrain.adam([raw], 5e-2),
                                         smoke.k27_mu_hat())
    ms["train_wide_k27_step"] = smoke.cuda_ms(step, reps=5)
    ms["map_k27"] = smoke.cuda_ms(lambda: K.map_partials(
        k27.cliques, k27.n, coef, k27.beta), reps=5)
    ms["table_k27"] = smoke.cuda_ms(lambda: K.logpot_table(
        k27.cliques, k27.n, coef, k27.beta), reps=5)
    lnz = K.combine_lse(*K.lse_partials(k27.cliques, k27.n, coef,
                                        k27.beta)).float()
    ms["moments_k27"] = smoke.cuda_ms(lambda: K.monomial_moments(
        k27.cliques, k27.n, coef, k27.beta, lnz, masks), reps=5)
    ms["sample_exact_k27"] = smoke.cuda_ms(lambda: sample.sample_exact(
        11, k27, smoke.TRAIN_SAMPLES), reps=3)
    torch.cuda.empty_cache()
    grid = smoke.grid_model(4, 5, 0, dev)
    table = getattr(S, "keep_prob_values", S.keep_prob_table)(
        grid.cliques, grid.n, grid.theta, grid.beta)[None]
    ms["sampler_n20_parts"] = smoke.cuda_ms(lambda: S.sample_call(
        smoke.SAMPLE_SEED, grid.cliques, grid.n, table, smoke.N_SHOTS_RATE,
        "parts"), reps=5)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("g.json", "t.json",
                                                "q.jsonl")]
        for path, text in zip(paths, (
                json.dumps(cliques), json.dumps(smoke.k27_theta().tolist()),
                "\n".join(json.dumps(q) for q in smoke.INFER_QUERIES))):
            with open(path, "w") as f:
                f.write(text)
        argv = ["--graph", paths[0], "--theta", paths[1], "--queries",
                paths[2], "--platform", "gpu"]
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                infer_cli.main(argv)
            torch.cuda.synchronize()
            ms["infer_k27_batch"] = (time.perf_counter() - t0) * 1e3
    return ms


def _lane_circuit(smoke, K, dev) -> dict:
    """Milliseconds of the dense lane pass at width 28 and of the suite's
    gate-level circuits (see the module docstring)."""
    import torch

    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.ops import circuit_kernel as ck
    from qcmrf_tpu_torch.runners import run_experiment

    M = next(c[4][0] for c in smoke.gate_cases(smoke.GATE_PASS_WIDTH)
             if c[1] == "lane, random complex M")
    re, im = smoke.unit_planes(smoke.LOWERED_WIDTH, 9, dev)
    ms = {"lane_w28": smoke.cuda_ms(lambda: K.apply_lane(re, im, M),
                                    reps=5)}
    del re, im
    torch.cuda.empty_cache()
    suite = generate_suite(0.1)
    problems = [(C, suite.thetas[j]) for j, C in enumerate(suite.graphs)]
    if hasattr(ck, "batched_circuits_probs"):
        ms["suite70_gate_level"] = smoke.cuda_ms(
            lambda: ck.batched_circuits_probs(problems, device=dev), reps=50)
    else:
        ms["suite70_gate_level"] = smoke.cuda_ms(
            lambda: [ck.batched_circuit_probs(C, t, device=dev)
                     for C, t in problems], reps=50)
    runs = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_experiment.run_suite(suite, shots=10000, engine="statevector",
                                 device=dev)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    ms["run_suite_statevector"] = sorted(runs[2:])[4:6]
    ms["run_suite_statevector_runs"] = runs[2:]
    return ms


def _gibbs(smoke, dev) -> dict:
    """Milliseconds of the chain kernel's main-path calls (see the module
    docstring)."""
    import numpy as np
    import torch

    from qcmrf_tpu_torch.evaluation import harness
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk

    cl = tuple(tuple(c) for c in smoke.complete_cliques(smoke.INFER_N))
    theta = torch.from_numpy(smoke.k27_theta()).to(dev)[None].contiguous()
    ms = {"k27_chain": smoke.cuda_ms(lambda: gk.gibbs_chains(
        9, cl, smoke.INFER_N, theta, 1.0, *smoke.K27_CHAIN), reps=3)}
    suite = generate_suite(0.1)
    models = [(tuple(tuple(v) for v in C), max(v for c in C for v in c) + 1,
               torch.tensor(np.asarray(suite.thetas[j], np.float32),
                            device=dev))
              for j, C in enumerate(suite.graphs)]
    shape = (smoke.EVAL_SAMPLES, 10, 10)
    if hasattr(gk, "gibbs_chains_multi"):
        ms["suite_chains"] = smoke.cuda_ms(
            lambda: gk.gibbs_chains_multi(0, models, 1.0, *shape), reps=3)
    else:
        ids = np.cumsum([0] + [m[2].shape[0] for m in models])
        ms["suite_chains"] = smoke.cuda_ms(lambda: [
            gk.gibbs_chains(0, *m, 1.0, *shape,
                            chain_ids=range(ids[j], ids[j + 1]))
            for j, m in enumerate(models)], reps=3)
    runs = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        harness.evaluate_suite(suite, mode="gibbs",
                               num_samples=smoke.EVAL_SAMPLES, device=dev)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    ms["eval_gibbs"] = sorted(runs[1:])[2]
    ms["eval_gibbs_runs"] = runs[1:]
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=("sandwich24", "lowered28",
                                     "streaming27", "lane_circuit", "gibbs"))
    ap.add_argument("--root", type=Path, default=CHECKOUT,
                    help="tree whose qcmrf_tpu_torch package is timed")
    ap.add_argument("--sync-upload", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from qcmrf_tpu_torch.ops import _build, kernels as K
    if not torch.cuda.is_available():
        print("host_ab: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    if args.sync_upload:
        _sync_upload(K)
    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    _build.build()
    _build.library()
    out = dict(case=args.case, package=str(Path(K.__file__).parents[1]),
               sync_upload=args.sync_upload)
    if args.case == "sandwich24":
        report = {}
        smoke.phase_sandwich_kernels(dev, report)
        out["ms"] = {k: v["ms"] for k, v in report["sandwich_w24"].items()}
    elif args.case == "streaming27":
        out["ms"] = _streaming27(smoke, K, dev)
    elif args.case == "lane_circuit":
        out["ms"] = _lane_circuit(smoke, K, dev)
    elif args.case == "gibbs":
        out["ms"] = _gibbs(smoke, dev)
    else:
        from qcmrf_tpu_torch.sim import planes

        _, low = smoke.lowered_chain(smoke.LOWERED_WIDTH // 2)
        runs = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            re, im = planes.run_statevector(low, device=dev)
            end.record()
            torch.cuda.synchronize()
            runs.append(dict(ms=start.elapsed_time(end),
                             host_s=time.perf_counter() - t0))
            del re, im
        out["runs"] = runs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
