"""Micro-benchmarks on the card (port of :mod:`qcmrf_tpu.runners.bench`
and of the measurable part of the root ``bench.py``).

``python -m qcmrf_tpu_torch bench [--n 20] [--shots S] [--trace DIR]
[--json]`` (:func:`main`) prints JAX's ``bench`` keys, measured on the
current CUDA device: the sampler's shots/s (``sampler_shots_per_sec``,
parts mode, the n-variable grid), the log-potential table
(``logpot_ms``, ``logpot_write_gbps``), lnZ (``lnZ_ms``), the lane and row
gate rates (``gate_bw_n`` = max(n, 24), ``gate_lane_gbps``,
``gate_row_gbps``) and the 70 gate-level suite circuits in one call
(``suite70_gate_level_ms``); ``backend`` is the card's name and
``power_limit`` its limit. ``--trace DIR`` runs one sampler call under
:func:`qcmrf_tpu_torch.utils.profiling.trace` and adds ``trace_dir``
and that call's device busy and idle share, with its idle time by
program span (``trace``). The shots default
to 2^27. A section that fails raises, so the command exits non-zero
(the root ``bench.py`` writes ``*_error`` keys and exits 0). JAX's
``lane_precision_study`` (the MXU's bf16 pass counts) is TPU-only.

:func:`record` measures the root ``bench.py``'s keys that the port can
measure, each afresh, as one dict (``RECORD_KEYS``). Left out, each for
its reason (``RECORD_LEFT_OUT``):

* ``lane_*`` (the MXU precision study), ``mxu_peak_tflops`` and the
  ``*_flops_util`` keys against the MXU (``lnZ_n28_flops_util``,
  ``moments_k24_flops_util``): TPU-only;
* ``vpu_peak_tflops``: the TPU's vector unit; ``fma_peak_tflops`` (row 18,
  ``fma_peak_kernel``) takes its place, and ``sampler_ceiling_flops_util``
  is held against it;
* ``kl_suite_max_10k_shots_reference_floor``: it reads the reference's
  stored result files, which this repository does not hold.

``kl_suite_max_10k_shots`` is ``{"mean", "spread", "seeds"}`` over three
sampling seeds (the mean, the largest minus the smallest, and each).

The rates beneath them:

* :func:`copy_kernel_gbps`: ``copy_kernel`` reading and writing both
  planes, the bytes of a read-write gate pass and no arithmetic;
* :func:`gate_apply_gbps`: chained Hadamards on a lane qubit (3, the
  ``lane_factored_kernel``) and on a row qubit (n - 2,
  ``row_gate_kernel<1>``);
* :func:`fma_peak_tflops`: ``fma_peak_kernel``, 1024 chained float32
  FMAs on every value of a (512 * 512, 128) array, the float32 rate the
  compute-bound kernels are held against (``bench.py``'s ``_vpu_kern``).

The ratio of a gate rate to the copy rate of the same run is the gate
pass's cost beyond its bytes. Each rate is timed with CUDA events around a
chain of passes on planes of the card, after one warm-up chain; a CPU
device raises, since these are rates of the card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from qcmrf_tpu_torch.ops import kernels
from qcmrf_tpu_torch.sim.dense import GATES_1Q
from qcmrf_tpu_torch.utils.config import resolve_device

#: passes per timed chain
PASS_CHAIN = 32


def _pass_ms_to_gbps(pass_ms: float, n: int, traversals: int = 4) -> float:
    """Effective GB/s of a pass moving ``traversals`` float32 planes of
    ``2**n`` values."""
    return traversals * (1 << n) * 4 / (pass_ms * 1e-3) / 1e9


def _card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"rates are measured on a CUDA device, not "
                         f"{device}")
    return device


def _chain_pass_ms(step: Callable[[int], None], device,
                   passes: int = PASS_CHAIN, reps: int = 3) -> float:
    """Milliseconds per pass of ``step(i)`` over ``reps`` chains of
    ``passes`` calls, by CUDA events, after one warm-up chain."""
    with torch.cuda.device(device):
        for i in range(passes):
            step(i)
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps * passes):
            step(i)
        end.record()
        torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (reps * passes)


def _random_planes(n: int, device):
    g = torch.Generator(device=device).manual_seed(n)
    shape = kernels.plane_shape(n)
    return (torch.randn(shape, generator=g, device=device),
            torch.randn(shape, generator=g, device=device))


def copy_kernel_gbps(n: int, device=None) -> float:
    """Effective GB/s of ``copy_kernel`` on planes of ``2**n`` values:
    both planes read and written each pass, chained between two pairs of
    planes. ``device`` is the current CUDA device unless one is named."""
    device = _card(device)
    pairs = (_random_planes(n, device), _random_planes(n, device))

    def step(i):
        kernels.copy_planes(*pairs[i % 2], out=pairs[1 - i % 2])

    return _pass_ms_to_gbps(_chain_pass_ms(step, device), n)


def gate_apply_gbps(n: int, device=None) -> tuple:
    """``(lane_gbps, row_gbps)``: effective rates of chained Hadamards on
    qubit 3 (``lane_factored_kernel``) and on qubit ``n - 2``
    (``row_gate_kernel<1>``), in place on planes of ``2**n`` values (n >=
    9). ``device`` is the current CUDA device unless one is named."""
    device = _card(device)
    re, im = _random_planes(n, device)
    H = GATES_1Q["h"]
    lane = _chain_pass_ms(lambda i: kernels.apply_1q(re, im, H, 3, n), device)
    row = _chain_pass_ms(lambda i: kernels.apply_1q(re, im, H, n - 2, n),
                         device)
    return _pass_ms_to_gbps(lane, n), _pass_ms_to_gbps(row, n)


#: bench.py's compute-peak array: (512 * 512, 128) float32 values
FMA_VALUES = 512 * 512 * 128


def fma_peak_tflops(device=None, reps: int = 10) -> float:
    """Float32 TFLOP/s of ``fma_peak_kernel``: ``kernels.FMA_CHAIN``
    chained FMAs (2 operations each) on every one of ``FMA_VALUES`` ones,
    reduced on the card to one max, timed by CUDA events over ``reps``
    launches after one warm-up. ``device`` is the current CUDA device
    unless one is named."""
    device = _card(device)
    x = torch.ones(FMA_VALUES, dtype=torch.float32, device=device)
    ms = _chain_pass_ms(lambda i: kernels.fma_chain_max(x), device,
                        passes=reps, reps=1)
    return 2 * kernels.FMA_CHAIN * FMA_VALUES / (ms * 1e-3) / 1e12


# --------------------------------------------------------------------------
# The bench command and the root bench.py's record
# --------------------------------------------------------------------------

#: the root bench.py's keys (BENCH_r05.json) that record() leaves out, and
#: why
RECORD_LEFT_OUT = {
    **{k: "TPU-only: the MXU's bf16 lane-precision study" for k in (
        "lane_default_gbps", "lane_high_gbps", "lane_highest_gbps",
        "lane_default_err", "lane_high_err", "lane_default_copy_ratio",
        "lane_high_copy_ratio", "lane_highest_copy_ratio")},
    "mxu_peak_tflops": "TPU-only: the MXU's bf16 matmul peak",
    "lnZ_n28_flops_util": "TPU-only: held against the MXU peak",
    "moments_k24_flops_util": "TPU-only: held against the MXU peak",
    "vpu_peak_tflops": "the TPU's vector unit: fma_peak_tflops in its place",
    "kl_suite_max_10k_shots_reference_floor": "reads the reference's "
                                              "stored result files, which "
                                              "this repository lacks",
}

#: the keys of record(), in its order
RECORD_KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "sampler_no_output_shots_per_sec", "sampler_flags_shots_per_sec",
    "sampler_write_cost_pct", "sampler_headline_vs_ceiling_pct",
    "device_kind", "gate_bw_n", "gate_lane_gbps", "gate_row_gbps",
    "copy_kernel_gbps", "gate_lane_copy_ratio", "gate_row_copy_ratio",
    "fma_peak_tflops", "sampler_ceiling_fma_gflops",
    "sampler_ceiling_flops_util",
    *(f"qcmrf{w}_{k}" for w in (20, 24, 26, 28, 30)
      for k in ("gate_level_ms", "fused_passes", "gates")),
    "qcmrf24_sharded_gate_level_ms", "qcmrf28_sharded_gate_level_ms",
    "qcmrf28_class_ms", "qcmrf28_class_sum_ms", "qcmrf28_unattributed_ms",
    "suite70_gate_level_ms", "kl_suite_max_10k_shots",
    "kl_suite_max_1m_shots", "est_n28_shots_per_sec",
    "lnZ_n24_ms", "lnZ_n28_ms", "lnZ_n28_fma_tflops", "lnZ_n30_ms",
    "lnZ_n34_ms", "train_wide_k27_step_ms", "moments_k24_ms",
    "moments_k24_matmul_tflops", "pam_n24_ms_per_sample",
    "exact_sample_n40_per_sec",
)

#: the headline: bench.py's n = 20 grid at 2^27 shots a call
METRIC = "qcmrf outcome sampling, n=20 grid (20 vars + 31 ancillas)"
HEADLINE_SHOTS = 1 << 27


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _best_s(fn, reps: int, trials: int = 3) -> float:
    """The best of ``trials`` means of :func:`profiling.timed` (seconds a
    call; CUDA events for a call that returns a CUDA tensor)."""
    from qcmrf_tpu_torch.utils import profiling

    return min(profiling.timed(fn, reps=reps) for _ in range(trials))


def _host_best_s(fn, device, trials: int = 3) -> float:
    """The best of ``trials`` host-clock times of ``fn()`` after a warm-up,
    each ended by a synchronise of ``device``."""
    fn()
    best = math.inf
    for _ in range(trials):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _model(cliques, seed: int, scale: float, device, n=None):
    """A model of ``cliques`` with theta = -|randn(RandomState(seed))| *
    scale in float32 (bench.py's models)."""
    from qcmrf_tpu_torch.models.mrf import MRF

    dim = sum(1 << len(C) for C in cliques)
    theta = -np.abs(np.random.RandomState(seed).randn(dim)).astype(
        np.float32) * scale
    return MRF.create(cliques, theta=theta, n=n, device=device)


def grid_model(n: int, device, seed: int = 0, scale: float = 0.3):
    """JAX bench's grid of about ``n`` variables: rows = max(2,
    floor(sqrt(n))), cols = max(2, n // rows)."""
    from qcmrf_tpu_torch.models.mrf import grid_cliques

    rows = max(2, int(np.sqrt(n)))
    return _model(grid_cliques(rows, max(2, n // rows)), seed, scale,
                  device)


def _suite_problems():
    from qcmrf_tpu_torch.models.suite import generate_suite

    suite = generate_suite(0.1)
    return [(C, np.asarray(suite.thetas[j], np.float32))
            for j, C in enumerate(suite.graphs)]


def suite70_seconds(device) -> float:
    """The 70 gate-level circuits of the seed-1984 suite at scale 0.1 in
    one ``batched_circuits_probs`` call (one circuit-kernel launch):
    seconds a call, host packing included (the counterpart of JAX's
    ``make_suite70_fused``)."""
    from qcmrf_tpu_torch.ops import circuit_kernel

    problems = _suite_problems()
    return _best_s(lambda: circuit_kernel.batched_circuits_probs(
        problems, device=device), reps=5)


def main(argv: Optional[List[str]] = None) -> dict:
    """``python -m qcmrf_tpu_torch bench``: see the module docstring."""
    parser = argparse.ArgumentParser(prog="qcmrf_tpu_torch bench")
    parser.add_argument("--n", type=int, default=20,
                        help="grid variables (rows * cols closest to n)")
    parser.add_argument("--shots", type=int, default=None,
                        help="shots a sampler call (default 2^27)")
    parser.add_argument("--trace", type=str, default=None,
                        help="profile one sampler call with PyTorch's "
                             "profiler into this directory (a Chrome "
                             "trace)")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    from qcmrf_tpu_torch.ops import sampler_kernel
    from qcmrf_tpu_torch.utils import profiling

    dev = _card(None)
    mrf = grid_model(args.n, dev)
    n = mrf.n
    shots = args.shots or HEADLINE_SHOTS
    out = {"n": n, "cliques": mrf.num_cliques,
           "backend": torch.cuda.get_device_name(dev),
           "power_limit": power_limit().split(",")[-1].strip()}

    def sample():
        return sampler_kernel.sample_outcome_parts(1, mrf, shots)

    out["sampler_shots_per_sec"] = round(shots / _best_s(sample, reps=10))
    if args.trace:
        with profiling.trace(args.trace):
            sample()
        busy = profiling.device_busy(profiling.trace_files(args.trace)[-1])
        out["trace_dir"] = args.trace
        out["trace"] = {k: busy[k] for k in (
            "busy_ms", "union_ms", "window_ms", "idle_share", "kernels",
            "gap_spans")}

    dt = _best_s(lambda: kernels.all_log_potentials(mrf), reps=10)
    out["logpot_ms"] = round(dt * 1e3, 4)
    out["logpot_write_gbps"] = round((1 << n) * 4 / dt / 1e9, 2)
    out["lnZ_ms"] = round(_best_s(lambda: kernels.log_partition(mrf),
                                  reps=10) * 1e3, 4)
    bw_n = max(n, 24)
    lane_gbps, row_gbps = gate_apply_gbps(bw_n, dev)
    out["gate_bw_n"] = bw_n
    out["gate_lane_gbps"] = round(lane_gbps, 2)
    out["gate_row_gbps"] = round(row_gbps, 2)
    out["suite70_gate_level_ms"] = round(suite70_seconds(dev) * 1e3, 4)

    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>24}: {v}")
    return out


def numpy_sampler_rate(mrf, shots: int = 1 << 17, reps: int = 7) -> float:
    """Shots/s of the root ``bench.py``'s vectorised numpy sampler on the
    host (pairwise cliques): the best of ``reps`` runs, the ``vs_baseline``
    denominator."""
    theta = mrf.theta.detach().cpu().numpy()
    n, K = mrf.n, mrf.num_cliques
    tab = np.stack([theta[o:o + 4] for o in mrf.theta_offsets])
    sa = np.array([n - 1 - C[0] for C in mrf.cliques], dtype=np.int64)
    sb = np.array([n - 1 - C[1] for C in mrf.cliques], dtype=np.int64)
    rng = np.random.RandomState(0)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        x = rng.randint(0, 1 << n, size=shots).astype(np.int64)
        y = (((x[:, None] >> sa) & 1) << 1) | ((x[:, None] >> sb) & 1)
        c2 = np.exp(tab[np.arange(K)[None, :], y])
        abits = (rng.random_sample((shots, K)) >= c2).astype(np.int64)
        _ = x + ((abits << np.arange(K, dtype=np.int64)).sum(1) << (n + 1))
        best = min(best, time.perf_counter() - t0)
    return shots / best


def _sampler_record(dev, fma_tflops: float) -> dict:
    """The headline and the sampler's three output modes at 2^27 shots on
    bench.py's n = 20 grid, with the acceptance held to Z / 2^n."""
    from qcmrf_tpu_torch.ops import sampler_kernel

    mrf = grid_model(20, dev)
    S = HEADLINE_SHOTS
    modes = {m: _best_s(lambda m=m: getattr(sampler_kernel, m)(1, mrf, S),
                        reps=8, trials=5)
             for m in ("sample_outcome_parts", "sample_accept_count",
                       "sample_accept_flags")}
    rate = S / modes["sample_outcome_parts"]
    no_out = S / modes["sample_accept_count"]
    flags = S / modes["sample_accept_flags"]
    acc = float(sampler_kernel.sample_accept_count(2, mrf, S)) / S
    want = float(mrf.success_rate())
    if abs(acc - want) > max(0.2 * want, 1e-4):
        raise AssertionError(f"acceptance {acc} against Z/2^n {want}")
    gflops = no_out * 2 * mrf.dimension / 1e9
    return {
        "metric": METRIC, "value": round(rate), "unit": "shots/sec",
        "vs_baseline": round(rate / numpy_sampler_rate(mrf), 1),
        "sampler_no_output_shots_per_sec": round(no_out),
        "sampler_flags_shots_per_sec": round(flags),
        "sampler_write_cost_pct": round(100.0 * (1.0 - flags / no_out), 1),
        "sampler_headline_vs_ceiling_pct": round(
            100.0 * (1.0 - rate / no_out), 1),
        "sampler_ceiling_fma_gflops": round(gflops, 1),
        "sampler_ceiling_flops_util": round(gflops / 1e3 / fma_tflops, 3),
    }


def _gate_level_record(dev) -> dict:
    """bench.py's QCMRF chains at widths 20-30 on the plane engine (the
    fused passes from zero planes), and the width-28 chain's passes timed
    class by class."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.sim import planes

    out = {}
    for w in (20, 24, 26, 28, 30):
        nn = w // 2
        chain = _model([[i, i + 1] for i in range(nn - 1)], 0, 0.3, dev)
        circ = compile_qcmrf(chain, with_measurements=False)
        ops = planes.fuse_ops(circ)
        torch.cuda.empty_cache()
        out[f"qcmrf{w}_gate_level_ms"] = round(_best_s(
            lambda: planes.run_ops(ops, w, dev), reps=3 if w >= 28 else 5,
            trials=2) * 1e3, 3)
        out[f"qcmrf{w}_fused_passes"] = len(ops)
        out[f"qcmrf{w}_gates"] = len(circ.gates)
        if w == 28:
            re, im = planes.run_ops(ops, w, dev)
            classes = {}
            for op in ops:
                classes.setdefault(op[0], []).append(op)
            out["qcmrf28_class_ms"] = {
                f"{kind}_x{len(group)}": round(_best_s(
                    lambda g=group: planes.apply_ops(re, im, g, w), reps=8,
                    trials=2) * 1e3, 3)
                for kind, group in sorted(classes.items())}
            del re, im
    total = sum(out["qcmrf28_class_ms"].values())
    out["qcmrf28_class_sum_ms"] = round(total, 3)
    out["qcmrf28_unattributed_ms"] = round(
        out["qcmrf28_gate_level_ms"] - total, 3)
    out.update(_sharded_gate_level_record(dev))
    torch.cuda.empty_cache()
    return out


def _sharded_gate_level_record(dev) -> dict:
    """The chains of 12 and 14 variables through the gate-level sharded
    engine on a mesh of the one device, timed as the plane engine's: no
    exchange runs, so the ratio to ``qcmrf{w}_gate_level_ms`` isolates the
    sharding layer (the root bench.py's bar: within ~1.2x)."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.parallel import sharded

    mesh1 = sharded.Mesh((dev,))
    out = {}
    for nn in (12, 14):
        chain = _model([[i, i + 1] for i in range(nn - 1)], 0, 0.3, dev)
        circ = compile_qcmrf(chain, with_measurements=False)
        torch.cuda.empty_cache()
        out[f"qcmrf{2 * nn}_sharded_gate_level_ms"] = round(_best_s(
            lambda: sharded.run_statevector_sharded(circ, mesh1),
            reps=3 if nn == 14 else 5, trials=2) * 1e3, 3)
    return out


def _suite_max_kl(dev, seed: int, shots: int) -> float:
    """The largest KL(exact Gibbs || post-selected empirical) over the
    suite's 7 graphs (rep 0 each) at ``shots`` shots, graph j on Philox
    stream j of ``seed``."""
    from qcmrf_tpu_torch.evaluation import metrics
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.sim import analytic

    kls = []
    for j, (C, thetas) in enumerate(_suite_problems()):
        m = MRF.create(C, theta=thetas[0], device=dev)
        x, acc = analytic.sample_postselected(seed, m, shots, stream=j)
        q = torch.bincount(x[acc].long(), minlength=m.num_states).double()
        q = (q / max(float(q.sum()), 1.0)).cpu().numpy()
        p = m.gibbs_probs().double().cpu().numpy()
        kls.append(float(metrics.kl(p, q)))
    return max(kls)


def _exact_record(dev) -> dict:
    """lnZ at n = 24-34, the K27 training step, the K24 moments, PAM at
    n = 24 and FFBS at n = 40: bench.py's models."""
    from qcmrf_tpu_torch.models import elimination, moments
    from qcmrf_tpu_torch.models import sample as msample
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.models.mrf import grid_cliques
    from qcmrf_tpu_torch.utils import moebius

    out = {}
    for cl in (grid_cliques(4, 6), grid_cliques(4, 7), grid_cliques(5, 6),
               [[i, i + 1] for i in range(33)]):
        gm = _model(cl, 1, 0.1, dev)
        ms = _best_s(lambda: kernels.log_partition(gm), reps=5) * 1e3
        out[f"lnZ_n{gm.n}_ms"] = round(ms, 4)
        if gm.n == 28:
            # bench.py's naive count: 2 operations a Moebius coefficient a
            # state
            out["lnZ_n28_fma_tflops"] = round(
                2.0 * gm.dimension * gm.num_states / (ms / 1e3) / 1e12, 3)

    k27 = [[i, j] for i in range(27) for j in range(i + 1, 27)]
    kw = _model(k27, 11, 0.02, dev)
    # bench.py's mu-hat: the same generator's next draws after theta's
    rs = np.random.RandomState(11)
    rs.randn(kw.dimension)
    mu = rs.uniform(0.1, 0.5, kw.dimension)
    raw = mtrain._from_theta(kw.theta, True).requires_grad_()
    step = mtrain.make_moment_train_step(kw, mtrain.adam([raw], 5e-2), mu)
    out["train_wide_k27_step_ms"] = round(_best_s(step, reps=3) * 1e3, 3)

    k24 = [[i, j] for i in range(24) for j in range(i + 1, 24)]
    km = _model(k24, 11, 0.02, dev)
    lnz = kernels.log_partition(km)
    ms = _best_s(lambda: moments.clique_moments_streaming(km, lnz),
                 reps=5) * 1e3
    out["moments_k24_ms"] = round(ms, 4)
    m_mono = len(moebius.monomial_masks(km.cliques, km.n))
    out["moments_k24_matmul_tflops"] = round(
        2.0 * m_mono * km.num_states / (ms / 1e3) / 1e12, 4)

    cl_p = ([[i, i + 1] for i in range(23)]
            + [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(6)])
    mp = _model(cl_p, 7, 0.5, dev)
    out["pam_n24_ms_per_sample"] = round(_host_best_s(
        lambda: msample.sample_pam_streaming(0, mp, 16), dev) * 1e3 / 16, 4)

    ce = _model([[i, i + 1] for i in range(39)], 9, 1.0, dev)
    draws = 65536
    out["exact_sample_n40_per_sec"] = round(draws / _host_best_s(
        lambda: elimination.sample_exact_elim(1, ce, draws), dev))
    return out


def record(device=None) -> dict:
    """The root ``bench.py``'s keys that the port can measure
    (``RECORD_KEYS``), each measured afresh on the card: see the module
    docstring for what is left out and why."""
    from qcmrf_tpu_torch.parallel import sharded

    dev = _card(device)
    fma = fma_peak_tflops(dev)
    out = _sampler_record(dev, fma)
    out["device_kind"] = torch.cuda.get_device_name(dev)
    bw_n = 24
    lane, row = gate_apply_gbps(bw_n, dev)
    copy = copy_kernel_gbps(bw_n, dev)
    out.update(gate_bw_n=bw_n, gate_lane_gbps=round(lane, 1),
               gate_row_gbps=round(row, 1), copy_kernel_gbps=round(copy, 1),
               gate_lane_copy_ratio=round(lane / copy, 3),
               gate_row_copy_ratio=round(row / copy, 3),
               fma_peak_tflops=round(fma, 2))
    out.update(_gate_level_record(dev))
    out["suite70_gate_level_ms"] = round(suite70_seconds(dev) * 1e3, 4)
    kl10k = [_suite_max_kl(dev, s, 10_240) for s in (5, 6, 7)]
    out["kl_suite_max_10k_shots"] = {
        "mean": round(float(np.mean(kl10k)), 6),
        "spread": round(max(kl10k) - min(kl10k), 6),
        "seeds": [round(k, 6) for k in kl10k]}
    out["kl_suite_max_1m_shots"] = round(_suite_max_kl(dev, 5, 1 << 20), 7)
    from qcmrf_tpu_torch.models.mrf import grid_cliques

    m28 = _model(grid_cliques(4, 7), 0, 0.1, dev)
    mesh1 = sharded.make_mesh(1, device=dev)
    est_shots, est_iters = 1 << 26, 5
    dt = _best_s(lambda: sharded.sharded_estimate_delta(
        3, m28, mesh1, est_shots, est_iters), reps=3) / est_iters
    out["est_n28_shots_per_sec"] = round(est_shots / dt)
    out.update(_exact_record(dev))
    return {k: out[k] for k in RECORD_KEYS}
