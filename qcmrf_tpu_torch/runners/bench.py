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
import subprocess
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
# The bench command
# --------------------------------------------------------------------------

#: the headline: bench.py's n = 20 grid at 2^27 shots a call
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


def grid_model(n: int, device, seed: int = 0, scale: float = 0.3):
    """JAX bench's grid of about ``n`` variables: rows = max(2,
    floor(sqrt(n))), cols = max(2, n // rows), with theta =
    -|randn(RandomState(seed))| * scale in float32 (bench.py's models)."""
    from qcmrf_tpu_torch.models.mrf import MRF, grid_cliques

    rows = max(2, int(np.sqrt(n)))
    cliques = grid_cliques(rows, max(2, n // rows))
    dim = sum(1 << len(C) for C in cliques)
    theta = -np.abs(np.random.RandomState(seed).randn(dim)).astype(
        np.float32) * scale
    return MRF.create(cliques, theta=theta, device=device)


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
