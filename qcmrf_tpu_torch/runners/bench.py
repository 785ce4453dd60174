"""Gate-pass, copy and compute rates on the card (the rate part of
:mod:`qcmrf_tpu.runners.bench` and of the root ``bench.py``).

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

from typing import Callable

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
