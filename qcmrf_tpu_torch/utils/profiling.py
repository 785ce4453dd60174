"""Tracing and performance counters (port of
:mod:`qcmrf_tpu.utils.profiling`):

* :func:`trace`: a region under PyTorch's Kineto profiler (CPU and CUDA
  activities), written as a Chrome trace (``*.pt.trace.json``) into a
  directory, as JAX's writes a TensorBoard directory;
* :func:`device_busy`: from such a trace, the CUDA kernels' busy time,
  the union of their intervals, the traced window and the device's idle
  share, the top kernels by time and the longest gaps;
* :func:`timed`: seconds per call, by CUDA events for a call that returns
  a CUDA tensor and by the host clock otherwise;
* :class:`Counter` and :func:`stopwatch`: wall-clock counters (work queued
  on a CUDA device is waited for before the clock is read).
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import socket
import time
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass
class Counter:
    """Accumulates work items and elapsed time; reports rates."""

    items: float = 0.0
    bytes: float = 0.0
    seconds: float = 0.0

    def add(self, items: float = 0.0, nbytes: float = 0.0,
            seconds: float = 0.0) -> None:
        self.items += items
        self.bytes += nbytes
        self.seconds += seconds

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    @property
    def gb_per_sec(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    def report(self) -> Dict[str, float]:
        return {
            "items": self.items,
            "seconds": round(self.seconds, 6),
            "items_per_sec": round(self.items_per_sec, 1),
            "gb_per_sec": round(self.gb_per_sec, 3),
        }


@contextlib.contextmanager
def stopwatch(counter: Counter, items: float = 0.0, nbytes: float = 0.0,
              device: Optional[torch.device] = None):
    """Time a block into a counter; on a CUDA ``device`` the clock stops
    only after the device has finished the block's work."""
    t0 = time.perf_counter()
    yield
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    counter.add(items=items, nbytes=nbytes,
                seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region with PyTorch's Kineto profiler (CPU activity, and
    CUDA activity where a device is present); on exit the CUDA work is
    waited for and the trace written into ``logdir`` as
    ``<host>_<pid>.<ms>.pt.trace.json`` (Chrome's format, which
    TensorBoard's profiler plugin and :func:`device_busy` read), as
    ``torch.profiler.tensorboard_trace_handler`` names it. Yields
    ``logdir``; :func:`trace_files` lists what it holds.

    The profiler is ``torch.autograd.profiler.profile``, the one beneath
    ``torch.profiler.profile``: the latter imports ``torch._inductor``
    (and ``torch._dynamo`` with it) the first time a process starts it,
    seconds of host time that a one-off trace would pay."""
    from torch.autograd import profiler

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    with profiler.profile(use_device="cuda" if cuda else None,
                          use_kineto=True) as prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, (
        f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json")))


def trace_files(logdir: str) -> list:
    """The Chrome traces in ``logdir``, oldest first."""
    return sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")),
                  key=os.path.getmtime)


def _merge(intervals) -> list:
    """Sorted, disjoint [start, end) cover of ``intervals``."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def device_busy(trace_file: str, top: int = 5, gaps: int = 5) -> dict:
    """The CUDA kernels of a Chrome trace (events of category ``kernel``)
    against its window (the first to the last event of any kind, host
    ones included), in milliseconds: ``busy_ms`` (the kernels' summed
    durations), ``union_ms`` (the union of their intervals: time when at
    least one kernel ran), ``window_ms``, ``idle_share`` (1 - union /
    window), ``kernels`` (their count), ``top`` (the ``top`` kernel names
    by summed time, each ``[name, ms, launches]``) and ``gaps`` (the
    ``gaps`` longest stretches of the window with no kernel running, each
    ``[start_ms, ms]`` from the window's start). A trace with no kernel,
    as on the CPU, is idle throughout."""
    with open(trace_file) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not spans:
        raise ValueError(f"{trace_file}: no timed events")
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    kern = [e for e in spans if e.get("cat") == "kernel"]
    merged = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in kern)
    union = sum(hi - lo for lo, hi in merged)
    holes, at = [], t0
    for lo, hi in merged:
        holes.append((at, lo - at))
        at = hi
    holes.append((at, t1 - at))
    by_name = {}
    for e in kern:
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + float(e["dur"]) / 1e3, count + 1)
    window = t1 - t0
    return {
        "busy_ms": sum(float(e["dur"]) for e in kern) / 1e3,
        "union_ms": union / 1e3,
        "window_ms": window / 1e3,
        "idle_share": 1.0 - union / window if window > 0 else 1.0,
        "kernels": len(kern),
        "top": [[name, ms, count] for name, (ms, count) in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])[:top]],
        "gaps": [[(lo - t0) / 1e3, d / 1e3] for lo, d in sorted(
            (h for h in holes if h[1] > 0), key=lambda h: -h[1])[:gaps]],
    }


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def timed(fn: Callable, *args, reps: int = 10, warmup: int = 1) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``reps`` calls after
    ``warmup``: by CUDA events on the current stream of the device of the
    warm-up's first tensor when that is a CUDA tensor (the calls' host
    work included, the device's work finished), else by the host clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        with torch.cuda.device(t.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps
