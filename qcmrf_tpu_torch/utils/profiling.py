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
  on a CUDA device is waited for before the clock is read);
* :func:`span`, :func:`spanned` and :func:`count`: the program's own
  spans and counters, recorded only while PyTorch's profiler runs
  (:func:`session_spans`, :func:`session_counts`, :func:`self_times`),
  and :func:`launch`, the one launch counter of the hand-written kernels
  (:data:`LAUNCHES`).

Spans and counters. ``with span("qcmrf.<layer>.<stage>"):`` marks a
region of the program's host work and ``count(name, n)`` charges ``n`` to
the innermost open span. While PyTorch's profiler is off (every untraced
run) both are one check: ``span`` returns a shared no-op context, with no
allocation, no clock read and no ``record_function``. While it is on, a
span also enters ``torch.autograd.profiler.record_function(name)``, so it
shows in the Kineto trace beside the device's operations, and its start
and end are read from the clock that Kineto stamps host events with
(``time.time_ns``): the recorded spans and the trace share one clock.
Each profiler session starts a new record (PyTorch's profilers announce
their start through ``torch.autograd.profiler._run_on_profiler_start``,
which this module wraps); :func:`session_spans` returns the last one's.
A span holds its parent and its request, the outermost span open when it
started, so all spans of one request share it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import json
import os
import socket
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _torch_profiler


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


# ---- the program's spans and counters --------------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Span:
    """A recorded span: its start and end in ns on the Kineto trace's
    clock (``end_ns`` 0 while it is open), its parent's index in its
    session's list (None for an outermost span), its request (the index
    of the outermost span open when it started, its own for an outermost
    span) and what :func:`count` charged to it while it was the innermost
    open span."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: int
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns if self.end_ns else 0


class _Session:
    """What one profiler session recorded: its spans in the order they
    started, the indices of those open (innermost last), and what was
    counted while none was open. The program opens spans on one
    thread."""

    def __init__(self):
        self.spans: List[Span] = []
        self.open: List[int] = []
        self.counts: Dict[str, int] = {}


_SESSION = _Session()


class _Off:
    """The one context every span returns while the profiler is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span while the profiler is on: a ``record_function`` of its name
    and a :class:`Span` of the running session."""

    __slots__ = ("name", "session", "span", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.session = session = _SESSION
        self.rf = _torch_profiler.record_function(self.name)
        self.rf.__enter__()
        # the clock is read inside the trace's event: the span lies within
        # the record_function event of its name
        start = time.time_ns()
        i = len(session.spans)
        parent = session.open[-1] if session.open else None
        self.span = Span(self.name, start, 0, parent,
                         i if parent is None
                         else session.spans[parent].request)
        session.spans.append(self.span)
        session.open.append(i)
        return None

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        self.session.open.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """``with span("qcmrf.<layer>.<stage>"):`` records the block as a
    program span while PyTorch's profiler runs (see the module's
    docstring); otherwise it does nothing."""
    if not _profiler_enabled():
        return _OFF
    return _On(name)


def spanned(name: str):
    """Decorator: each call of the function is a :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _charge(name: str, n: int) -> None:
    session = _SESSION
    counts = (session.spans[session.open[-1]].counts if session.open
              else session.counts)
    counts[name] = counts.get(name, 0) + n


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (of the
    session, where none is open) while PyTorch's profiler runs."""
    if _profiler_enabled():
        _charge(name, n)


#: launches of the hand-written CUDA kernels by kernel, bumped by
#: :func:`launch` (each ops module's ``LAUNCHES`` is this dict)
LAUNCHES: Dict[str, int] = dict.fromkeys((
    "logpot", "lse", "map", "moments", "lnz_moments", "hdh_multi",
    "hdh_multi_probs", "hdh_multi_uniform", "hdh_multi_uniform_probs",
    "diag", "row_gate", "lane", "lane_factored", "copy", "fma_peak",
    "sampler", "circuit", "gibbs", "gibbs_ais"), 0)


def launch(kernel: str) -> None:
    """Count one launch of ``kernel`` in :data:`LAUNCHES` and, while
    PyTorch's profiler runs, as ``launch.<kernel>`` of the innermost open
    span."""
    LAUNCHES[kernel] += 1
    if _profiler_enabled():
        _charge("launch." + kernel, 1)


def session_spans() -> List[Span]:
    """The spans of the last profiler session (of the running one while
    it runs), in the order they started: an empty list before the first."""
    return list(_SESSION.spans)


def session_counts() -> Dict[str, int]:
    """Every counter of the last profiler session, summed over its spans
    and what was counted outside them."""
    session = _SESSION
    out = dict(session.counts)
    for s in session.spans:
        for k, v in s.counts.items():
            out[k] = out.get(k, 0) + v
    return out


def self_times(spans: List[Span]) -> List[int]:
    """Each span's ns less what its child spans cover, for a session's
    whole list (children of a span run one after another)."""
    out = [s.ns for s in spans]
    for s in spans:
        if s.parent is not None:
            out[s.parent] -= s.ns
    return out


def _start_sessions() -> None:
    """Open a new record as each profiler session starts: PyTorch's
    profilers (``torch.autograd.profiler.profile``, and
    ``torch.profiler.profile`` through it) call
    ``torch.autograd.profiler._run_on_profiler_start`` just before they
    enable the profiler."""
    start = getattr(_torch_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "opens_record", False):
        return

    def _run_on_profiler_start():
        global _SESSION
        start()
        _SESSION = _Session()

    _run_on_profiler_start.opens_record = True
    _torch_profiler._run_on_profiler_start = _run_on_profiler_start


_start_sessions()


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
    ``[start_ms, ms]`` from the window's start) and ``gap_spans`` (the ms
    of every such stretch by the innermost program span, ``qcmrf.*``,
    running on the host at its middle, "outside spans" where none was;
    the most first). A trace with no kernel, as on the CPU, is idle
    throughout."""
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
    program = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in spans
                     if e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith("qcmrf."))
    by_span = _gap_spans(program, holes)
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
        "gap_spans": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
    }


def _gap_spans(program, holes) -> Dict[str, float]:
    """ms of the ``holes`` ((start, us)) by the innermost of the nested
    ``program`` spans ((start, end, name), sorted) covering each hole's
    middle."""
    out: Dict[str, float] = {}
    open_spans, i = [], 0
    for mid, d in sorted((lo + d / 2, d) for lo, d in holes if d > 0):
        while i < len(program) and program[i][0] <= mid:
            while open_spans and open_spans[-1][1] < program[i][0]:
                open_spans.pop()
            open_spans.append(program[i])
            i += 1
        while open_spans and open_spans[-1][1] < mid:
            open_spans.pop()
        name = open_spans[-1][2] if open_spans else "outside spans"
        out[name] = out.get(name, 0.0) + d / 1e3
    return out


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
