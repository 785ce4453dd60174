"""The traced run: the window under PyTorch's Kineto profiler, reduced to
what the per-layer metrics and the result's ``breakdown`` read.

The arithmetic is that of the program's ``utils/profiling.device_busy``
(the union of the device's operation intervals against the window, the
operations by name, the holes between them), taken over the benchmark's
own window span rather than the first and last event, and with each hole
named by what the host was doing in it: the innermost ``bench.*`` span and
the outermost PyTorch operation that cover the hole's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class TraceSummary:
    """The traced window, in seconds from its start."""

    window_s: float
    busy_s: float
    #: device operations in the window: (name, start_s, seconds, activity)
    device_ops: List[Tuple[str, float, float, str]]
    #: idle stretches of the window: (what the host was doing, start_s, s)
    gaps: List[Tuple[str, float, float]]

    @property
    def kernels(self) -> List[Tuple[str, float, float, str]]:
        return [op for op in self.device_ops if op[3] == "kernel"]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time and the idle time by
        what the host was doing, each ``[name, seconds]``."""
        return {"device_ops": _top(((n, s) for n, _, s, _ in
                                    self.device_ops), top),
                "idle_gaps": _top(((n, s) for n, _, s in self.gaps), top)}


#: characters of a name the breakdown keeps: a kernel's templated name
#: runs to a thousand
NAME_CHARS = 160


def _top(pairs, top: int) -> list:
    total: Dict[str, float] = {}
    for name, s in pairs:
        total[name] = total.get(name, 0.0) + s
    return [[n[:NAME_CHARS], s] for n, s in sorted(
        total.items(), key=lambda kv: -kv[1])[:top]]


class Profiler:
    """``with Profiler(on) as p:`` traces the block when ``on``;
    ``p.summary()`` then reduces what was traced."""

    def __init__(self, enabled: bool, device_type: str = "cuda"):
        self.enabled = enabled
        self.device_type = device_type
        self._events = None

    def __enter__(self):
        if self.enabled:
            from torch.autograd import profiler

            self._prof = profiler.profile(
                use_device=self.device_type if self.device_type != "cpu"
                else None, use_kineto=True)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._prof.__exit__(*exc)
            self._events = self._prof.kineto_results.events()
        return False

    def summary(self) -> Optional[TraceSummary]:
        if self._events is None:
            return None
        return summarize(self._events)


def _activity(e) -> str:
    """Kineto's activity of an event, worked out where the event does not
    say (PyTorch before 2.13): the device's memory copies and sets by
    name, its other operations kernels."""
    annotation = e.is_user_annotation()
    if "CUDA" in str(e.device_type()):
        if annotation:
            return "gpu_user_annotation"
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if annotation else "cpu_op"


def summarize(events) -> TraceSummary:
    """Reduce Kineto events to a :class:`TraceSummary` of the
    ``bench.window`` span."""
    device, spans, ops = [], [], []
    w0 = w1 = None
    for e in events:
        kind = _activity(e)
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if kind in DEVICE_ACTIVITIES:
            device.append((t0, t1, name, kind))
        elif kind == "user_annotation" and name.startswith("bench."):
            if name == WINDOW_SPAN:
                w0, w1 = t0, t1
            else:
                spans.append((t0, t1, name))
        elif kind == "cpu_op":
            ops.append((t0, t1, name))
    if w0 is None:
        raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
    device = sorted((max(a, w0), min(b, w1), n, k) for a, b, n, k in device
                    if b > w0 and a < w1)
    busy, holes, at = 0, [], w0
    for a, b, _, _ in device:
        if a > at:
            holes.append((at, a))
        if b > at:
            busy += b - max(a, at)
            at = b
    if at < w1:
        holes.append((at, w1))
    label = _Labeller(spans, ops)
    s = 1e-9
    return TraceSummary(
        window_s=(w1 - w0) * s, busy_s=busy * s,
        device_ops=[(n, (a - w0) * s, (b - a) * s, k)
                    for a, b, n, k in device],
        gaps=[(label((a + b) // 2), (a - w0) * s, (b - a) * s)
              for a, b in holes])


class _Labeller:
    """Names an instant by the innermost ``bench.*`` span and the
    outermost PyTorch operation running on the host then."""

    def __init__(self, spans, ops):
        self.spans = sorted(spans)
        self.span_starts = [a for a, _, _ in self.spans]
        top, end = [], None
        for a, b, name in sorted(ops):
            if end is None or a >= end:
                top.append((a, b, name))
                end = b
        self.ops = top
        self.op_starts = [a for a, _, _ in top]

    def __call__(self, t: int) -> str:
        span = "outside calls"
        # spans nest a few deep at most: the enclosing one is among the
        # last few that started
        i = bisect.bisect_right(self.span_starts, t) - 1
        for a, b, name in reversed(self.spans[max(i - 7, 0):i + 1]):
            if b >= t:
                span = name
                break
        op = "host code"
        j = bisect.bisect_right(self.op_starts, t) - 1
        if j >= 0 and self.ops[j][1] >= t:
            op = self.ops[j][2]
        return f"{span} / {op}"


class Spans:
    """``with spans("bench.call"):`` marks a region of the host's work;
    while a trace runs it shows as a ``user_annotation`` of that name."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.autograd import profiler

        return profiler.record_function(name)
