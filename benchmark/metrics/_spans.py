"""The program's own spans and counters in the traced window: what
``qcmrf_tpu_torch.utils.profiling`` recorded in its last profiler session,
which is the window's (the benchmark's profiler is the run's only one).

Times are per unit of the cell's work (``window.units``: a call, circuit,
query or step), in ms. A program that records no span (one from before
its spans existed) gives None, and the metric is left out of the line.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

#: a blocking device-to-host read of the program
WAIT = "qcmrf.wait"


class Session(NamedTuple):
    spans: List[object]        # profiling.Span, in the order they started
    self_ns: List[int]         # each span's ns less its children's
    counts: Dict[str, int]     # every counter, summed over the session


def session() -> Optional[Session]:
    """The program's record of the last profiler session, or None where
    it has none."""
    try:
        from qcmrf_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "session_spans"):
        return None
    spans = profiling.session_spans()
    if not spans:
        return None
    return Session(spans, profiling.self_times(spans),
                   profiling.session_counts())


def per_unit(run, read: Callable[[Session], float]) -> Optional[float]:
    """``read(session)`` over the window's units, or None."""
    s = session()
    if s is None or not run.window.units:
        return None
    return read(s) / run.window.units


def self_ms(s: Session, match: Callable[[str], bool]) -> float:
    """ms of the session's spans whose name ``match``es, each less its
    child spans."""
    return 1e-6 * sum(t for span, t in zip(s.spans, s.self_ns)
                      if match(span.name))


def wait_ms(s: Session) -> float:
    """ms in the program's blocking reads."""
    return 1e-6 * sum(span.ns for span in s.spans if span.name == WAIT)


def host_ms(s: Session) -> float:
    """ms of the outermost spans less the blocking reads inside them."""
    outer = sum(span.ns for span in s.spans if span.parent is None)
    return 1e-6 * outer - wait_ms(s)
