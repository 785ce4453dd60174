"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name from ``BENCHMARK.json``:

* a configuration is the JSON file its entry names; its ``reference`` key
  names the plain reference ``reference/<name>.py``;
* a traffic mix is ``traffic/<mix>.json``; its ``loop`` key names the
  module ``loops/<loop>.py`` that drives the program under test with
  that mix's parameters, and its ``limits`` the comparison's limits;
* a metric, end-to-end or per-layer, is read by ``metrics/<name>.py`` or,
  for ``<base>.<part>``, by ``metrics/<base>.py`` where the first is
  absent: ``read(run)`` returns a number, or ``None`` where there is
  nothing to read, and the metric is then left out of the line.

What the tests and ``control.py`` need of a cell lives in the same files,
so a cell comes from new files and ``BENCHMARK.json`` entries alone: each
configuration and traffic file's ``small`` object holds the keys it
overrides at a CPU test's size (a statistical mix's ``small_control``,
the size at which the control's bias shows), and each loop module
declares its ``control(loop)`` and its ``FAULTS``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from benchmark.trace import Profiler, Spans, TraceSummary

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no run may have loaded
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "qcmrf_tpu")


@dataclasses.dataclass
class Window:
    """What a loop's measured window did."""

    units: int                 # calls, queries or steps completed
    elapsed_s: float           # from the window's start to the last's end
    attempted: int
    failed: int
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    #: loop-specific amounts the metric readers use (shots, shapes...)
    work: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: dict
    config: dict
    mix: dict
    window: Window
    setup_s: float
    trace: Optional[TraceSummary] = None


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, else, for a
    dotted name, ``<kind>/<base>.py``."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r}")
    mod_name = f"benchmark_{kind}_{path.stem.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_inputs(spec: dict, workload: str):
    """(cell, config, mix) of a workload name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / entry["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, mix


def cell_metrics(spec: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    name = cell["name"]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_loaded() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             config: dict = None, mix: dict = None) -> dict:
    """Run one cell and return its result object (without printing).
    ``config`` and ``mix`` replace the cell's files (the tests' small
    sizes)."""
    import torch

    cell, cfg, mx = cell_inputs(spec, workload)
    cfg = config if config is not None else cfg
    mx = mix if mix is not None else mx
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spans = Spans(trace)
    loop = load_module("loops", mx["loop"]).Loop(
        cfg, mx, seed, dev, spans)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    loop.warm_up()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    # what set-up built (the imports' ~180 000 objects) goes to the
    # permanent generation: a full collection in the window would rescan
    # it, ~0.1 s each time, which is set-up's cost and not the calls'
    gc.collect()
    gc.freeze()
    try:
        with Profiler(trace, dev.type) as prof:
            with spans("bench.window"):
                window = loop.window(seconds)
    finally:
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = prof.summary()
    loop.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = loop.checks()

    run = Run(cell, cfg, mx, window, setup_s, summary)
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    correct = (window.failed == 0 and window.units > 0
               and all(c.ok for c in checks))
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": dev_info}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    # a number that is not finite fails its limit and is printed as the
    # largest float, so that the line stays JSON
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                                 else sys.float_info.max, "limit": c.limit}
                        for c in checks}
    return result


def emit(result: dict, out=None, err=None) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def closed_loop(seconds: float, call: Callable[[int], object],
                done: Callable[[int, object], None], per_call: int = 1,
                work: dict = None) -> Window:
    """One client calling ``call(i)`` back to back, each call as soon as
    the last has returned, until ``seconds`` have passed; ``done(j, out)``
    gets the output of the ``j``-th call that returned. A call that raises
    is counted as failed and the loop goes on. Each call does
    ``per_call`` units of work."""
    t0 = time.perf_counter()
    end = t0 + seconds
    i = failed = 0
    t1 = t0
    while t1 < end:
        try:
            out = call(i)
        except (Exception, SystemExit):
            failed += 1
            report_failure(i)
        else:
            done(i - failed, out)
        i += 1
        t1 = time.perf_counter()
    return Window(units=(i - failed) * per_call, elapsed_s=t1 - t0,
                  attempted=i * per_call, failed=failed * per_call,
                  work=work or {})


def reservoir(capacity: int, rng) -> Callable:
    """A seeded uniform sample of at most ``capacity`` items of a stream:
    ``keep = reservoir(24, rng); keep(i)`` says where item ``i`` goes
    (a slot index) or ``None``."""
    def keep(i: int) -> Optional[int]:
        if i < capacity:
            return i
        j = int(rng.integers(0, i + 1))
        return j if j < capacity else None
    return keep


def report_failure(index: int) -> None:
    """Print the traceback of a failed call to standard error."""
    import traceback

    print(f"call {index} failed:", file=sys.stderr)
    traceback.print_exc(file=sys.stderr)
