"""The per-layer metrics read from the program's own spans and counters
(``metrics/_spans.py``): each gives a number in every cell it names from a
small traced run on the CPU, and nothing where the program keeps no
record of its spans."""

import time

import pytest

from benchmark import harness
from benchmark.metrics import _spans

SPEC = harness.load_spec()
SPAN_METRICS = [m for m in SPEC["per_layer"]
                if m["source"] in ("program_span", "program_counter")]
CELLS = sorted({w for m in SPAN_METRICS for w in m["workloads"]})


def traced_small(small, workload, monkeypatch):
    cfg, mix = small(workload)
    if workload == "k27.infer":
        # at a CPU test's size elimination would serve every query: send
        # them down the streaming sweeps, as K27's width does on the card
        from qcmrf_tpu_torch.models import capability

        monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    return harness.run_cell(SPEC, workload, 20261018 + (1 << 33), 0.5, True,
                            "cpu", time.perf_counter(), config=cfg, mix=mix)


@pytest.mark.parametrize("workload", CELLS)
def test_each_span_metric_reads_a_number_in_its_cells(small, workload,
                                                      monkeypatch):
    out = traced_small(small, workload, monkeypatch)
    assert out["correct"] is True, out["checks"]
    names = [m["name"] for m in SPAN_METRICS if workload in m["workloads"]]
    assert names
    for name in names:
        value = out["metrics"][name]["value"]
        assert value >= 0.0, (name, value)
    host = next(v["value"] for k, v in out["metrics"].items()
                if k.startswith("host_ms."))
    assert host > 0.0
    if workload == "k27.infer":
        m = {k: v["value"] for k, v in out["metrics"].items()}
        assert m["sweep_ms.query"] > 0.0 and m["wait_ms.query"] > 0.0
        # the CLI's own code and the sweeps are parts of the host's time
        assert m["cli_ms.query"] + m["sweep_ms.query"] <= m["host_ms.query"]


def test_the_readers_give_nothing_without_the_programs_record(
        small, monkeypatch):
    """A program whose profiling keeps no spans (one older than them)
    leaves every span metric out of the line, and the run stays
    correct."""
    from qcmrf_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "session_spans")
    assert _spans.session() is None
    out = traced_small(small, "chain15.shots", monkeypatch)
    assert out["correct"] is True
    assert not set(out["metrics"]) & {m["name"] for m in SPAN_METRICS}
