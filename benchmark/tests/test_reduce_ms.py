"""``reduce_ms.query``: the evidence reduction's self time a query, read
from the program's ``qcmrf.moments.reduce`` spans in a small traced
k27.infer run on the CPU, where the mix clamps evidence."""

import time

import pytest

from benchmark import harness
from benchmark.metrics import _spans

SPEC = harness.load_spec()


def test_reduce_ms_reads_the_reductions_of_an_infer_run(small, monkeypatch):
    from qcmrf_tpu_torch.models import capability

    cfg, mix = small("k27.infer")
    # the streaming sweeps, as K27's width sends every query on the card
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    out = harness.run_cell(SPEC, "k27.infer", 20261018 + (1 << 34), 0.5,
                           True, "cpu", time.perf_counter(), config=cfg,
                           mix=mix)
    assert out["correct"] is True, out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0.0 < m["reduce_ms.query"] < m["host_ms.query"]

    # the window's spans in their integer ns, which no rounding of the ms
    # can tie
    s = _spans.session()

    def self_ns(match):
        return sum(t for span, t in zip(s.spans, s.self_ns)
                   if match(span.name))

    reduce_ns = self_ns(lambda name: name == "qcmrf.moments.reduce")
    cli_ns = self_ns(lambda name: name == "qcmrf.infer"
                     or name.startswith("qcmrf.infer."))
    sweep_ns = self_ns(lambda name: name == "qcmrf.kernels.sweep")
    host_ns = (sum(span.ns for span in s.spans if span.parent is None)
               - sum(span.ns for span in s.spans if span.name == _spans.WAIT))
    units = out["attempted"]
    assert m["reduce_ms.query"] == pytest.approx(1e-6 * reduce_ns / units)
    assert m["host_ms.query"] == pytest.approx(1e-6 * host_ns / units)
    # a part of the host's time beside the CLI's own code and the sweeps
    assert reduce_ns + cli_ns + sweep_ns <= host_ns
