"""``reduce_ms.query``: the evidence reduction's self time a query, read
from the program's ``qcmrf.moments.reduce`` spans in a small traced
k27.infer run on the CPU, where the mix clamps evidence."""

import time

from benchmark import harness

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
    # a part of the host's time beside the CLI's own code and the sweeps
    assert (m["reduce_ms.query"] + m["cli_ms.query"] + m["sweep_ms.query"]
            <= m["host_ms.query"])
