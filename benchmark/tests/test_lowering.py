"""The circuit loop's ``lowering`` option: a mix that names one runs each
QCMRF circuit lowered to ``[cx, id, rz, sx, x]`` inside the timed call,
and the comparison holds it to the same law. At chain15.circuit's small
size: correct, the post-selected probabilities the unlowered circuit's,
and the control and every fault of the loop fail it."""

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.trace import Spans

SPEC = harness.load_spec()
WORKLOAD = "chain15.circuit"
CIRCUIT = harness.load_module("loops", "circuit")


def fused(small):
    cfg, mix = small(WORKLOAD)
    return cfg, {**mix, "lowering": "fused"}


def test_a_lowered_run_is_correct_and_reads_the_unlowered_law(small,
                                                               monkeypatch):
    from qcmrf_tpu_torch.circuits import lower as lower_module

    cfg, mix = fused(small)
    lowered, loops = [], []
    inner = lower_module.lower

    def lower(circuit, style):
        out = inner(circuit, style=style)
        lowered.append(set(g.name for g in out.gates))
        return out

    class Seen(CIRCUIT.Loop):
        def __init__(self, *args):
            super().__init__(*args)
            loops.append(self)

    monkeypatch.setattr(lower_module, "lower", lower)
    monkeypatch.setattr(CIRCUIT, "Loop", Seen)
    out = harness.run_cell(SPEC, WORKLOAD, 61, 0.3, False, "cpu",
                           time.perf_counter(), config=cfg, mix=mix)
    assert out["correct"] is True, out["checks"]
    # every timed call lowered its circuit to the basis
    assert len(lowered) >= 2 + out["attempted"]
    assert set().union(*lowered) <= set(lower_module.BASIS)

    plain_mix = {k: v for k, v in mix.items() if k != "lowering"}
    plain = CIRCUIT.Loop(cfg, plain_mix, 61, torch.device("cpu"),
                         Spans(False))
    kept = list(loops[0].kept.values())
    assert kept
    for theta, post, _ in kept:
        want = plain.system(theta)[:1 << plain.n]
        assert float((post - want).abs().max() / want.max()) <= 1e-4


def test_the_control_fails_a_lowered_cell(small):
    cfg, mix = fused(small)
    for seed in (41, 42, 43):
        out = control.read(SPEC, WORKLOAD, seed, 0.3, "control", "cpu", cfg,
                           mix)
        assert out["over_limit"], out["checks"]


@pytest.mark.parametrize("fault", list(CIRCUIT.FAULTS))
def test_a_broken_lowered_run_is_not_correct(small, monkeypatch, fault):
    cfg, mix = fused(small)

    class Broken(CIRCUIT.Loop):
        def __init__(self, *args):
            super().__init__(*args)
            self.system = CIRCUIT.FAULTS[fault](self)

    monkeypatch.setattr(CIRCUIT, "Loop", Broken)
    out = harness.run_cell(SPEC, WORKLOAD, 53, 0.3, False, "cpu",
                           time.perf_counter(), config=cfg, mix=mix)
    assert out["correct"] is False, out["checks"]
