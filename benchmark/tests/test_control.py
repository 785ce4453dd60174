"""The comparison fails what it has to: the control (the reference in
bfloat16 in the program's place) fails a limit of every cell, and a run
with its timed path broken underneath comes out not correct, once for
each fault its cell can have."""

import time

import pytest

from benchmark import control, harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
#: each cell's loop module, which brings the faults its cells can have
LOOP = {w["name"]: harness.load_module(
    "loops", harness.cell_inputs(SPEC, w["name"])[2]["loop"])
    for w in SPEC["workloads"]}


@pytest.mark.parametrize("workload", CELLS)
def test_program_reads_within_the_limits(small, workload):
    cfg, mix = small(workload)
    out = control.read(SPEC, workload, 31, 0.3, "program", "cpu", cfg, mix)
    assert out["over_limit"] == [], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(small, workload):
    cfg, mix = small(workload)
    # a mix whose readings are statistical carries the size at which they
    # see a bias of bfloat16's (~0.3% of delta) under ``small_control``
    mix = {**mix, **mix.get("small_control", {})}
    for seed in (41, 42, 43):
        out = control.read(SPEC, workload, seed, 0.3, "control", "cpu", cfg,
                           mix)
        assert out["over_limit"], out["checks"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in LOOP[w].FAULTS])
def test_a_broken_timed_path_is_not_correct(small, monkeypatch, workload,
                                            fault):
    cfg, mix = small(workload)
    module = LOOP[workload]

    class Broken(module.Loop):
        def __init__(self, *args):
            super().__init__(*args)
            self.system = module.FAULTS[fault](self)

    monkeypatch.setattr(module, "Loop", Broken)
    out = harness.run_cell(SPEC, workload, 51, 0.3, False, "cpu",
                           time.perf_counter(), config=cfg, mix=mix)
    assert out["correct"] is False, out["checks"]


def test_a_training_fault_after_the_first_steps_is_not_correct(small,
                                                               monkeypatch):
    # the window's steps are checked too: a loss altered only after the
    # steps the reference follows makes the run incorrect
    cfg, mix = small("k27.train")
    module = harness.load_module("loops", "train")

    class Late(module.Loop):
        def __init__(self, *args):
            super().__init__(*args)
            inner, calls = self.system, [0]

            def system(batch):
                calls[0] += 1
                loss = inner(batch)
                return loss if calls[0] <= 3 else loss * 1.001

            self.system = system

    monkeypatch.setattr(module, "Loop", Late)
    out = harness.run_cell(SPEC, "k27.train", 52, 0.3, False, "cpu",
                           time.perf_counter(), config=cfg, mix=mix)
    assert out["checks"]["loss_rel"]["value"] < 1e-5
    assert out["correct"] is False, out["checks"]
