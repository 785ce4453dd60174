"""The training cell's start: drawn again from the same stream while an
entry of the reference's first gradient lies within the mix's
``start_gradient_floor`` of zero, where the sign of Adam's first step on
it would be float32 rounding's."""

import torch

from benchmark import harness
from benchmark.trace import Spans

SPEC = harness.load_spec()
CELL = next(w["name"] for w in SPEC["workloads"]
            if harness.cell_inputs(SPEC, w["name"])[2]["loop"] == "train")


def start(cfg, mix, seed):
    loop = harness.load_module("loops", "train").Loop(
        cfg, mix, seed, torch.device("cpu"), Spans(False))
    g1 = loop.ref.train_reference(loop.cliques, loop.n, loop.beta,
                                  loop.theta0.double(), loop.data, 1,
                                  loop.lr)["grad1"]
    return loop, float(g1.abs().min())


def test_the_start_is_drawn_again_while_a_gradient_entry_is_near_zero(
        small):
    cfg, mix = small(CELL)
    first, least = start(cfg, {**mix, "start_gradient_floor": 0.0}, 61)
    assert first.start_draws == 1
    floor = 1.5 * least
    loop, kept = start(cfg, {**mix, "start_gradient_floor": floor}, 61)
    assert loop.start_draws > 1
    assert kept >= floor
    again, _ = start(cfg, {**mix, "start_gradient_floor": floor}, 61)
    assert torch.equal(again.theta0, loop.theta0)
    assert not torch.equal(loop.theta0, first.theta0)
