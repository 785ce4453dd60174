"""The shots loop: its histogram read into one pinned buffer, the calls
kept for the comparison holding their own histograms, and ``marg_z``
seeing accepted states that the histogram's pooled bins hide."""

import numpy as np
import torch

from benchmark import harness
from benchmark.trace import Spans


def loop(config, mix, seed=3 << 33):
    module = harness.load_module("loops", "shots")
    return module.Loop(config, mix, seed, torch.device("cpu"), Spans(False))


def test_the_buffer_holds_each_calls_histogram(small):
    run = loop(*small("grid20.shots"))
    for i in range(3):
        theta, hist = run._call(i)
        assert hist.sum() == run.shots
        assert np.array_equal(hist.numpy(), run.host.numpy())


def test_kept_calls_do_not_share_the_pinned_buffer(small):
    run = loop(*small("grid20.shots"))
    run.warm_up()
    run.window(0.2)
    assert len(run.kept) >= 2
    buffer = run.host.numpy()
    hists = [h.numpy() for _, h in run.kept.values()]
    assert not any(np.shares_memory(h, buffer) for h in hists)
    assert not np.array_equal(hists[0], hists[1])
    assert all(c.ok for c in run.checks())


def test_marg_z_sees_accepted_states_the_pooled_histogram_hides(small):
    # a 3x4 grid at 2**16 shots: every accepted state expects under 5
    # shots, so the histogram pools them all; a sampler that reports the
    # last variable 0 for every accepted shot keeps the count and the
    # pooled bins, and only marg_z sees it
    cfg, mix = small("grid20.shots")
    cfg = {**cfg, "rows": 3, "cols": 4, "n": 12}
    mix = {**mix, "shots_per_call": 1 << 16}
    readings = {}
    for fault in (False, True):
        run = loop(cfg, mix)
        if fault:
            inner = run.system

            def system(key, stream, theta):
                x, a = inner(key, stream, theta)
                return torch.where(a == 0, x & ~1, x), a

            run.system = system
        for i in range(4):
            run.kept[i] = run._call(i)
        readings[fault] = {c.name: (c.value, c.ok) for c in run.checks()}
    sound, broken = readings[False], readings[True]
    assert all(ok for _, ok in sound.values()), sound
    assert broken["count_z"] == sound["count_z"]
    assert broken["hist_z"] == sound["hist_z"]
    assert broken["marg_z"][1] is False, broken
