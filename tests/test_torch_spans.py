"""The program's spans and counters (``utils.profiling.span``, ``count``,
``launch``) on the CPU: nothing recorded and no ``record_function``
entered while PyTorch's profiler is off; parents, requests and self
times while it is on; one record a profiler session; counts and launches
charged to the innermost span; the recorded starts on the clock of the
Kineto trace's events; and the spans that one infer CLI call, one
``simulate_probs``, one training step and one sampler call record."""

import contextlib
import io
import statistics
import time

import pytest
import torch
from torch.autograd import profiler

torch.set_num_threads(1)

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf  # noqa: E402
from qcmrf_tpu_torch.models import capability, train  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf  # noqa: E402
from qcmrf_tpu_torch.ops import kernels, sampler_kernel  # noqa: E402
from qcmrf_tpu_torch.runners import infer_cli  # noqa: E402
from qcmrf_tpu_torch.sim import analytic, planes  # noqa: E402
from qcmrf_tpu_torch.utils import profiling  # noqa: E402


def traced(fn):
    """``fn()`` under PyTorch's profiler; returns (its result, the
    session's spans)."""
    with profiler.profile(use_kineto=True):
        out = fn()
    return out, profiling.session_spans()


def names(spans) -> list:
    return [s.name for s in spans]


def children(spans, i) -> list:
    return [s.name for s in spans if s.parent == i]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    """While the profiler is off every span is the one shared no-op
    context, counts and launches charge no span, and record_function is
    never entered; LAUNCHES still counts the launch."""
    traced(lambda: None)
    entered = []
    monkeypatch.setattr(profiler, "record_function",
                        lambda name: entered.append(name))
    before = profiling.session_spans()
    launches = profiling.LAUNCHES["lse"]
    assert profiling.span("qcmrf.a") is profiling.span("qcmrf.b")
    with profiling.span("qcmrf.a"):
        profiling.count("c", 3)
        profiling.launch("lse")
        with profiling.span("qcmrf.a.b"):
            pass
    assert profiling.spanned("qcmrf.f")(lambda x: x + 1)(1) == 2
    assert profiling.LAUNCHES["lse"] == launches + 1
    profiling.LAUNCHES["lse"] = launches
    assert entered == []
    assert profiling.session_spans() == before
    assert profiling.session_counts() == {}


def test_nested_spans_parents_requests_and_self_times():
    """Two requests of nested spans: each span's parent is the enclosing
    one, every span of a request carries its outermost span's index, and
    a span's self time is its time less its children's."""
    def requests():
        for _ in range(2):
            with profiling.span("qcmrf.r"):
                with profiling.span("qcmrf.r.a"):
                    with profiling.span("qcmrf.r.a.x"):
                        time.sleep(0.002)
                time.sleep(0.001)
                with profiling.span("qcmrf.r.b"):
                    time.sleep(0.001)

    _, spans = traced(requests)
    assert names(spans) == ["qcmrf.r", "qcmrf.r.a", "qcmrf.r.a.x",
                            "qcmrf.r.b"] * 2
    assert [s.parent for s in spans] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [s.request for s in spans] == [0] * 4 + [4] * 4
    own = profiling.self_times(spans)
    for i, s in enumerate(spans):
        assert s.start_ns < s.end_ns
        assert own[i] == s.ns - sum(c.ns for c in spans if c.parent == i)
        assert own[i] >= 0
    # the outer span's own time holds its 1 ms sleep, the leaf's its 2 ms
    assert own[0] >= 1_000_000 and own[2] >= 2_000_000
    assert own[1] < own[2]


def test_each_profiler_session_has_its_own_record():
    """Two sessions back to back, nothing between them: each reads only
    its own spans."""
    def one(name):
        with profiling.span(name):
            profiling.count("n")

    _, first = traced(lambda: one("qcmrf.first"))
    assert names(first) == ["qcmrf.first"]
    _, second = traced(lambda: one("qcmrf.second"))
    assert names(second) == ["qcmrf.second"]
    assert second[0].request == 0 and second[0].parent is None
    assert profiling.session_counts() == {"n": 1}


def test_counts_and_launches_go_to_the_innermost_span():
    """count and launch charge the innermost open span; a count with no
    span open goes to the session; LAUNCHES counts every launch."""
    before = dict(profiling.LAUNCHES)

    def work():
        profiling.count("outside", 2)
        with profiling.span("qcmrf.outer"):
            profiling.count("c")
            with profiling.span("qcmrf.inner"):
                profiling.count("c", 4)
                profiling.launch("map")
                profiling.launch("map")
            profiling.launch("sampler")

    try:
        _, spans = traced(work)
        assert [s.counts for s in spans] == [
            {"c": 1, "launch.sampler": 1}, {"c": 4, "launch.map": 2}]
        assert profiling.session_counts() == {
            "outside": 2, "c": 5, "launch.map": 2, "launch.sampler": 1}
        assert profiling.LAUNCHES["map"] == before["map"] + 2
        assert profiling.LAUNCHES["sampler"] == before["sampler"] + 1
    finally:
        profiling.LAUNCHES.update(before)


def test_every_ops_module_shares_the_one_launch_dict():
    """Each ops module's LAUNCHES is profiling's, which names every
    hand-written kernel."""
    from qcmrf_tpu_torch.ops import circuit_kernel, gibbs_kernel

    for mod in (kernels, sampler_kernel, circuit_kernel, gibbs_kernel):
        assert mod.LAUNCHES is profiling.LAUNCHES
    assert set(profiling.LAUNCHES) == {
        "logpot", "lse", "map", "moments", "lnz_moments", "hdh_multi",
        "hdh_multi_probs", "hdh_multi_uniform", "hdh_multi_uniform_probs",
        "diag", "row_gate", "lane", "lane_factored", "copy", "fma_peak",
        "sampler", "circuit", "gibbs", "gibbs_ais"}


def test_spans_start_on_the_kineto_clock():
    """20 spans after warm-up: the median gap between a recorded start
    and the start of its record_function event in the trace is under
    100 us."""
    def spans(k):
        for i in range(k):
            with profiling.span(f"qcmrf.clock.{i}"):
                torch.ones(8).sum()

    traced(lambda: spans(5))
    with profiler.profile(use_kineto=True) as prof:
        spans(20)
    recorded = {s.name: s.start_ns for s in profiling.session_spans()}
    events = {e.name(): e.start_ns() for e in prof.kineto_results.events()
              if e.name() in recorded}
    assert set(events) == set(recorded)
    gaps = [abs(recorded[k] - events[k]) for k in recorded]
    assert statistics.median(gaps) < 100_000, gaps


def test_plan_span_counts_a_plan_built_anew():
    """kernels._plan under its span: a structure seen first builds its
    plan (one plan_build) and uploads its tables (a wait), the second
    time the caches serve both."""
    cliques = ((0, 1), (1, 2), (2, 3), (0, 3), (1, 3), (4, 5), (5, 6))

    def twice():
        for _ in range(2):
            kernels._plan(cliques, 7, torch.device("cpu"))

    kernels.split_plan.cache_clear()
    kernels._device_plan.cache_clear()
    _, spans = traced(twice)
    assert [(s.name, s.parent) for s in spans] == [
        ("qcmrf.kernels.plan", None), ("qcmrf.wait", 0),
        ("qcmrf.kernels.plan", None)]
    assert [s.counts for s in spans] == [{"plan_build": 1}, {}, {}]


def tree(spans) -> set:
    """(parent's name, name) of every span."""
    return {(spans[s.parent].name if s.parent is not None else None, s.name)
            for s in spans}


def test_infer_cli_call_records_its_stages(monkeypatch):
    """One streaming marginals query and one MAP query with evidence: the
    CLI's stages under ``qcmrf.infer``, routing, evidence reduction and
    the sweeps under the answer, the blocking reads as ``qcmrf.wait``;
    one request a call."""
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    argv = ["--graph", "chain:12", "--theta-scale", "0.3", "--platform",
            "cpu", "--evidence", "0=1"]

    def calls():
        with contextlib.redirect_stdout(io.StringIO()):
            for query in ("marginals", "map", "lnz"):
                infer_cli.main(argv + ["--query", query])

    _, spans = traced(calls)
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["qcmrf.infer"] * 3
    for i, s in enumerate(spans):
        assert s.request == max(r for r in roots if r <= i)
    assert set(children(spans, roots[0])) == {
        "qcmrf.infer.parse", "qcmrf.infer.load", "qcmrf.infer.model",
        "qcmrf.infer.answer", "qcmrf.infer.emit"}
    got = tree(spans)
    for edge in [("qcmrf.infer.answer", "qcmrf.infer.route"),
                 ("qcmrf.infer.answer", "qcmrf.moments.reduce"),
                 ("qcmrf.infer.answer", "qcmrf.kernels.sweep"),
                 ("qcmrf.kernels.sweep", "qcmrf.kernels.sweep"),
                 ("qcmrf.infer.answer", "qcmrf.wait")]:
        assert edge in got, edge
    assert all(s.name.startswith("qcmrf.") for s in spans)


def test_simulate_probs_records_the_plane_engine_stages():
    """compile_qcmrf reads theta back (a wait) under its span; one
    simulate_probs holds fuse, run and outcome."""
    mrf = chain_mrf(6, theta=-0.2 * torch.rand(5 * 4), device="cpu")

    def call():
        return planes.simulate_probs(compile_qcmrf(
            mrf, with_measurements=False), "cpu")

    probs, spans = traced(call)
    assert probs.numel() == 1 << (6 + 5 + 1)
    assert tree(spans) == {
        (None, "qcmrf.circuit.compile"),
        ("qcmrf.circuit.compile", "qcmrf.wait"),
        (None, "qcmrf.planes.simulate"),
        ("qcmrf.planes.simulate", "qcmrf.planes.fuse"),
        ("qcmrf.planes.simulate", "qcmrf.planes.run"),
        ("qcmrf.planes.simulate", "qcmrf.planes.outcome")}


def test_train_step_records_loss_backward_and_optimizer():
    """One make_train_step step: loss (with the fused sweep under it),
    backward and the optimizer's step under ``qcmrf.train.step``."""
    m = MRF.create([[0, 1], [1, 2], [0, 2]], n=3, device="cpu")
    raw = train._from_theta(-0.3 * torch.ones(12), True).requires_grad_()
    step = train.make_train_step(m, train.adam([raw], 0.05))
    data = torch.tensor([0, 3, 5, 6, 7])
    loss, spans = traced(lambda: step(data))
    assert torch.isfinite(loss)
    assert children(spans, 0) == ["qcmrf.train.loss", "qcmrf.train.backward",
                                  "qcmrf.train.optimizer"]
    assert ("qcmrf.train.loss", "qcmrf.kernels.sweep") in tree(spans)
    assert spans[0].name == "qcmrf.train.step" and all(
        s.request == 0 for s in spans)


def test_sampler_call_records_its_table_and_domain_check():
    """One sample_outcome_parts call: the domain check's read and the
    keep table, with its index upload, under ``qcmrf.sampler``."""
    m = chain_mrf(5, theta=-0.3 * torch.rand(16), device="cpu")
    (x, a), spans = traced(
        lambda: analytic.sample_outcome_parts(3, m, 256, 1))
    assert x.shape == a.shape == (256,)
    assert tree(spans) == {(None, "qcmrf.sampler"),
                           ("qcmrf.sampler", "qcmrf.wait"),
                           ("qcmrf.sampler", "qcmrf.sampler.table"),
                           ("qcmrf.sampler.table", "qcmrf.wait")}


def test_spanned_keeps_the_functions_name_and_result():
    @profiling.spanned("qcmrf.test.f")
    def f(x, y=2):
        """doc"""
        return x * y

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(3) == 6
    out, spans = traced(lambda: f(3, y=4))
    assert out == 12 and names(spans) == ["qcmrf.test.f"]


@pytest.mark.parametrize("fail", [False, True])
def test_a_span_closes_when_its_block_raises(fail):
    """A block that raises still closes its span and its parent takes the
    next one."""
    def work():
        with profiling.span("qcmrf.outer"):
            with contextlib.suppress(ValueError):
                with profiling.span("qcmrf.inner"):
                    if fail:
                        raise ValueError("x")
            with profiling.span("qcmrf.next"):
                pass

    _, spans = traced(work)
    assert [(s.name, s.parent) for s in spans] == [
        ("qcmrf.outer", None), ("qcmrf.inner", 0), ("qcmrf.next", 0)]
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
