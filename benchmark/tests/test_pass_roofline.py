"""The lowered cell's three readers on inputs made by hand:
``pass_roofline`` on a synthetic trace (each kernel kind's bytes, PyTorch's
own operations left out of both sums, None with no kernel of its table,
exactly 100% for launches that take their bound), and ``lower_ms`` and
``basis_gates`` on a synthetic record of the program's spans, None
without one."""

import pytest

from benchmark import harness
from benchmark.metrics import _counts, _spans
from benchmark.trace import TraceSummary

PASS_ROOFLINE = harness.load_module("metrics", "pass_roofline")
LOWER_MS = harness.load_module("metrics", "lower_ms.circuit")
BASIS_GATES = harness.load_module("metrics", "basis_gates.circuit")

WIDTH = 20
#: the trace's names of the port's kernels: a template's with ``void``
ANON = "void (anonymous namespace)::"
PLAIN = "(anonymous namespace)::"
#: names as the trace gives them, and the bytes an amplitude
KINDS = [
    (PLAIN + "lane_factored_kernel(LaneFactors, int, float*, float*, long)",
     16),
    (ANON + "lane_kernel<2>(float const*, float*, float*, long)", 16),
    (ANON + "row_gate_kernel<1>(GateMatrix, float*, float*, long, int)", 16),
    (ANON + "row_gate_kernel<2>(GateMatrix, float*, float*, long, int)", 16),
    (PLAIN + "diag_kernel(unsigned char const*, int, float*, float*, long)",
     16),
    (ANON + "hdh_multi_kernel<1, false>(unsigned char const*, int, float*, "
     "float*, long, int)", 16),
    (ANON + "hdh_multi_kernel<7, true>(unsigned char const*, int, float*, "
     "float*, long, int)", 12),
    (ANON + "hdh_multi_uniform_kernel<7>(unsigned char const*, int, float*, "
     "float*, long, int, unsigned long long, float)", 8),
]
ATEN = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::mul_kernel_cuda(at::TensorIteratorBase&)>(int, ...)")


def run_of(trace=None, units=1, width=WIDTH):
    window = harness.Window(units=units, elapsed_s=1.0, attempted=units,
                            failed=0, work={"width": width})
    return harness.Run({}, {}, {}, window, 0.0, trace)


def trace_of(ops):
    """A trace of ``(name, seconds)`` kernels one after another."""
    device_ops, at = [], 0.0
    for name, s in ops:
        device_ops.append((name, at, s, "kernel"))
        at += s
    return TraceSummary(window_s=at, busy_s=at, device_ops=device_ops,
                        gaps=[])


def bound_s(per_amplitude, width=WIDTH):
    return _counts.bound_seconds(nbytes=per_amplitude << width)


@pytest.mark.parametrize("name,per_amplitude", KINDS)
def test_each_kernel_kind_counts_its_bytes(name, per_amplitude):
    assert PASS_ROOFLINE.bytes_per_amplitude(name) == per_amplitude
    # a launch that takes twice its bound reads 50%
    out = PASS_ROOFLINE.read(run_of(trace_of([(name,
                                               2 * bound_s(per_amplitude))])))
    assert out == pytest.approx(50.0, rel=1e-12)


def test_pytorch_operations_count_in_neither_sum():
    ops = [(name, bound_s(b)) for name, b in KINDS]
    alone = PASS_ROOFLINE.read(run_of(trace_of(ops)))
    with_aten = trace_of(ops + [(ATEN, 1.0), ("Memcpy DtoH", 0.5)])
    assert PASS_ROOFLINE.bytes_per_amplitude(ATEN) is None
    assert PASS_ROOFLINE.read(run_of(with_aten)) == pytest.approx(alone,
                                                                  rel=1e-12)


def test_launches_at_their_bound_read_exactly_100():
    ops = [(name, bound_s(b)) for name, b in KINDS] * 3
    assert PASS_ROOFLINE.read(run_of(trace_of(ops), units=3)) == \
        pytest.approx(100.0, rel=1e-12)


def test_no_kernel_of_the_table_reads_none():
    assert PASS_ROOFLINE.read(run_of(None)) is None
    assert PASS_ROOFLINE.read(run_of(trace_of([]))) is None
    assert PASS_ROOFLINE.read(run_of(trace_of([(ATEN, 1.0)]))) is None
    # a name without its kernel's base name is not one of the table
    assert PASS_ROOFLINE.bytes_per_amplitude(
        PLAIN + "copy_kernel(float4 const*, float4 const*, float4*, "
        "float4*, long, long)") is None


def session(spans, counts):
    """A record of the program's spans: ``spans`` as (name, ns, parent)."""
    from qcmrf_tpu_torch.utils.profiling import Span, self_times

    made, at = [], 0
    for name, ns, parent in spans:
        made.append(Span(name, at, at + ns, parent,
                         len(made) if parent is None else parent))
        at += ns
    return _spans.Session(made, self_times(made), counts)


def test_lower_ms_and_basis_gates_read_a_circuits_share(monkeypatch):
    record = session(
        [("qcmrf.circuit.compile", 1_000_000, None),
         ("qcmrf.circuit.lower", 12_000_000, None),
         ("qcmrf.planes.simulate", 900_000_000, None),
         ("qcmrf.circuit.lower", 14_000_000, None),
         ("qcmrf.planes.simulate", 900_000_000, None)],
        {"basis_gate": 2 * 1959, "fuse_hit": 2})
    monkeypatch.setattr(_spans, "session", lambda: record)
    assert LOWER_MS.read(run_of(units=2)) == pytest.approx(13.0)
    assert BASIS_GATES.read(run_of(units=2)) == 1959


def test_lower_ms_counts_its_self_time():
    # a child span of the lowering is not the lowering's time
    record = session([("qcmrf.circuit.lower", 10_000_000, None),
                      ("qcmrf.wait", 4_000_000, 0)], {"basis_gate": 7})
    assert _spans.self_ms(record, lambda n: n == LOWER_MS.NAME) == 6.0


def test_no_record_or_no_lowering_reads_none(monkeypatch):
    monkeypatch.setattr(_spans, "session", lambda: None)
    assert LOWER_MS.read(run_of()) is None
    assert BASIS_GATES.read(run_of()) is None
    # a program from before the span and the counter: other spans only
    record = session([("qcmrf.circuit.compile", 1_000_000, None),
                      ("qcmrf.planes.simulate", 9_000_000, None)],
                     {"fuse_hit": 1})
    monkeypatch.setattr(_spans, "session", lambda: record)
    assert LOWER_MS.read(run_of()) is None
    assert BASIS_GATES.read(run_of()) is None
