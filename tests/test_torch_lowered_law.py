"""The lowered QCMRF circuit's law, as the benchmark's ``chain13.lowered``
cell runs it: ``simulate_probs(lower(compile_qcmrf(model)))`` in the
``fused`` style, its post-selected probabilities and their sum delta held
to the benchmark's plain float64 PyTorch reference
(``benchmark/reference/pairwise_mrf.py``, loaded by its path) within the
cell's own ``post_rel`` and ``delta_rel`` limits, read from its traffic
file; a lowered gate list with one phase dropped or moved fails them. And
``lower``'s span and counter: recorded only under a profiler session, the
gate list unchanged."""

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler

torch.set_num_threads(1)

from qcmrf_tpu_torch.circuits import lower as L  # noqa: E402
from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf  # noqa: E402
from qcmrf_tpu_torch.circuits.ir import Circuit  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.sim import planes  # noqa: E402
from qcmrf_tpu_torch.utils import profiling  # noqa: E402

BENCHMARK = Path(__file__).resolve().parents[1] / "benchmark"
LIMITS = json.loads((BENCHMARK / "traffic" / "lowered.json")
                    .read_text())["limits"]
SCALES = json.loads((BENCHMARK / "configs" / "chain13.json")
                    .read_text())["theta_scales"]


def _reference():
    spec = importlib.util.spec_from_file_location(
        "lowered_law_reference", BENCHMARK / "reference" / "pairwise_mrf.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def chain(n):
    return [(i, i + 1) for i in range(n - 1)]


def theta_of(n, scale, seed):
    g = torch.Generator().manual_seed(seed)
    return -torch.randn(4 * (n - 1), generator=g).abs() * scale


def lowered(n, theta):
    model = MRF.create(chain(n), n=n, theta=theta, device="cpu")
    return L.lower(compile_qcmrf(model, with_measurements=False),
                   style="fused")


def readings(n, theta, circuit):
    """(post_rel, delta_rel) of the circuit's post-selected law against
    the reference, as the benchmark's circuit loop reads them."""
    post = planes.simulate_probs(circuit, "cpu")[:1 << n].double()
    model = REF.PairwiseMRF(chain(n), theta.double(), n, 1.0)
    q, d = model.postselected(model.table())
    delta = float(post.sum())
    return (float((post - q).abs().max() / q.max()),
            abs(delta - float(d)) / float(d))


@pytest.mark.parametrize("n", [4, 6])
@pytest.mark.parametrize("scale", SCALES)
def test_the_lowered_chain_holds_the_reference_law(n, scale):
    theta = theta_of(n, scale, 1000 * n + int(100 * scale))
    circuit = lowered(n, theta)
    assert {g.name for g in circuit.gates} <= set(L.BASIS)
    post_rel, delta_rel = readings(n, theta, circuit)
    assert post_rel <= LIMITS["post_rel"]
    assert delta_rel <= LIMITS["delta_rel"]


def phase_on_an_ancilla(circuit, n):
    """The first ``rz`` on an ancilla (a qubit above the workspace ``n``)
    whose angle is at least 0.1 and no multiple of pi/2: a phase of a
    clique's Z-string rotation, which reaches the outcome law (an ``rz``
    on a variable is diagonal up to its measurement)."""
    for i, g in enumerate(circuit.gates):
        if g.name == "rz" and g.qubits[0] > n and abs(g.params[0]) >= 0.1:
            turns = g.params[0] / (math.pi / 2)
            if abs(turns - round(turns)) > 1e-6:
                return i
    raise AssertionError("no phase rz of at least 0.1 on an ancilla")


def dropped(circuit, i):
    return Circuit(circuit.num_qubits, circuit.num_clbits,
                   gates=circuit.gates[:i] + circuit.gates[i + 1:],
                   global_phase=circuit.global_phase, name=circuit.name)


def moved(circuit, i):
    gates = list(circuit.gates)
    gates[i] = gates[i].with_params((gates[i].params[0] + 1e-2,))
    return Circuit(circuit.num_qubits, circuit.num_clbits, gates=gates,
                   global_phase=circuit.global_phase, name=circuit.name)


@pytest.mark.parametrize("broken", [dropped, moved])
def test_a_dropped_or_moved_phase_fails_the_limit(broken):
    n = 6
    theta = theta_of(n, SCALES[1], 6025)
    circuit = lowered(n, theta)
    post_rel, _ = readings(n, theta, broken(
        circuit, phase_on_an_ancilla(circuit, n)))
    assert post_rel > LIMITS["post_rel"]


def test_lower_records_its_span_and_gates_under_a_session():
    circuit = compile_qcmrf(MRF.create(chain(5), n=5,
                                       theta=theta_of(5, 0.25, 7),
                                       device="cpu"),
                            with_measurements=False)
    with profiler.profile(use_kineto=True):
        out = L.lower(circuit, style="fused")
    spans = profiling.session_spans()
    assert [s.name for s in spans] == ["qcmrf.circuit.lower"]
    assert profiling.session_counts()["basis_gate"] == len(out.gates)
    assert spans[0].counts == {"basis_gate": len(out.gates)}


def test_lower_records_nothing_off_and_keeps_its_gate_list():
    circuit = compile_qcmrf(MRF.create(chain(5), n=5,
                                       theta=theta_of(5, 0.5, 8),
                                       device="cpu"))
    with profiler.profile(use_kineto=True):
        pass
    before = (profiling.session_spans(), profiling.session_counts())
    for style, optimize in [("fused", 0), ("fused", 1), ("literal", 0)]:
        out = L.lower(circuit, style=style, optimize=optimize)
        plain = L.lower.__wrapped__(circuit, style=style, optimize=optimize)
        assert out.gates == plain.gates
        assert out.global_phase == plain.global_phase
    assert (profiling.session_spans(), profiling.session_counts()) == before
