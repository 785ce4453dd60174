"""Dense complex statevector engine over the circuit IR (port of
:mod:`qcmrf_tpu.sim.dense`).

Evolves a complex statevector (complex64 unless a caller asks for
complex128) with **qubit 0 as the least-significant bit** of the state
index, so the final ``|psi|^2`` is indexed by ``int(key, 2)`` of the
measurement keys. It runs on the device its state lies on (a new state
goes to the current CUDA device unless the caller names one) and has no
kernel: it is the oracle that the gate-level kernels
(:mod:`qcmrf_tpu_torch.ops.circuit_kernel`, :mod:`qcmrf_tpu_torch.sim.planes`)
are held against.

* a non-diagonal gate is a reshape and a contraction;
* a diagonal gate (rz / cp / flags_phase) multiplies by a phase selected
  with bit tests on the state index;
* mid-circuit measurements are deferred (exact for QCMRF: measured
  ancillas are never reused), so one run yields the whole joint outcome
  distribution.
"""

from __future__ import annotations

import cmath
import functools
import math
from typing import Optional

import numpy as np
import torch

from qcmrf_tpu_torch.circuits.ir import Circuit, Gate
from qcmrf_tpu_torch.utils.config import resolve_device

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

_GATES_1Q_EXACT = {
    "h": np.array([[_INV_SQRT2, _INV_SQRT2], [_INV_SQRT2, -_INV_SQRT2]],
                  dtype=np.complex128),
    "x": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "sx": 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]],
                         dtype=np.complex128),
    "sxdg": 0.5 * np.array([[1 - 1j, 1 + 1j], [1 + 1j, 1 - 1j]],
                           dtype=np.complex128),
    "id": np.eye(2, dtype=np.complex128),
}
#: the JAX package's complex64 gate matrices (the planner composes these)
GATES_1Q = {k: v.astype(np.complex64) for k, v in _GATES_1Q_EXACT.items()}

_CX = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
               dtype=np.complex64)  # rows/cols indexed by (bit_c, bit_t)


def zero_state(num_qubits: int, dtype=torch.complex64,
               device=None) -> torch.Tensor:
    state = torch.zeros((1 << num_qubits,), dtype=dtype,
                        device=resolve_device(device))
    state[0] = 1.0
    return state


def _as(U, state: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(U), device=state.device).to(state.dtype)


def apply_1q(state: torch.Tensor, U, q: int,
             num_qubits: int) -> torch.Tensor:
    """Apply a 2x2 unitary to qubit ``q`` (LSB convention)."""
    lo = 1 << q
    hi = 1 << (num_qubits - 1 - q)
    st = state.reshape(hi, 2, lo)
    return torch.einsum("ab,hbl->hal", _as(U, state), st).reshape(-1)


def apply_2q(state: torch.Tensor, U4, qa: int, qb: int,
             num_qubits: int) -> torch.Tensor:
    """Apply a 4x4 unitary to qubits (qa, qb); row/col index = (bit_a,
    bit_b)."""
    if qa == qb:
        raise ValueError("qubits must differ")
    U4 = np.asarray(U4)
    if qa < qb:
        qa, qb = qb, qa
        U4 = U4.reshape(2, 2, 2, 2).transpose(1, 0, 3, 2).reshape(4, 4)
    hi = 1 << (num_qubits - 1 - qa)
    mid = 1 << (qa - qb - 1)
    lo = 1 << qb
    st = state.reshape(hi, 2, mid, 2, lo)
    Ur = _as(U4.reshape(2, 2, 2, 2), state)
    return torch.einsum("abcd,hcmdl->hambl", Ur, st).reshape(-1)


def _bit(idx: torch.Tensor, q: int) -> torch.Tensor:
    return (idx >> q) & 1


@functools.lru_cache(maxsize=8)
def _state_indices(num_qubits: int, device: torch.device) -> torch.Tensor:
    return torch.arange(1 << num_qubits, dtype=torch.int64, device=device)


def apply_diagonal_phase(state: torch.Tensor, mask: torch.Tensor,
                         angle: float) -> torch.Tensor:
    phase = torch.tensor(cmath.exp(1j * float(angle)), dtype=state.dtype,
                         device=state.device)
    return torch.where(mask, state * phase, state)


def apply_gate(state: torch.Tensor, g: Gate,
               num_qubits: int) -> torch.Tensor:
    name = g.name
    if name in GATES_1Q:
        return apply_1q(state, _GATES_1Q_EXACT[name], g.qubits[0],
                        num_qubits)
    if name == "rz":
        lam = g.params[0]
        b = _bit(_state_indices(num_qubits, state.device), g.qubits[0])
        # diag(e^{-i lam/2}, e^{+i lam/2})
        lo = torch.tensor(cmath.exp(-0.5j * lam), dtype=state.dtype,
                          device=state.device)
        hi = torch.tensor(cmath.exp(0.5j * lam), dtype=state.dtype,
                          device=state.device)
        return state * torch.where(b == 1, hi, lo)
    if name == "cx":
        c, t = g.qubits
        return apply_2q(state, _CX, c, t, num_qubits)
    if name == "cp":
        c, t = g.qubits
        idx = _state_indices(num_qubits, state.device)
        mask = (_bit(idx, c) & _bit(idx, t)) == 1
        return apply_diagonal_phase(state, mask, g.params[0])
    if name == "flags_phase":
        *pattern, ctrl = g.qubits
        idx = _state_indices(num_qubits, state.device)
        mask = _bit(idx, ctrl) == 1
        for q, f in zip(pattern, g.flags):
            want = (f + 1) // 2  # +1 -> bit 1, -1 -> bit 0
            mask = mask & (_bit(idx, q) == want)
        return apply_diagonal_phase(state, mask, g.params[0])
    if name in ("barrier", "measure"):
        return state
    raise ValueError(f"unknown gate {name}")


def run_statevector(circuit: Circuit,
                    initial_state: Optional[torch.Tensor] = None,
                    dtype=torch.complex64, device=None) -> torch.Tensor:
    """Final statevector with measurements deferred. Without an
    ``initial_state`` the run starts from ``|0...0>`` of ``dtype`` on
    ``device`` (the current CUDA device unless one is named)."""
    nq = circuit.num_qubits
    state = (zero_state(nq, dtype, device) if initial_state is None
             else initial_state)
    for g in circuit.gates:
        state = apply_gate(state, g, nq)
    if circuit.global_phase:
        state = state * cmath.exp(1j * circuit.global_phase)
    return state


def outcome_probs(circuit: Circuit, state: torch.Tensor) -> torch.Tensor:
    """Joint distribution over classical-register values.

    Deferred-measurement semantics: clbit ``c`` reads the final value of
    its measured qubit; unwritten clbits are 0. Returns a
    ``2**num_clbits`` probability vector indexed by ``int(key, 2)``.
    """
    nq = circuit.num_qubits
    probs = state.abs() ** 2
    pairs = circuit.measured_pairs
    if not pairs:
        return probs
    idx = _state_indices(nq, state.device)
    keys = torch.zeros_like(idx)
    for q, c in pairs:
        keys = keys | (_bit(idx, q) << c)
    out = torch.zeros((1 << circuit.num_clbits,), dtype=probs.dtype,
                      device=probs.device)
    return out.index_add_(0, keys, probs)


def simulate_probs(circuit: Circuit, dtype=torch.complex64,
                   device=None) -> torch.Tensor:
    """Run + outcome distribution."""
    return outcome_probs(circuit, run_statevector(circuit, dtype=dtype,
                                                  device=device))


def statevector_fidelity(a: torch.Tensor, b: torch.Tensor) -> float:
    """|<a|b>|^2: compares engines up to global phase."""
    return float(torch.vdot(a, b).abs() ** 2)
