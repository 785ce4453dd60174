"""Bit-order conventions for QCMRF state indexing (port of
:mod:`qcmrf_tpu.utils.bits`).

1. **Variable order / state id**: variable 0 is the MSB of the integer state
   id: ``x = sum_v bit_v << (n - 1 - v)``.
2. **Circuit qubit layout**: variable ``v`` lives on qubit ``(n-1) - v``,
   qubit ``n`` is the shared AND-workspace qubit, qubits ``n+1 .. n+K`` are
   the per-clique Hadamard-test ancillas.
3. **Measurement keys**: qiskit-style bitstrings, clbit 0 rightmost; the
   post-selected keys are exactly those with ``int(key, 2) < 2**n``.
"""

from __future__ import annotations

import torch


def var_bit(x, v, n: int):
    """Bit of variable ``v`` in state id ``x`` (variable 0 = MSB)."""
    return (x >> (n - 1 - v)) & 1


def var_to_qubit(v, n: int):
    """Circuit qubit holding variable ``v``."""
    return (n - 1) - v


def state_id_from_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """State id from per-variable bits ``bits[..., v]`` (variable 0 = MSB)."""
    weights = torch.tensor([1 << (n - 1 - v) for v in range(n)],
                           dtype=bits.dtype, device=bits.device)
    return (bits * weights).sum(dim=-1)


def bits_from_state_id(x: torch.Tensor, n: int) -> torch.Tensor:
    """Per-variable bits ``[..., v]`` of state id ``x`` (variable 0 = MSB)."""
    shifts = torch.tensor([n - 1 - v for v in range(n)], dtype=x.dtype,
                          device=x.device)
    return (x[..., None] >> shifts) & 1


def key_string(index: int, width: int) -> str:
    """Counts-dict key for a full-register outcome integer (qiskit order)."""
    return format(index, "0{}b".format(width))


def key_to_index(key: str) -> int:
    return int(key, 2)


def postselect_mask_size(n: int) -> int:
    """Number of accepted outcomes after post-selection (= 2**n)."""
    return 1 << n
