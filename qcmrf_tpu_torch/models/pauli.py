"""Pauli algebra of diagonal (I/Z) operators (port of
:mod:`qcmrf_tpu.models.pauli`, host-side).

The QCMRF sufficient statistics and Hamiltonian are tensor products of
``I``, ``(I+Z)/2`` and ``(I-Z)/2``, all diagonal in the computational
basis, so an operator is a sparse sum of Z-strings: a Z-support bitmask and
its real coefficient. :meth:`PauliSum.diagonal` evaluates the dense
diagonal as a torch tensor on a device.

Bitmask convention: bit ``(n-1-v)`` of a mask is variable ``v`` (variable
0 is the most significant bit of a state id), as in
:mod:`qcmrf_tpu_torch.utils.bits`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class PauliSum:
    """Real linear combination of Z-strings on ``n`` qubits:
    ``terms[mask]`` is the coefficient of ``prod_{v in mask} Z_v``, the
    identity being ``mask == 0``."""

    n: int
    terms: Tuple[Tuple[int, float], ...]  # sorted (mask, coeff) pairs

    @staticmethod
    def from_dict(n: int, d: Dict[int, float]) -> "PauliSum":
        items = tuple(sorted((m, float(c)) for m, c in d.items() if c != 0.0))
        return PauliSum(n=n, terms=items)

    def as_dict(self) -> Dict[int, float]:
        return dict(self.terms)

    # ---- algebra --------------------------------------------------------

    def __add__(self, other: "PauliSum") -> "PauliSum":
        assert self.n == other.n
        d = dict(self.terms)
        for m, c in other.terms:
            d[m] = d.get(m, 0.0) + c
        return PauliSum.from_dict(self.n, d)

    def __mul__(self, scalar: float) -> "PauliSum":
        return PauliSum.from_dict(
            self.n, {m: c * scalar for m, c in self.terms}
        )

    __rmul__ = __mul__

    def __matmul__(self, other: "PauliSum") -> "PauliSum":
        """Operator product; Z-strings multiply by XOR of masks."""
        assert self.n == other.n
        d: Dict[int, float] = {}
        for m1, c1 in self.terms:
            for m2, c2 in other.terms:
                m = m1 ^ m2
                d[m] = d.get(m, 0.0) + c1 * c2
        return PauliSum.from_dict(self.n, d)

    def adjoint(self) -> "PauliSum":
        """Z-strings with real coefficients are self-adjoint."""
        return self

    # ---- evaluation ------------------------------------------------------

    def diagonal(self, device=None) -> torch.Tensor:
        """Dense float64 diagonal over the ``2**n`` computational-basis
        states, on ``device`` (the current CUDA device unless one is
        named). The eigenvalue of ``Z_S`` at ``x`` is ``(-1)^{popcount(x
        & S)}``."""
        device = resolve_device(device)
        x = torch.arange(1 << self.n, dtype=torch.int64, device=device)
        out = torch.zeros(1 << self.n, dtype=torch.float64, device=device)
        for mask, coeff in self.terms:
            par = x & mask
            shift = 32
            while shift:  # fold the bits onto bit 0: the parity
                par = par ^ (par >> shift)
                shift //= 2
            out += coeff * (1.0 - 2.0 * (par & 1).double())
        return out


def identity(n: int) -> PauliSum:
    return PauliSum.from_dict(n, {0: 1.0})


def z_on(n: int, v: int) -> PauliSum:
    return PauliSum.from_dict(n, {1 << (n - 1 - v): 1.0})


def projector(n: int, v: int, value: int) -> PauliSum:
    """``|value><value|`` on variable ``v``: ``(I +/- Z)/2``."""
    sign = 1.0 if value == 0 else -1.0
    return PauliSum.from_dict(n, {0: 0.5, 1 << (n - 1 - v): 0.5 * sign})


def sufficient_statistic(n: int, C: Sequence[int],
                         y: Sequence[int]) -> PauliSum:
    """Pauli-Markov sufficient statistic ``phi_{C,y}``: ``(I+Z)/2`` on the
    variables with ``y_i = 0``, ``(I-Z)/2`` on those with ``y_i = 1``,
    identity elsewhere."""
    result = identity(n)
    for v, yi in zip(C, y):
        result = result @ projector(n, v, int(yi))
    return result


def hamiltonian(n: int, cliques, theta) -> PauliSum:
    """MRF Hamiltonian ``H = sum_i -theta_i * phi_i``; its diagonal is
    ``-theta^T phi(x)`` per state."""
    H = PauliSum.from_dict(n, {})
    i = 0
    theta = np.asarray(theta, dtype=np.float64)
    for C in cliques:
        for y in itertools.product([0, 1], repeat=len(C)):
            H = H + sufficient_statistic(n, C, y) * float(-theta[i])
            i += 1
    return H


def conjugate_blocks(A: PauliSum) -> PauliSum:
    """Block operator with ``A`` and ``A-dagger`` on its diagonal, on n+1
    qubits: ``((I+Z)/2) ⊗ A + ((I-Z)/2) ⊗ A-dagger`` with the new qubit as
    the leading (most significant) variable. ``A`` is self-adjoint in this
    algebra, so the two blocks coincide: ``I ⊗ A``."""
    d: Dict[int, float] = {}
    for m, c in A.terms:
        d[m] = d.get(m, 0.0) + c
    return PauliSum.from_dict(A.n + 1, d)
