"""QCMRF circuit compiler: MRF -> circuit IR (port of
:mod:`qcmrf_tpu.circuits.compiler`, the same gate list).

* qubit budget ``n + num_cliques + 1``: qubits ``0..n-1`` hold the
  variables with the reflection ``v -> (n-1)-v``, qubit ``n`` is the shared
  AND-workspace qubit (only a basis-gate lowering materialises it), qubits
  ``n+1+ii`` are the per-clique ancillas;
* a Hadamard wall on the variable qubits;
* per clique a controlled factor unitary cU_C of per-state blocks, one
  fused ``flags_phase`` per clique state, skipping a gamma that
  ``np.isclose`` calls 0;
* the real-part-extraction sandwich H · cU_C · X · cU_C^-1 · X · H on the
  clique ancilla;
* ancilla and variable measurements.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import List, Sequence

import numpy as np
import torch

from qcmrf_tpu_torch.circuits import params as cparams
from qcmrf_tpu_torch.circuits.ir import Circuit
from qcmrf_tpu_torch.circuits.lower import lower
from qcmrf_tpu_torch.models import pauli
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.utils import profiling


def _theta64(mrf: MRF) -> np.ndarray:
    with profiling.span("qcmrf.wait"):
        theta = mrf.theta.detach().cpu()
    return theta.numpy().astype(np.float64)


@dataclasses.dataclass
class QCMRF:
    """A compiled QCMRF: the MRF model plus its measurement circuit (the
    facade of :class:`qcmrf_tpu.circuits.compiler.QCMRF`, same constructor
    arguments and properties)."""

    #: default lowering basis
    DEFAULT_BASIS_GATES = ("cx", "id", "rz", "sx", "x")

    mrf: MRF
    circuit: Circuit
    with_measurements: bool = True
    with_barriers: bool = False
    basis_gates: Sequence[str] = DEFAULT_BASIS_GATES

    # ---- constructor ------------------------------------------------------

    @staticmethod
    def build(
        cliques: Sequence[Sequence[int]],
        theta=None,
        gamma=None,
        beta: float = 1.0,
        name: str = "QCMRF",
        with_measurements: bool = True,
        with_barriers: bool = False,
        basis_gates: Sequence[str] = DEFAULT_BASIS_GATES,
        init_key: torch.Generator = None,
    ) -> "QCMRF":
        """``init_key`` (a ``torch.Generator``) draws the U(-5, 0) default
        theta when neither ``theta`` nor ``gamma`` is given; without it
        numpy's global generator draws it."""
        probe = MRF.create(cliques, device="cpu")
        dim = probe.dimension
        if gamma is not None:
            gamma = np.asarray(gamma, dtype=np.float64)
            if gamma.shape != (dim,):
                raise ValueError(
                    "The QCMRF parameter vector has an incorrect dimension. "
                    f"Expected: {dim}"
                )
            # gamma must map to a finite theta <= 0, i.e. cos(2*gamma) in
            # (0, 1] (|gamma| < pi/4); other gammas define no MRF
            if not np.all(np.cos(2.0 * gamma) > 0.0):
                raise ValueError(
                    "gamma must satisfy |gamma| < pi/4 so that "
                    "cos(2*gamma) in (0, 1] defines a valid MRF weight"
                )
            theta = np.asarray(cparams.gamma_to_theta(gamma, beta))
        elif theta is None:
            if init_key is not None:
                theta = torch.empty(dim, dtype=torch.float64).uniform_(
                    -5.0, 0.0, generator=init_key).numpy()
            else:
                theta = np.random.uniform(low=-5.0, high=0.0, size=dim)
        else:
            theta = np.asarray(theta, dtype=np.float64)
            if theta.shape != (dim,):
                raise ValueError(
                    "The parameter vector has an incorrect dimension. "
                    f"Expected: {dim}"
                )
            cparams.validate_theta_domain(theta)

        mrf = MRF.create(cliques, theta=theta, beta=beta, device="cpu")
        circuit = compile_qcmrf(
            mrf,
            with_measurements=with_measurements,
            with_barriers=with_barriers,
            name=name,
        )
        return QCMRF(
            mrf=mrf,
            circuit=circuit,
            with_measurements=with_measurements,
            with_barriers=with_barriers,
            basis_gates=tuple(basis_gates),
        )

    # ---- properties -------------------------------------------------------

    @property
    def dimension(self) -> int:
        return self.mrf.dimension

    @property
    def cliques(self):
        return [list(C) for C in self.mrf.cliques]

    @property
    def num_vertices(self) -> int:
        return self.mrf.n

    num_nodes = num_vertices

    @property
    def num_cliques(self) -> int:
        return self.mrf.num_cliques

    @property
    def max_clique(self) -> int:
        return self.mrf.max_clique

    @property
    def theta(self) -> List[float]:
        return _theta64(self.mrf).tolist()

    @property
    def gamma(self) -> List[float]:
        g = cparams.theta_to_gamma(_theta64(self.mrf), float(self.mrf.beta))
        return np.asarray(g).tolist()

    @property
    def num_qubits(self) -> int:
        return self.circuit.num_qubits

    def lowered(self, style: str = "fused", optimize: int = 0) -> Circuit:
        """The circuit lowered to ``self.basis_gates`` (only the default
        basis is implemented; another raises). ``optimize=1`` merges each
        clique's run of phases into one exact diagonal synthesis."""
        if set(self.basis_gates) != set(self.DEFAULT_BASIS_GATES):
            raise ValueError(
                f"unsupported basis {self.basis_gates!r}; the lowering "
                f"pass targets {self.DEFAULT_BASIS_GATES!r}"
            )
        # the workspace is qubit n of the compiler's layout, which the IR
        # alone does not know
        return lower(self.circuit, style=style, workspace=self.mrf.n,
                     optimize=optimize)

    # ---- operator-level helpers -------------------------------------------

    def sufficient_statistic(self, C, y) -> pauli.PauliSum:
        """Pauli-Markov sufficient statistic ``phi_{C,y}`` as a Z-string
        sum."""
        return pauli.sufficient_statistic(self.mrf.n, C, y)

    def Hamiltonian(self) -> pauli.PauliSum:
        """Diagonal MRF Hamiltonian ``H = sum_i -theta_i phi_i``."""
        return pauli.hamiltonian(self.mrf.n, self.mrf.cliques,
                                 _theta64(self.mrf))

    def _conjugate_blocks(self, A: pauli.PauliSum) -> pauli.PauliSum:
        """Block operator ``diag(A, A-dagger)`` on one more qubit."""
        return pauli.conjugate_blocks(A)

    # ---- layout -----------------------------------------------------------

    @property
    def workspace_qubit(self) -> int:
        return self.mrf.n

    @property
    def ancilla_qubits(self) -> List[int]:
        n = self.mrf.n
        return [n + 1 + ii for ii in range(self.mrf.num_cliques)]


@functools.lru_cache(maxsize=64)
def _skeleton(cliques, n: int, with_measurements: bool, with_barriers: bool,
              name: str, skip: bytes):
    """The gates of the QCMRF circuit of ``cliques`` over ``n`` variables
    with every phase angle 0, and the slots that take the angles:
    ``(gates, slots)``, each slot ``(position in gates, gamma index,
    negate)``. ``skip`` holds one byte a gamma, nonzero where the skip rule
    drops it. Each build (a miss of its cache) is counted as
    ``skeleton_build``."""
    profiling.count("skeleton_build")
    num_main = n + 1  # variables + workspace
    nq = n + len(cliques) + 1
    qc = Circuit(num_qubits=nq, num_clbits=nq, name=name)
    slots = []

    for q in range(n):
        qc.h(q)
    if with_barriers:
        qc.barrier()

    i = 0
    for ii, C in enumerate(cliques):
        anc = num_main + ii
        var_qubits = [(n - 1) - v for v in C]  # variable reflection

        # cU_C as a list of fused per-state diagonal phases
        blocks = []  # (flags, gamma index)
        for y in itertools.product([0, 1], repeat=len(C)):
            if not skip[i]:  # skip rule
                blocks.append((tuple(int(b) * 2 - 1 for b in y), i))
            i += 1

        # real part extraction: H · cU_C · X · cU_C^-1 · X · H
        qc.h(anc)
        for flags, k in blocks:
            slots.append((len(qc.gates), k, False))
            qc.flags_phase(var_qubits, flags, 0.0, control=anc)
        qc.x(anc)
        for flags, k in reversed(blocks):
            slots.append((len(qc.gates), k, True))
            qc.flags_phase(var_qubits, flags, 0.0, control=anc)
        qc.x(anc)
        qc.h(anc)

        if with_measurements:
            qc.measure(anc, anc)  # success when 0
        if with_barriers:
            qc.barrier()

    if with_measurements:
        for q in range(n):
            qc.measure(q, q)

    return tuple(qc.gates), tuple(slots)


@profiling.spanned("qcmrf.circuit.compile")
def compile_qcmrf(
    mrf: MRF,
    with_measurements: bool = True,
    with_barriers: bool = False,
    name: str = "QCMRF",
) -> Circuit:
    """Emit the QCMRF circuit IR for an MRF (see module docstring). The
    gates are a skeleton kept per structure (cliques, ``n``, the options
    and the skip rule's mask) with this MRF's phase angles filled in."""
    theta = _theta64(mrf)
    cparams.validate_theta_domain(theta)
    gamma = np.asarray(
        cparams.theta_to_gamma(theta, float(mrf.beta)), dtype=np.float64
    )
    skip = np.isclose(gamma, 0)  # the skip rule, gamma by gamma
    gates, slots = _skeleton(mrf.cliques, mrf.n, bool(with_measurements),
                             bool(with_barriers), name, skip.tobytes())
    angles = (2.0 * gamma).tolist()
    gates = list(gates)
    for pos, k, negate in slots:
        angle = angles[k]
        gates[pos] = gates[pos].with_params((-angle if negate else angle,))
    nq = mrf.n + mrf.num_cliques + 1
    return Circuit(num_qubits=nq, num_clbits=nq, gates=gates, name=name)
