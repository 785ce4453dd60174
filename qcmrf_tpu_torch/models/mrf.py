"""Markov random field model core (port of :mod:`qcmrf_tpu.models.mrf`).

An :class:`MRF` over ``n`` binary variables is a frozen value:

* ``theta`` — flat float32 parameter tensor of dimension ``d = sum_C
  2**|C|``, laid out **clique-major**, within a clique in binary-counting
  order of the clique state ``y`` with ``y[0]`` slowest;
* ``beta`` — inverse temperature (a Python float, float32-representable);
* the clique structure and ``n``.

State ids use variable 0 as the **MSB**. ``theta`` lives on one device; the
whole-table quantities (:meth:`MRF.all_log_potentials`,
:meth:`MRF.log_partition`, :meth:`MRF.gibbs_probs`) go through
:mod:`qcmrf_tpu_torch.ops.kernels`, so a model on a CUDA device is evaluated
by the log-potential and streaming kernels. :meth:`MRF.log_partition` and
:meth:`MRF.nll` are differentiable in ``theta`` (the fused lnZ + moments
sweep is the backward); the table has no backward.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.utils import profiling
from qcmrf_tpu_torch.utils.config import resolve_device


def _normalize_cliques(cliques) -> Tuple[Tuple[int, ...], ...]:
    if (
        not isinstance(cliques, (list, tuple))
        or len(cliques) == 0
        or not isinstance(cliques[0], (list, tuple))
        or len(cliques[0]) == 0
        or not isinstance(cliques[0][0], (int, np.integer))
    ):
        raise ValueError(
            "The set of cliques is not set properly. "
            "Type must be list of list of int."
        )
    return tuple(tuple(int(v) for v in C) for C in cliques)


@dataclasses.dataclass(frozen=True)
class MRF:
    """A binary pairwise-or-higher-order MRF in log-linear form:
    ``p(x) = exp(beta * theta^T phi(x)) / Z(beta)`` with ``phi`` the
    one-hot clique-state indicator vector."""

    theta: torch.Tensor
    beta: float
    cliques: Tuple[Tuple[int, ...], ...]
    n: int

    # ---- constructors -------------------------------------------------

    @staticmethod
    def create(
        cliques: Sequence[Sequence[int]],
        theta=None,
        beta: float = 1.0,
        n: int = None,
        device=None,
    ) -> "MRF":
        """``n`` defaults to ``max clique variable + 1``; pass it
        explicitly when trailing variables appear in no clique. ``theta``
        lives on ``device``: the current CUDA device unless one is named
        (raising where there is none), as the JAX package puts it on the
        default device."""
        cliques = _normalize_cliques(cliques)
        device = resolve_device(device)
        n_min = max(v for C in cliques for v in C) + 1
        if n is None:
            n = n_min
        elif n < n_min:
            raise ValueError(
                f"n={n} is smaller than the largest clique variable "
                f"requires (>= {n_min})")
        dim = sum(1 << len(C) for C in cliques)
        if theta is None:
            theta = torch.zeros((dim,), dtype=torch.float32, device=device)
        else:
            theta = torch.as_tensor(theta, dtype=torch.float32)
            if theta.device != device:
                with profiling.span("qcmrf.wait"):
                    theta = theta.to(device)
            if tuple(theta.shape) != (dim,):
                raise ValueError(
                    "The parameter vector has an incorrect dimension. "
                    f"Expected: {dim}"
                )
        return MRF(theta=theta, beta=float(np.float32(beta)),
                   cliques=cliques, n=n)

    @staticmethod
    def from_numpy(cliques, theta: np.ndarray, beta: float = 1.0,
                   n: int = None, device=None) -> "MRF":
        """Carry a model across from its numpy parameters, e.g.
        ``MRF.from_numpy(m.cliques, np.asarray(m.theta), float(m.beta),
        m.n)`` for a :mod:`qcmrf_tpu` model ``m``."""
        theta = torch.from_numpy(np.asarray(theta, dtype=np.float32).copy())
        return MRF.create(cliques, theta=theta, beta=beta, n=n,
                          device=device)

    # ---- static structure ---------------------------------------------

    @property
    def num_vertices(self) -> int:
        return self.n

    num_nodes = num_vertices

    @property
    def num_cliques(self) -> int:
        return len(self.cliques)

    @property
    def dimension(self) -> int:
        return sum(1 << len(C) for C in self.cliques)

    @property
    def max_clique(self) -> int:
        return max(len(C) for C in self.cliques)

    @property
    def num_states(self) -> int:
        return 1 << self.n

    @property
    def device(self) -> torch.device:
        return self.theta.device

    @property
    def theta_offsets(self) -> Tuple[int, ...]:
        """Start offset of each clique's parameter block in ``theta``."""
        offs, o = [], 0
        for C in self.cliques:
            offs.append(o)
            o += 1 << len(C)
        return tuple(offs)

    @functools.cached_property
    def _index_tables(self):
        """Padded numpy constants used by the vectorized gathers.

        Returns (shifts, places, offsets):
          * ``shifts[k, i]`` — right-shift extracting variable ``i`` of
            clique ``k`` from a state id (``n-1-v``), 0 where padded.
          * ``places[k, i]`` — left-shift placing that bit into the clique
            state index ``y`` (``|C|-1-i``), with padded slots masked by -1.
          * ``offsets[k]`` — flat offset of clique ``k``'s block in theta.
        """
        K = self.num_cliques
        cmax = self.max_clique
        shifts = np.zeros((K, cmax), dtype=np.int64)
        places = np.full((K, cmax), -1, dtype=np.int64)
        for k, C in enumerate(self.cliques):
            m = len(C)
            for i, v in enumerate(C):
                shifts[k, i] = self.n - 1 - v
                places[k, i] = m - 1 - i
        offsets = np.asarray(self.theta_offsets, dtype=np.int64)
        return shifts, places, offsets

    # ---- clique-state indexing -----------------------------------------

    def clique_state_indices(self, x) -> torch.Tensor:
        """Index ``y`` of each clique's local state in state ids ``x``;
        shape ``x.shape + (num_cliques,)``."""
        shifts, places, _ = self._index_tables
        dev = self.device
        x = torch.as_tensor(x, dtype=torch.int64, device=dev)
        with profiling.span("qcmrf.wait"):
            sh = torch.from_numpy(shifts).to(dev)
            pl = torch.from_numpy(places).to(dev)
        bits = (x[..., None, None] >> sh) & 1  # (..., K, cmax)
        contrib = torch.where(pl >= 0, bits << pl.clamp(min=0),
                              torch.zeros_like(bits))
        return contrib.sum(dim=-1)

    def suff_stat_flat_indices(self, x) -> torch.Tensor:
        """Flat indices into ``theta`` of the active clique-states of ``x``."""
        _, _, offsets = self._index_tables
        idx = self.clique_state_indices(x)
        with profiling.span("qcmrf.wait"):
            offsets = torch.from_numpy(offsets).to(self.device)
        return idx + offsets

    def phi(self, x) -> torch.Tensor:
        """Dense one-hot sufficient-statistics vector(s), shape (..., d)."""
        idx = self.suff_stat_flat_indices(x)
        return torch.nn.functional.one_hot(
            idx, self.dimension).to(self.theta.dtype).sum(dim=-2)

    # ---- potentials & exact inference ----------------------------------

    def log_potential(self, x) -> torch.Tensor:
        """``theta^T phi(x)`` for integer state ids ``x`` (any shape)."""
        return self.theta[self.suff_stat_flat_indices(x)].sum(dim=-1)

    def all_log_potentials(self) -> torch.Tensor:
        """``theta^T phi(x)`` for all ``2**n`` states (the log-potential
        kernel at ``beta = 1``)."""
        from qcmrf_tpu_torch.ops import kernels

        coef = kernels.moebius_coefficients(self)[None]
        return kernels.logpot_table(self.cliques, self.n, coef, 1.0)[0]

    def log_partition(self) -> torch.Tensor:
        """``ln Z(beta)``, differentiable in ``theta``: under
        differentiation one fused lnZ + moments sweep whose backward is
        ``beta * E_p[phi]`` (the JAX package autodiffs its ``2**n`` table;
        the port's table is a kernel with no backward), else the streaming
        logsumexp (:func:`qcmrf_tpu_torch.ops.kernels.log_partition`)."""
        from qcmrf_tpu_torch.ops import kernels

        return kernels.log_partition(self)

    def gibbs_probs(self) -> torch.Tensor:
        """Exact Gibbs distribution over all ``2**n`` states."""
        from qcmrf_tpu_torch.ops import kernels

        return kernels.gibbs_probs(self)

    def success_rate(self) -> torch.Tensor:
        """Post-selection success rate ``Z / 2**n`` of the QCMRF circuit.
        Requires theta <= 0."""
        return torch.exp(self.log_partition() - self.n * math.log(2.0))

    # ---- training-facing quantities ------------------------------------

    def nll(self, x_batch) -> torch.Tensor:
        """Average negative log-likelihood of observed state ids; its
        gradient in ``theta`` is ``beta * (E_p[phi] - E_data[phi])``."""
        return (self.log_partition()
                - self.beta * self.log_potential(x_batch).mean())

    def with_theta(self, theta) -> "MRF":
        return dataclasses.replace(
            self, theta=torch.as_tensor(theta, dtype=self.theta.dtype,
                                        device=self.device))


def chain_mrf(n: int, theta=None, beta: float = 1.0, device=None) -> MRF:
    """n-variable chain with edges (i, i+1)."""
    return MRF.create([[i, i + 1] for i in range(n - 1)], theta=theta,
                      beta=beta, device=device)


def grid_cliques(rows: int, cols: int):
    """Edges of the rows x cols grid, in the JAX package's order."""
    def vid(r, c):
        return r * cols + c

    cliques = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                cliques.append([vid(r, c), vid(r, c + 1)])
            if r + 1 < rows:
                cliques.append([vid(r, c), vid(r + 1, c)])
    return cliques


def grid_mrf(rows: int, cols: int, theta=None, beta: float = 1.0,
             device=None) -> MRF:
    """rows x cols grid MRF, edges in the JAX package's order."""
    return MRF.create(grid_cliques(rows, cols), theta=theta, beta=beta,
                      device=device)
