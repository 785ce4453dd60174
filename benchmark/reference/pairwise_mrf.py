"""Plain reference of a binary MRF whose cliques hold one or two variables.

It works out again, from the benchmark's own inputs (cliques, theta, beta,
evidence, data ids), everything the benchmark compares: the log-potential
of every state, ln Z, conditional masses and probabilities, MAP states,
clique marginals, the post-selected outcome law of the model's QCMRF
circuit, and exact-MLE steps under Adam. It imports no part of the program
under test and runs in whatever dtype it is given: float64 for the
reference, a lower precision for the control.

Conventions (those of the models it checks): a state id holds variable 0 in
its most significant of ``n`` bits; clique ``k``'s parameters start at
``sum_{j<k} 2**len(C_j)``, a pair ``(i, j)`` at entry ``2 * x_i + x_j``.
Each clique table is rewritten as ``const + h.x + x^T J x``, so a block of
states costs one small matrix product.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

#: states a block of the sweeps holds (2**20: 0.2 GB of float64 bits at n=27)
BLOCK_BITS = 20


class PairwiseMRF:
    """``beta * theta^T phi(x)`` of a binary MRF of unary and pairwise
    cliques, in ``dtype`` on ``theta``'s device."""

    def __init__(self, cliques: Sequence[Sequence[int]], theta, n: int,
                 beta: float = 1.0, dtype: torch.dtype = torch.float64):
        self.cliques = [tuple(int(v) for v in C) for C in cliques]
        if any(len(C) not in (1, 2) for C in self.cliques):
            raise ValueError("cliques of one or two variables only")
        self.n, self.beta, self.dtype = int(n), float(beta), dtype
        theta = torch.as_tensor(theta).to(dtype)
        self.device = theta.device
        const = theta.new_zeros(())
        h = theta.new_zeros(self.n)
        J = theta.new_zeros(self.n, self.n)
        off = 0
        for C in self.cliques:
            t = theta[off:off + (1 << len(C))]
            const = const + t[0]
            if len(C) == 1:
                h[C[0]] += t[1] - t[0]
            else:
                i, j = C
                h[i] += t[2] - t[0]
                h[j] += t[1] - t[0]
                J[i, j] += t[3] - t[2] - t[1] + t[0]
            off += 1 << len(C)
        if off != theta.numel():
            raise ValueError(f"theta has {theta.numel()} entries, the "
                             f"cliques {off}")
        self.const, self.h, self.J = const, h, J
        self._shifts = torch.arange(self.n - 1, -1, -1, device=self.device)

    # ---- states ---------------------------------------------------------

    def bits(self, ids: torch.Tensor, n: int = None) -> torch.Tensor:
        """(len(ids), n) 0/1 in ``dtype``; column v is variable v."""
        n = self.n if n is None else n
        shifts = self._shifts[self.n - n:]
        return ((ids.to(self.device, torch.int64)[:, None] >> shifts) & 1
                ).to(self.dtype)

    def logpot(self, ids: torch.Tensor) -> torch.Tensor:
        """``beta * theta^T phi(x)`` at the state ids ``ids``."""
        B = self.bits(ids)
        quad = ((B @ self.J) * B).sum(1)
        return self.beta * (self.const + B @ self.h + quad)

    def table(self) -> torch.Tensor:
        """The log-potential of every one of the ``2**n`` states."""
        out = torch.empty(1 << self.n, dtype=self.dtype, device=self.device)
        step = 1 << min(BLOCK_BITS, self.n)
        for lo in range(0, 1 << self.n, step):
            ids = torch.arange(lo, lo + step, device=self.device)
            out[lo:lo + step] = self.logpot(ids)
        return out

    # ---- conditioning ---------------------------------------------------

    def condition(self, table: torch.Tensor, evidence: Dict[int, int]
                  ) -> Tuple[List[int], torch.Tensor]:
        """(free variables in order, the log-potentials of the states that
        agree with ``evidence``, flat over the free variables' ids)."""
        index = tuple(int(evidence[v]) if v in evidence else slice(None)
                      for v in range(self.n))
        free = [v for v in range(self.n) if v not in evidence]
        return free, table.view((2,) * self.n)[index].reshape(-1)

    def moments(self, logp: torch.Tensor, lnz, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """E[x] (k,) and E[x x^T] (k, k) over ``k`` variables under
        ``exp(logp - lnz)``, ``logp`` flat over their ``2**k`` ids."""
        m1 = torch.zeros(k, dtype=self.dtype, device=self.device)
        m2 = torch.zeros(k, k, dtype=self.dtype, device=self.device)
        step = 1 << min(BLOCK_BITS, k)
        for lo in range(0, 1 << k, step):
            p = torch.exp(logp[lo:lo + step] - lnz)
            B = self.bits(torch.arange(lo, lo + step, device=self.device), k)
            m1 += p @ B
            m2 += (B * p[:, None]).T @ B
        return m1, m2

    def clique_marginals(self, m1: torch.Tensor, m2: torch.Tensor
                         ) -> torch.Tensor:
        """P(y_k = y) of every clique in theta's layout, from E[x] and
        E[x x^T] over all ``n`` variables."""
        out = []
        for C in self.cliques:
            if len(C) == 1:
                p1 = m1[C[0]]
                out += [1 - p1, p1]
            else:
                i, j = C
                p11 = m2[i, j]
                out += [1 - m1[i] - m1[j] + p11, m1[j] - p11, m1[i] - p11,
                        p11]
        return torch.stack(out)

    def conditional_marginals(self, table: torch.Tensor,
                              evidence: Dict[int, int]) -> torch.Tensor:
        """Clique marginals given ``evidence`` (observed variables fixed)."""
        free, sub = self.condition(table, evidence)
        lnz = torch.logsumexp(sub, 0)
        f1, f2 = self.moments(sub, lnz, len(free))
        x = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        for v, b in evidence.items():
            x[v] = float(b)
        idx = torch.tensor(free, device=self.device)
        x[idx] = f1
        m2 = torch.outer(x, x)
        m2[idx[:, None], idx[None, :]] = f2
        return self.clique_marginals(x, m2)

    def map_state(self, table: torch.Tensor, evidence: Dict[int, int]
                  ) -> Tuple[int, float]:
        """(state id, log-potential) of the most probable state agreeing
        with ``evidence``; ties go to the smallest id."""
        free, sub = self.condition(table, evidence)
        j = int(torch.argmax(sub))
        x = 0
        for v in range(self.n):
            b = evidence[v] if v in evidence else (
                j >> (len(free) - 1 - free.index(v))) & 1
            x = (x << 1) | int(b)
        return x, float(sub[j])

    # ---- the QCMRF circuit's outcome law --------------------------------

    def postselected(self, table: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """(P(x, every ancilla 0) for every state id x, delta = Z / 2**n):
        the circuit keeps x with probability prod_k exp(beta theta_k)."""
        q = torch.exp(table - self.n * math.log(2.0))
        return q, float(q.double().sum())


def data_marginals(model: PairwiseMRF, ids: torch.Tensor) -> torch.Tensor:
    """The data's clique marginals in theta's layout."""
    B = model.bits(ids)
    return model.clique_marginals(B.mean(0), B.T @ B / B.shape[0])


def sample_ids(table: torch.Tensor, count: int,
               generator: torch.Generator) -> torch.Tensor:
    """``count`` distinct state ids (int64) drawn from ``exp(table)`` by the
    inverse of its CDF, kept in draw order (the first draw of each id)."""
    if count > table.numel():
        raise ValueError(f"{count} distinct ids of {table.numel()} states")
    cdf = torch.cumsum(torch.exp(table.double() - table.double().max()), 0)
    ids = table.new_zeros(0, dtype=torch.int64)
    while True:
        u = torch.rand(count + count // 8 + 64, generator=generator,
                       dtype=torch.float64, device=table.device) * cdf[-1]
        more = torch.searchsorted(cdf, u).clamp_(max=table.numel() - 1)
        ids = torch.cat([ids, more])
        uniq, inverse = torch.unique(ids, return_inverse=True)
        if uniq.numel() >= count:
            break
    first = torch.full((uniq.numel(),), ids.numel(), device=ids.device)
    first.scatter_reduce_(0, inverse, torch.arange(ids.numel(),
                                                   device=ids.device),
                          reduce="amin")
    return ids[torch.sort(first).values[:count]]


# ---- exact-MLE training ----------------------------------------------------


def train_reference(cliques, n: int, beta: float, theta0, data: torch.Tensor,
                    steps: int, lr: float, dtype: torch.dtype = torch.float64,
                    betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """``steps`` Adam steps on the mean NLL ``lnZ(theta) - mean beta
    theta^T phi(data)`` with ``theta = -softplus(raw)``, from ``raw`` the
    inverse softplus of ``theta0`` clamped below -1e-4: each step's loss
    (before its update), the first step's gradient with respect to
    ``raw``, and ``raw`` before and after the steps."""
    theta0 = torch.as_tensor(theta0).to(dtype)
    raw = torch.log(torch.expm1(-torch.clamp(theta0, max=-1e-4)))
    raw0 = raw.clone()
    m = torch.zeros_like(raw)
    v = torch.zeros_like(raw)
    mu_hat = None
    losses, g1 = [], None
    for t in range(1, steps + 1):
        theta = -torch.nn.functional.softplus(raw)
        model = PairwiseMRF(cliques, theta, n, beta, dtype)
        if mu_hat is None:
            mu_hat = data_marginals(model, data)
        table = model.table()
        lnz = torch.logsumexp(table, 0)
        losses.append(float(lnz - model.logpot(data).mean()))
        mu = model.clique_marginals(*model.moments(table, lnz, n))
        del table
        g = beta * (mu - mu_hat) * -torch.sigmoid(raw)
        if g1 is None:
            g1 = g.clone()
        m = betas[0] * m + (1 - betas[0]) * g
        v = betas[1] * v + (1 - betas[1]) * g * g
        denom = (v.sqrt() / math.sqrt(1 - betas[1] ** t)) + eps
        raw = raw - lr / (1 - betas[0] ** t) * m / denom
    return {"losses": losses, "grad1": g1, "raw0": raw0, "raw": raw}


def nll(cliques, n: int, beta: float, raw, data: torch.Tensor,
        dtype: torch.dtype = torch.float64) -> float:
    """The mean NLL ``lnZ(theta) - mean beta theta^T phi(data)`` at
    ``theta = -softplus(raw)``, as :func:`train_reference` takes it."""
    theta = -torch.nn.functional.softplus(torch.as_tensor(raw).to(dtype))
    model = PairwiseMRF(cliques, theta, n, beta, dtype)
    return float(torch.logsumexp(model.table(), 0)
                 - model.logpot(data).mean())


def leaf_norm_gap(program: torch.Tensor, reference: torch.Tensor,
                  sizes: Sequence[int], skip=None) -> float:
    """The worst leaf's gap between the norms of ``program`` and
    ``reference``, split into leaves of ``sizes`` entries, each over the
    larger of that leaf's reference norm and the median leaf's; leaves
    flagged in ``skip`` are left out."""
    prog = torch.split(program.double().flatten(), list(sizes))
    ref = torch.split(reference.double().flatten(), list(sizes))
    pn = torch.stack([p.norm() for p in prog])
    rn = torch.stack([r.norm() for r in ref])
    keep = torch.ones_like(rn, dtype=torch.bool) if skip is None else ~skip
    scale = torch.maximum(rn, rn[keep].median())
    return float(((pn - rn).abs() / scale)[keep].max())
