"""MRF structure learning by group-lasso MLE over candidate cliques (port
of :mod:`qcmrf_tpu.models.structure`).

Given observed samples and a candidate clique set (e.g. all pairs), fit
theta with a per-clique group penalty on each block's interaction content
(its projection onto the order >= 2 Walsh characters: order 0 is gauge,
order 1 the singletons' business), prune candidates whose interaction
norm falls below a cut, then refit the survivors penalty-free. The NLL
routes through the training lnZ router
(:func:`qcmrf_tpu_torch.models.train.make_lnz_fn`): enumeration,
differentiable elimination at any n, or the streaming fused sweep, so
all-pairs candidates past n = 26 (a complete template) run on the fused
lnZ + moments kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.models.train import (_from_theta, _to_theta, adam,
                                          empirical_moments_from_bits,
                                          make_moment_train_step)


def _data_moments(template: MRF, data) -> torch.Tensor:
    """Empirical ``E_data[phi]`` float32 over the template's cliques, from
    state ids (1-D, n <= 30) or per-variable bit rows (2-D ``(S, n)``, any
    n): all the NLL needs, ``mean NLL = lnZ - beta * theta^T mu_hat``."""
    from qcmrf_tpu_torch.evaluation.estimators import (
        clique_marginals_from_samples)

    if isinstance(data, torch.Tensor):
        data = data.cpu().numpy()
    arr = np.asarray(data)
    if arr.ndim == 2:
        return empirical_moments_from_bits(template, arr)
    return clique_marginals_from_samples(template, arr).float()


def candidate_pairs(n: int) -> List[List[int]]:
    """All n*(n-1)/2 undirected edges: the usual candidate set for
    pairwise structure recovery."""
    return [[i, j] for i in range(n) for j in range(i + 1, n)]


def _interaction_projector(c: int) -> np.ndarray:
    """(2^c, 2^c) projector onto the span of order >= 2 Walsh characters
    over the clique's y-index (y[0] slowest, the theta layout)."""
    dim = 1 << c
    y = np.arange(dim)
    # H[s, y] = (-1)^{popcount(s & y)}: character for subset s
    s = np.arange(dim)
    pop = np.vectorize(lambda v: bin(v).count("1"))
    H = np.where(pop(s[:, None] & y[None, :]) % 2 == 0, 1.0, -1.0)
    keep = (pop(s) >= 2).astype(np.float64)
    # P = H^T diag(keep) H / 2^c  (H is symmetric orthogonal/sqrt(dim))
    return (H.T * keep) @ H / dim


def _group_segments(mrf: MRF) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, sizes) of each clique's block in the flat theta."""
    offsets = np.asarray(mrf.theta_offsets, dtype=np.int64)
    sizes = np.asarray([1 << len(C) for C in mrf.cliques], dtype=np.int64)
    return offsets, sizes


def interaction_norms(mrf: MRF, theta=None) -> np.ndarray:
    """Per-clique strength of the order >= 2 component of each theta block
    (gauge- and unary-invariant), float64 on the host. Singleton cliques
    report 0 by construction."""
    th = mrf.theta if theta is None else theta
    if isinstance(th, torch.Tensor):
        th = th.detach().cpu().numpy()
    th = np.asarray(th, np.float64)
    offsets, sizes = _group_segments(mrf)
    out = np.empty(len(sizes), np.float64)
    for k, (o, s) in enumerate(zip(offsets, sizes)):
        c = int(s).bit_length() - 1
        out[k] = float(np.linalg.norm(
            _interaction_projector(c) @ th[o:o + s]))
    return out


def _interaction_penalty(mrf: MRF):
    """``penalty(theta) = sum_k sqrt(||P_k theta_k||^2 + eps)`` over the
    cliques with order >= 2 content, the blocks of one size in one batched
    product. eps keeps the gradient finite at interaction-free blocks."""
    offsets, sizes = _group_segments(mrf)
    eps = 1e-12
    dev = mrf.device
    groups = []
    for s in sorted(set(sizes.tolist())):
        c = int(s).bit_length() - 1
        if c < 2:
            continue  # singletons: no interaction content to penalise
        starts = offsets[sizes == s]
        idx = torch.from_numpy(starts[:, None] + np.arange(s)[None]).to(dev)
        P = torch.as_tensor(_interaction_projector(c), dtype=torch.float32,
                            device=dev)
        groups.append((idx, P))

    def penalty(theta: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), dtype=theta.dtype, device=theta.device)
        for idx, P in groups:
            p = theta[idx] @ P.T
            total = total + torch.sqrt((p * p).sum(dim=-1) + eps).sum()
        return total

    return penalty


@dataclasses.dataclass
class StructureFit:
    """Result of :func:`fit_structure`."""
    mrf: MRF                       # refit model over the selected cliques
    selected: List[List[int]]      # surviving size >= 2 cliques
    group_norm: np.ndarray         # interaction norms of the L1 fit, one
    #                                per template clique (singletons 0)
    cliques: List[List[int]]       # the template's cliques, aligned with
    #                                group_norm (singletons + candidates)
    threshold: float               # the prune cut actually applied
    nll: float                     # final refit NLL (penalty-free)


#: the fits' lnZ enumerates up to this many variables, as ``make_lnz_fn``
#: does by default
_ENUMERATE_MAX_N = 22


def _fit(template: MRF, data, steps: int, learning_rate: float,
         nonpositive: bool, mesh, penalty=None):
    """Adam on the reparameterised theta by the moment step on the data's
    moments, lnZ routed by ``make_lnz_fn`` (enumeration up to
    ``_ENUMERATE_MAX_N`` variables); returns (raw, last loss)."""
    raw = _from_theta(template.theta, nonpositive).requires_grad_()
    step = make_moment_train_step(
        template, adam([raw], learning_rate), _data_moments(template, data),
        nonpositive, mesh, penalty=penalty, enumerate_max_n=_ENUMERATE_MAX_N)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        loss = step()
    return raw, loss


def fit_structure(candidates: Sequence[Sequence[int]], data, n: int,
                  lam: float = 0.02, steps: int = 400,
                  learning_rate: float = 0.05, nonpositive: bool = True,
                  prune_tol: float = 0.05, refit_steps: int = 300,
                  beta: float = 1.0, mesh=None,
                  device=None) -> StructureFit:
    """Select an MRF structure from ``candidates`` by group-lasso MLE.

    The template is every variable's singleton clique (kept, unpenalised)
    plus the size >= 2 ``candidates``. Phase 1 minimises ``NLL(theta) +
    lam * sum_k ||order>=2 component of theta_k||_2`` (Adam on the
    softplus-reparameterised theta, as ``fit_mle``); phase 2 prunes the
    candidates whose interaction norm falls below the absolute cut
    ``prune_tol`` and refits singletons + survivors penalty-free. ``data``
    is state ids (1-D) or bit rows (2-D ``(S, n)``, any n). Runs on
    ``device``: the current CUDA device unless one is named. ``mesh``
    shards the streaming lnZ sweep (``make_lnz_fn``'s wide branch)."""
    cands = [sorted(set(int(v) for v in C)) for C in candidates]
    if any(len(C) < 2 for C in cands):
        raise ValueError("candidates must have size >= 2; singletons "
                         "are added automatically")
    cliques = [[v] for v in range(n)] + cands
    template = MRF.create(
        cliques, theta=np.full(sum(1 << len(C) for C in cliques), -0.1),
        beta=beta, n=n, device=device)
    pen = _interaction_penalty(template)
    raw, _ = _fit(template, data, steps, learning_rate, nonpositive, mesh,
                  lambda theta: lam * pen(theta))

    norms = interaction_norms(template, _to_theta(raw, nonpositive))
    cand_norms = norms[n:]  # the first n groups are the singletons
    cut = float(prune_tol)
    selected = [C for C, g in zip(cands, cand_norms) if g >= cut]

    keep = [[v] for v in range(n)] + selected
    refit = MRF.create(
        keep, theta=np.full(sum(1 << len(C) for C in keep), -0.1),
        beta=beta, n=n, device=template.device)
    raw2, nll = _fit(refit, data, refit_steps, learning_rate, nonpositive,
                     mesh)
    fitted = refit.with_theta(_to_theta(raw2, nonpositive).detach())
    return StructureFit(mrf=fitted, selected=selected, group_norm=norms,
                        cliques=cliques, threshold=cut, nll=float(nll))
