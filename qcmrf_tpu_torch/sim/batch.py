"""Batched suite execution, one launch per graph (port of
:mod:`qcmrf_tpu.sim.batch`).

The JAX package ``vmap``s over the thetas of one graph; here the batch
dimension is written out: the thetas of a graph's reps become ``(B, K <<
cmax)`` coefficient rows, and the sampler, the log-potential table and
the streaming logsumexp each take all rows in one launch. Each function
runs on ``device``: the current CUDA device unless the caller names one
(``device="cpu"`` runs the plain versions).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.ops import kernels, sampler_kernel
from qcmrf_tpu_torch.sim import analytic
from qcmrf_tpu_torch.utils.config import resolve_device


def _prepare(cliques, thetas, device):
    cliques = tuple(tuple(int(v) for v in C) for C in cliques)
    n = max(v for C in cliques for v in C) + 1
    thetas = torch.as_tensor(np.asarray(thetas, dtype=np.float32),
                             device=resolve_device(device))
    return cliques, n, thetas


def _moebius_rows(cliques, thetas, device):
    """``(cliques, n, coef)``: the ``(B, K << cmax)`` Moebius coefficient
    rows of a stack of thetas, on ``device``."""
    cliques, n, thetas = _prepare(cliques, thetas, device)
    return cliques, n, kernels.coefficient_table(cliques, n, thetas)


def batched_joint_probs(cliques, thetas, beta: float = 1.0,
                        device=None) -> torch.Tensor:
    """Joint outcome distributions for a stack of thetas on one graph,
    ``(B, 2**(n+K+1))``."""
    device = resolve_device(device)
    return torch.stack([
        analytic.joint_outcome_probs(
            MRF.create(cliques, theta=t, beta=beta, device=device))
        for t in np.asarray(thetas, dtype=np.float32)
    ])


def batched_sample_outcomes(cliques, thetas, seed: int, shots: int,
                            stream0: int = 0,
                            device=None) -> torch.Tensor:
    """Shot-sampled measurement keys for a stack of thetas, int32
    ``(B, shots)`` (layout of :func:`analytic.joint_outcome_probs`); row
    ``b`` draws from Philox stream ``stream0 + b``. One sampler launch."""
    cliques, n, thetas = _prepare(cliques, thetas, device)
    if n + len(cliques) + 1 > 31:
        raise ValueError("packed keys need n + K + 1 <= 31 bits")
    analytic.check_thetas(thetas)
    keep = sampler_kernel.keep_prob_values(cliques, n, thetas, 1.0)
    x, a = sampler_kernel.sample_call(seed, cliques, n, keep, shots,
                                      "parts", stream0)
    return x + (a << (n + 1))


def batched_gibbs_probs(cliques, thetas, beta: float = 1.0,
                        device=None) -> torch.Tensor:
    """Exact Gibbs distributions for a stack of thetas on one graph,
    ``(B, 2**n)``, from one log-potential launch."""
    cliques, n, coef = _moebius_rows(cliques, thetas, device)
    return torch.softmax(kernels.logpot_table(cliques, n, coef, beta), dim=-1)


def batched_gibbs_log_partition(cliques, thetas, beta: float = 1.0,
                                device=None):
    """``(p, lnz)``: the exact Gibbs distributions ``(B, 2**n)`` and ``ln
    Z`` ``(B,)`` for a stack of thetas on one graph, from one coefficient
    table, one log-potential launch and one streaming-logsumexp launch."""
    cliques, n, coef = _moebius_rows(cliques, thetas, device)
    p = torch.softmax(kernels.logpot_table(cliques, n, coef, beta), dim=-1)
    lnz = kernels.combine_lse(*kernels.lse_partials(cliques, n, coef, beta))
    return p, lnz


def run_suite_probs(suite, device=None) -> List[np.ndarray]:
    """Exact joint distributions for every circuit of a suite, suite
    order."""
    device = resolve_device(device)
    out: List[np.ndarray] = []
    for j, C in enumerate(suite.graphs):
        probs = batched_joint_probs(C, suite.thetas[j], device=device)
        out.extend(list(probs.cpu().numpy()))
    return out
