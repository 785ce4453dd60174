"""Shot-based estimators: the partition function and clique marginals
(port of :mod:`qcmrf_tpu.evaluation.estimators`).

The QCMRF circuit is a sampler and an estimator at once: the
post-selection success rate ``delta = accepted / shots`` estimates ``Z /
2**n``, and the post-selected samples are Gibbs draws, so the clique
marginals are empirical sufficient-statistic frequencies. The counts and
parts estimators run on the host; :func:`clique_marginals_exact` is the
fused lnZ + moments sweep (``lnz_moments_kernel`` on the card) and
:func:`estimate_from_circuit` the fused outcome sampler
(``sampler_kernel``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF


def success_rate_from_counts(counts: Dict[str, float], n: int) -> float:
    """delta-hat = accepted mass / total mass: a key is accepted when its
    integer value is below ``2**n`` (its ancilla bits all 0)."""
    total = 0.0
    accepted = 0.0
    for k, v in counts.items():
        total += v
        if int(k, 2) < (1 << n):
            accepted += v
    return accepted / total if total else 0.0


def log_partition_from_counts(counts: Dict[str, float], n: int) -> float:
    """ln Z-hat = ln(delta-hat) + n ln 2."""
    delta = success_rate_from_counts(counts, n)
    if delta <= 0:
        return float("-inf")
    return float(np.log(delta) + n * np.log(2.0))


def log_partition_from_parts(a_mask, n: int) -> float:
    """ln Z-hat from the fused sampler's ancilla bitmasks (a shot is
    accepted where its mask is 0)."""
    a = np.asarray(a_mask.cpu() if isinstance(a_mask, torch.Tensor)
                   else a_mask)
    delta = float((a == 0).mean())
    if delta <= 0:
        return float("-inf")
    return float(np.log(delta) + n * np.log(2.0))


def clique_marginals_exact(mrf: MRF) -> torch.Tensor:
    """Exact marginal probability of every clique state, ``E_p[phi]``
    (d,) in theta's dtype on ``mrf``'s device: the moments of one fused
    lnZ + moments sweep (:func:`kernels.lnz_and_moments`, the
    ``lnz_moments_kernel`` on the card), where the JAX package takes the
    gradient of lnZ through a chunked table. Not differentiable."""
    from qcmrf_tpu_torch.ops import kernels

    with torch.no_grad():
        return kernels.lnz_and_moments(mrf.cliques, mrf.n,
                                       mrf.theta.detach(), mrf.beta)[1]


def clique_marginals_from_samples(mrf: MRF, x, accepted=None) -> torch.Tensor:
    """Empirical clique marginals from (post-selected) samples: the mean
    of phi, float64 (d,) on ``mrf``'s device. ``x`` are state ids (any
    integer array or tensor); ``accepted`` the post-selection mask (None =
    all accepted). The counts are integers, so their float64 sums are
    exact in any order."""
    dev = mrf.device
    if not isinstance(x, torch.Tensor):
        x = np.array(x)
    x = torch.as_tensor(x, device=dev)
    if accepted is not None:
        x = x[torch.as_tensor(accepted, device=dev).bool()]
    idx = mrf.suff_stat_flat_indices(x).reshape(-1)
    out = torch.zeros(mrf.dimension, dtype=torch.float64, device=dev)
    out.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float64,
                                      device=dev))
    return out / max(x.shape[0], 1)


def estimate_from_circuit(seed: int, mrf: MRF,
                          shots: int) -> Tuple[float, np.ndarray, float]:
    """One call: run the circuit's outcome sampler
    (:func:`analytic.sample_postselected`), post-select, estimate.
    Returns ``(lnZ-hat, clique marginals-hat (d,) float64 numpy,
    delta-hat)``."""
    from qcmrf_tpu_torch.sim import analytic

    x, acc = analytic.sample_postselected(seed, mrf, shots)
    delta = float(acc.double().mean())
    lnz = float(np.log(max(delta, 1e-300)) + mrf.n * np.log(2.0))
    marg = clique_marginals_from_samples(mrf, x, acc)
    return lnz, marg.cpu().numpy(), delta
