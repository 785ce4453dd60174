"""Distribution metrics and post-selection (port of
:mod:`qcmrf_tpu.evaluation.metrics`).

* :func:`fidelity` — Bhattacharyya fidelity ``(sum_i sqrt(P_i Q_i))**2``
  skipping entries where either mass is <= 0;
* :func:`kl` — KL divergence with the same skip rule;
* :func:`extract_probs` — post-selection of a counts dict on all-zero
  ancillas, returning ``(P, delta)``.

Host arrays are computed with numpy (no device round trips in the eval
loop); tensors with torch, on their own device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _xp(P, Q):
    if isinstance(P, torch.Tensor) or isinstance(Q, torch.Tensor):
        dev = P.device if isinstance(P, torch.Tensor) else Q.device
        return (torch, torch.as_tensor(P, device=dev),
                torch.as_tensor(Q, device=dev))
    return np, np.asarray(P), np.asarray(Q)


def fidelity(P, Q):
    """Bhattacharyya fidelity between pmfs, skipping nonpositive entries."""
    xp, P, Q = _xp(P, Q)
    mask = (P > 0) & (Q > 0)
    F = xp.sqrt(xp.where(mask, P * Q, 0.0)).sum()
    return F ** 2


def kl(P, Q):
    """KL(P || Q), skipping entries where either pmf is nonpositive."""
    xp, P, Q = _xp(P, Q)
    mask = (P > 0) & (Q > 0)
    safe_ratio = xp.where(mask, P / xp.where(mask, Q, 1.0), 1.0)
    return xp.where(mask, P * xp.log(safe_ratio), 0.0).sum()


KL = kl


def extract_probs(R: Dict[str, float], n: int, a: int):
    """Post-select a counts dict on ``a`` leading zero ancilla bits: keep
    keys ``'0'*a + bits(y)``, renormalize; returns ``(P, delta)`` where
    ``delta`` is the accepted fraction of the total mass."""
    P = np.zeros(1 << n)
    z0 = 0.0
    for i in range(1 << n):
        s0 = "0" * a + format(i, f"0{n}b")
        if s0 in R:
            P[i] += R[s0]
    z = P.sum()
    for s0 in R:
        z0 += R[s0]
    if z == 0:
        return P, 0
    return P / z, z / z0


def postselect_dense(probs: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Post-selection on a dense outcome distribution indexed by the
    full-register key: accepted outcomes are those with index < 2**n.
    Returns the renormalized variable distribution and the accepted mass."""
    q = probs[: 1 << n]
    Z = q.sum()
    return torch.where(Z > 0, q / Z, q), Z


def success_bound_check(delta_hat: float, lnZ: float, n: int,
                        tol: float = 0.05) -> bool:
    """Physics self-check: empirical success rate ~ Z / 2**n."""
    return abs(delta_hat - float(np.exp(lnZ - n * np.log(2.0)))) <= tol
