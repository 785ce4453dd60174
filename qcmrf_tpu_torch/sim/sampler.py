"""Shot sampling and counts-dict conversion (port of
:mod:`qcmrf_tpu.sim.sampler`).

Counts dicts follow the stored ``result_simulation_*.json`` schema:
``{bitstring: count}`` with keys of width ``n + K + 1`` summing to the shot
count.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from qcmrf_tpu_torch.utils.bits import key_string


def sample_from_probs(seed: int, probs: torch.Tensor,
                      shots: int) -> torch.Tensor:
    """Draw ``shots`` outcome indices from a probability vector by inverse
    CDF: ``shots`` uniforms from a generator seeded with ``seed`` on the
    probabilities' device, and a binary search. Zero-probability outcomes
    are never selected."""
    p = probs / probs.sum()
    cdf = torch.cumsum(p, dim=0)
    gen = torch.Generator(device=probs.device).manual_seed(seed)
    u = torch.rand((shots,), generator=gen, dtype=cdf.dtype,
                   device=probs.device)
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp(0, probs.shape[0] - 1).to(torch.int32)


def histogram(samples: torch.Tensor, length: int) -> torch.Tensor:
    """Dense outcome histogram on the samples' device."""
    return torch.bincount(samples.to(torch.int64), minlength=length)


def counts_from_samples(samples, width: int) -> Dict[str, int]:
    """Counts dict (reference result-JSON schema) from outcome indices."""
    if isinstance(samples, torch.Tensor):
        samples = samples.cpu().numpy()
    vals, cnts = np.unique(np.asarray(samples), return_counts=True)
    return {key_string(int(v), width): int(c) for v, c in zip(vals, cnts)}


def counts_to_probs(counts: Dict[str, float], width: int) -> np.ndarray:
    """Dense outcome distribution from a counts / quasi-prob dict."""
    out = np.zeros(1 << width, dtype=np.float64)
    total = 0.0
    for k, v in counts.items():
        out[int(k, 2)] += v
        total += v
    if total > 0:
        out /= total
    return out


def circuit_seed(seed: int, i: int) -> int:
    """Generator seed of suite circuit ``i`` under the statevector and
    noisy engines."""
    return seed * 65536 + i


def sample_counts(seed: int, probs: torch.Tensor, shots: int,
                  width: int) -> Dict[str, int]:
    """One-call helper: multinomial shots -> counts dict."""
    return counts_from_samples(sample_from_probs(seed, probs, shots), width)
