"""Bidirectional map between MRF log-potentials theta and circuit angles
gamma (port of :mod:`qcmrf_tpu.circuits.params`):

    gamma = 0.5 * arccos(exp(beta * theta / 2))
    theta = 2 * ln(cos(2 * gamma)) / beta

The forward map requires ``theta <= 0`` (the arccos argument must be <= 1).
Tensors are mapped with torch in their own dtype; anything else is mapped
in float64 numpy (arccos near theta=0 is ill-conditioned in float32).
"""

from __future__ import annotations

import numpy as np
import torch


def _xp(x):
    if isinstance(x, torch.Tensor):
        return torch, x
    return np, np.asarray(x, dtype=np.float64)


def theta_to_gamma(theta, beta=1.0):
    """``gamma = 0.5 * arccos(exp(beta*theta/2))``; requires theta <= 0."""
    xp, theta = _xp(theta)
    return 0.5 * xp.arccos(xp.exp(beta * 0.5 * theta))


def gamma_to_theta(gamma, beta=1.0):
    """``theta = 2 * ln(cos(2*gamma)) / beta``."""
    xp, gamma = _xp(gamma)
    return 2.0 * xp.log(xp.cos(2.0 * gamma)) / beta


def validate_theta_domain(theta) -> None:
    """Raise if any theta > 0 (outside the real-angle domain)."""
    t = (theta.detach().cpu().numpy() if isinstance(theta, torch.Tensor)
         else np.asarray(theta))
    if np.any(t > 0):
        raise ValueError(
            "QCMRF circuit parameters require theta <= 0 "
            "(gamma = arccos(exp(beta*theta/2))/2 must be real); "
            f"got max(theta) = {t.max()}"
        )
