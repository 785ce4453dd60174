"""Shot-based estimators (the ported part of
:mod:`qcmrf_tpu.evaluation.estimators`).

:func:`clique_marginals_from_samples` serves shot-gradient training and
the empirical moments of state-id data. The rest of the module (counts
and parts estimators of Z, exact marginals by autodiff,
``estimate_from_circuit``) comes with slice 3b of ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF


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
