"""Fit an MRF to data by exact maximum likelihood (autodiff).

A capability with no reference counterpart: the NLL's gradient is the
moment gap E_data[phi] - E_model[phi]; the model moments come from the
exact distribution (the fused lnZ + moments kernel's backward on the
card), so gradient descent on theta is exact MLE. ``torch.optim.Adam``
takes optax's place. See ``python -m qcmrf_tpu_torch train`` for the
checkpointed CLI version. The PyTorch / CUDA port of
``examples/04_training.py``.

    python qcmrf_tpu_torch/examples/04_training.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run (fewer steps and
# shots, on the CPU; convergence tolerances widen accordingly)
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
DEVICE = "cpu" if SMOKE else None

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qcmrf_tpu_torch import MRF, fit_mle, fit_mle_shots, kl  # noqa: E402
from qcmrf_tpu_torch.models import sample as msample  # noqa: E402

# ground truth: a 6-variable chain
rng = np.random.RandomState(0)
truth = MRF.create([[i, i + 1] for i in range(5)],
                   theta=-np.abs(rng.randn(20)).astype(np.float32),
                   device=DEVICE)

data = msample.sample_exact(0, truth, 20_000)

init = truth.with_theta(torch.full((truth.dimension,), -0.5,
                                   device=truth.device))
fitted, nll = fit_mle(init, data, steps=80 if SMOKE else 300,
                      learning_rate=0.1)


def kl_to_truth(m) -> float:
    return float(kl(truth.gibbs_probs().double().cpu().numpy(),
                    m.gibbs_probs().double().cpu().numpy()))


d = kl_to_truth(fitted)
print(f"final NLL {float(nll):.4f}; KL(truth || fitted) = {d:.5f}")
assert d < (0.05 if SMOKE else 0.01)

# quantum-in-the-loop variant: the gradient's model moments come from
# post-selected circuit shots (the sampler kernel) instead of exact
# inference (``python -m qcmrf_tpu_torch train --grad shots``)
fitted_q, delta = fit_mle_shots(init, data, 3,
                                steps=50 if SMOKE else 200,
                                shots=1 << (12 if SMOKE else 14),
                                learning_rate=0.1)
dq = kl_to_truth(fitted_q)
print(f"shot-gradient fit: KL = {dq:.5f} (delta-hat {delta:.3f})")
assert dq < (0.1 if SMOKE else 0.02)
