"""Exact-MLE training for structures variable elimination can't touch.

Every other exact route has a hard wall: the enumerated 2^n table stops
fitting around n=22, and variable elimination (any n) needs bounded
treewidth. The streaming lnZ has neither: d lnZ / d theta = beta *
E_p[phi] comes from one fused lnZ + moments sweep of the states (the
``lnz_moments`` kernel on the card), so exact MLE runs for ANY clique
structure up to the n <= 47 cap. The reference never trains at all.

This example runs the same code path on a toy complete graph: the width
cap is lowered so the streaming branch engages at K10 exactly as it would
by itself for width > 25. ``torch.optim.Adam`` takes optax's place. The
PyTorch / CUDA port of ``examples/06_wide_structure_training.py``.

    python qcmrf_tpu_torch/examples/06_wide_structure_training.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# force the streaming branch at toy width (it engages by itself for
# induced width > 25, i.e. complete graphs past n=26); read when the
# capability module is imported, so it must be set before the imports
os.environ.setdefault("QCMRF_ELIM_WIDTH_CAP", "3")

SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
DEVICE = "cpu" if SMOKE else None

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qcmrf_tpu_torch import MRF, kl  # noqa: E402
from qcmrf_tpu_torch.models import capability, elimination  # noqa: E402
from qcmrf_tpu_torch.models import moments  # noqa: E402
from qcmrf_tpu_torch.models import sample as msample  # noqa: E402
from qcmrf_tpu_torch.models import train as mtrain  # noqa: E402

# ground truth: a complete graph (every pair is a clique), the worst case
# for elimination: its table scope here is all n variables
n = 8 if SMOKE else 10
cliques = [[i, j] for i in range(n) for j in range(i + 1, n)]
rng = np.random.RandomState(0)
truth = MRF.create(cliques, theta=-np.abs(rng.randn(4 * len(cliques)))
                   .astype(np.float32) * 0.4, device=DEVICE)
width = elimination.induced_width(truth.cliques, truth.n)
print(f"K{n}: {len(cliques)} cliques, elimination table scope {width} "
      f"(> cap {capability.ELIM_WIDTH_CAP} -> streaming branch)")

# the data reduces to its sufficient statistics once: past n=30 the CLI
# ships samples as (S, n) bit arrays for exactly this reason
ids = msample.sample_exact(0, truth, 4_000 if SMOKE else 20_000)
ids = ids.cpu().numpy()
bits = (ids[:, None] >> (n - 1 - np.arange(n))) & 1
mu_hat = mtrain.empirical_moments_from_bits(truth, bits)

# the moment-target step: loss = lnZ(theta) - beta * theta^T mu_hat, with
# lnZ's gradient the fused sweep's moments
raw = mtrain._from_theta(torch.full((truth.dimension,), -0.5,
                                    device=truth.device), True)
raw.requires_grad_()
step = mtrain.make_moment_train_step(truth, mtrain.adam([raw], 0.1), mu_hat)
steps = 120 if SMOKE else 400
for i in range(steps):
    loss = step()
    if (i + 1) % (steps // 4) == 0:
        print(f"step {i + 1}: nll {float(loss):.4f}")

fitted = truth.with_theta(mtrain._to_theta(raw, True).detach())
d = float(kl(truth.gibbs_probs().double().cpu().numpy(),
             fitted.gibbs_probs().double().cpu().numpy()))
print(f"KL(truth || fitted) = {d:.5f}")
assert d < (0.15 if SMOKE else 0.05)

# conditional queries on the fitted model take the same streaming sweeps:
# the evidence is clamped by exact clique-table reduction, so P(x_v |
# evidence) never needs elimination's bounded treewidth
ev = {0: 1, 3: 0}
p = float(moments.conditional_prob_streaming(fitted, 1, 1, ev))
p_true = float(elimination.conditional_prob(truth, 1, 1, ev))
print(f"P(x1=1 | x0=1, x3=0): fitted {p:.4f}, truth {p_true:.4f}")
assert abs(p - p_true) < (0.15 if SMOKE else 0.05)

# the same step shards over a device mesh (per-shard block-range sweeps):
# pass mesh=... here, or --mesh AxB to
# `python -m qcmrf_tpu_torch train --graph k27.json --data bits.json`
