"""The past-both-caps regime end to end: explain, estimate, train.

Exact inference has two walls: variable elimination needs bounded induced
width (any n), and the streaming sweeps need n <= 47 (any width). A model
past BOTH, wide AND large, is served stochastically with annealed
importance sampling and diagnosable error bars:

  1. ``infer --explain`` shows the refusal and the AIS route
     (``models/capability.py``: every regime cap in one place);
  2. AIS answers lnZ / clique marginals / P(x_v = b) with ESS / stderr
     health signals (``models/ais.py``; every rung of every chain in one
     launch of the chain kernel on the card);
  3. ``--grad ais`` trains there: the NLL gradient's model moments come
     from AIS marginals, with ESS-gated step acceptance
     (``models/train.py::make_ais_train_step``).

The toy here is a disjoint construction (a complete block + a chain) so
that every stochastic answer can be CHECKED against the exact per-block
decomposition, shrunk to run in seconds by simulating the caps at toy
size. ``torch.optim.Adam`` takes optax's place and seeds are ints. The
PyTorch / CUDA port of ``examples/09_past_caps_ais.py``.

    python qcmrf_tpu_torch/examples/09_past_caps_ais.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# simulate the past-both-caps regime at toy size: width cap 1 makes the K5
# block "wide", streaming cap 8 makes n=12 "large" (the real caps are 25
# and 47; the routing is identical). Must precede the imports below.
os.environ.setdefault("QCMRF_ELIM_WIDTH_CAP", "1")

SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
DEVICE = "cpu" if SMOKE else None

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qcmrf_tpu_torch.models import ais, capability, elimination  # noqa
from qcmrf_tpu_torch.models import moments  # noqa: E402
from qcmrf_tpu_torch.models import train as mtrain  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402

# toy streaming cap (real value: 47): both the routing module and the
# capability matrix consult it
moments._MAX_N = capability.STREAMING_MAX_N = 8

CHAINS, TEMPS, STEPS = (96, 24, 40) if SMOKE else (256, 64, 120)

# --- a wide-AND-large toy with an exact cross-check ---------------------
# block A: complete pairwise graph on 5 vars ("wide": width 5 > cap 1)
# block B: chain on 7 more vars; joint n=12 > toy streaming cap 8
A = [[i, j] for i in range(5) for j in range(i + 1, 5)]
B = [[i + 5, i + 6] for i in range(6)]
rng = np.random.RandomState(0)
theta = (-np.abs(rng.randn(4 * len(A + B))) * 0.4).astype(np.float32)
joint = MRF.create(A + B, theta=theta, device=DEVICE)

# exact answers by the disjoint-block decomposition (enumeration)
dA = sum(1 << len(C) for C in A)
mA = MRF.create(A, theta=theta[:dA], device=DEVICE)
mB = MRF.create([[i, i + 1] for i in range(6)], theta=theta[dA:],
                device=DEVICE)
lnz_exact = float(mA.log_partition()) + float(mB.log_partition())

# --- 1) the capability matrix explains the routing ----------------------
report = capability.explain(joint.cliques, joint.n, query="lnz")
print("explain:", {k: v["feasible"] for k, v in report["backends"].items()},
      "-> selected:", report["selected"])
assert report["selected"] == "ais"

# --- 2) AIS estimates with error bars -----------------------------------
lnz, diag = ais.ais_log_partition(0, joint, num_chains=CHAINS,
                                  num_temps=TEMPS, return_diagnostics=True)
print(f"lnZ: ais {float(lnz):.4f} vs exact {lnz_exact:.4f} "
      f"(ess {float(diag['ess']):.0f}/{CHAINS}, "
      f"stderr {float(diag['stderr']):.4f})")
assert abs(float(lnz) - lnz_exact) < max(6 * float(diag["stderr"]), 0.05)

p = ais.ais_event_prob(1, joint, 2, 1, num_chains=CHAINS, num_temps=TEMPS)
p_exact = float(elimination.conditional_prob(mA, 2, 1, {}))
print(f"P(x_2=1): ais {float(p):.4f} vs exact {p_exact:.4f}")
assert abs(float(p) - p_exact) < 0.08

# --- 3) training where no exact gradient exists -------------------------
mu_exact = torch.cat([elimination.clique_marginals(mA),
                      elimination.clique_marginals(mB)]).float()
template = MRF.create([list(C) for C in joint.cliques], device=DEVICE)
raw = mtrain._from_theta(torch.full((template.dimension,), -0.5,
                                    device=template.device), True)
raw.requires_grad_()
step = mtrain.make_ais_train_step(template, mtrain.adam([raw], 0.1),
                                  mu_exact, num_chains=CHAINS,
                                  num_temps=TEMPS)
for i in range(STEPS):
    info = step(2, stream=i)
    if info["skipped"]:
        print(f"  step {i}: skipped (ess {info['ess']:.0f})")
fit = mtrain._to_theta(raw, True).detach()
# validate the stochastic fit against exact per-block inference
fitA = MRF.create(A, theta=fit[: mA.dimension], device=DEVICE)
gap = float((elimination.clique_marginals(fitA)
             - mu_exact[: mA.dimension]).abs().max())
print(f"training: max block-A moment gap vs exact = {gap:.3f} "
      f"(final ess {info['ess']:.0f}/{CHAINS})")
assert gap < (0.15 if SMOKE else 0.08)
print("ok")
