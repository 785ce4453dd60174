"""Serve the full inference query family on one model.

The reference's oracle answers partition / MAP / sampling queries on
fixed draws. This walkthrough runs the standard query set: PR (lnz), MAR
(marginals / prob), MPE (map), MMAP (mmap) and conditional sampling,
against one n=40 chain, all with evidence clamping, through the same
routing the serving CLI uses (``python -m qcmrf_tpu_torch infer``). At
n=40 nothing here can enumerate: lnz / marginals / map run variable
elimination, mmap the constrained (sum-first, max-last) elimination with
traceback, and the samplers show all three layers: exact IID draws by
forward-filtering backward-sampling, the Gibbs chain kernel, and
perturb-and-MAP. The PyTorch / CUDA port of
``examples/07_inference_serving.py``.

    python qcmrf_tpu_torch/examples/07_inference_serving.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
DEVICE = "cpu" if SMOKE else None

import numpy as np  # noqa: E402

from qcmrf_tpu_torch.models import elimination as ve  # noqa: E402
from qcmrf_tpu_torch.models import sample as msample  # noqa: E402
from qcmrf_tpu_torch.models.mrf import chain_mrf  # noqa: E402

n = 40
rng = np.random.RandomState(0)
mrf = chain_mrf(n, theta=-np.abs(rng.randn(4 * (n - 1))).astype("float32"),
                device=DEVICE)
evidence = {0: 1, 20: 0, 39: 1}

# PR: clamped log-mass  ln sum_{x ~ evidence} e^{beta theta^T phi(x)}
log_mass = float(ve.log_partition_clamped(mrf, evidence))
lnz = float(ve.log_partition(mrf))
print(f"lnZ = {lnz:.4f}; evidence log-mass = {log_mass:.4f}")
assert log_mass < lnz

# MAR: one conditional
p = float(ve.conditional_prob(mrf, 7, 1, evidence))
print(f"P(x7=1 | evidence) = {p:.4f}")
assert 0.0 <= p <= 1.0

# MPE: evidence-constrained MAP with traceback
assignment, val = ve.marginal_map(
    mrf, [v for v in range(n) if v not in evidence], evidence)
print(f"MPE value {val:.4f}; bits 0..7 =",
      [assignment[v] for v in range(8) if v in assignment])

# MMAP: maximize three chosen variables over the summed-out rest
mm_assign, mm_val = ve.marginal_map(mrf, [5, 17, 30], evidence)
print(f"MMAP over (5,17,30): {mm_assign} at log-mass {mm_val:.4f}")
assert mm_val <= log_mass + 1e-4

# conditional sampling, all three layers. 'exact' draws are IID-exact at
# n=40 (a logits table would hold 2^40 entries): the elimination plan's
# forward pass is shared, the backward pass draws per sample
num = 2_000 if SMOKE else 20_000
bits_e = msample.sample_conditional(1, mrf, num, evidence,
                                    method="exact").cpu().numpy()
bits_g = msample.sample_conditional(1, mrf, 200 if SMOKE else 2_000,
                                    evidence, method="gibbs").cpu().numpy()
bits_p = msample.sample_conditional(1, mrf, 16, evidence,
                                    method="pam").cpu().numpy()
for b in (bits_e, bits_g, bits_p):
    assert (b[:, 0] == 1).all() and (b[:, 20] == 0).all() \
        and (b[:, 39] == 1).all()

emp = bits_e[:, 7].mean()
print(f"exact-sampler empirical P(x7=1 | evidence) = {emp:.4f} "
      f"(true {p:.4f})")
assert abs(emp - p) < (0.05 if SMOKE else 0.02)

# every drawn MPE candidate scores at most the exact MPE value
mpe_bits = np.asarray([assignment.get(v, evidence.get(v, 0))
                       for v in range(n)])
th = mrf.theta.double().cpu().numpy()


def beta_logpot(b):
    total = 0.0
    for k, C in enumerate(mrf.cliques):
        y = 0
        for v in C:
            y = (y << 1) | int(b[v])
        total += th[mrf.theta_offsets[k] + y]
    return float(mrf.beta) * total


assert all(beta_logpot(b) <= beta_logpot(mpe_bits) + 1e-6 for b in bits_p)
print("serving walkthrough OK")
