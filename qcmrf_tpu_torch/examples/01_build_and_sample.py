"""Build an MRF, compile its QCMRF circuit, sample, compare to exact Gibbs.

The minimum end-to-end loop of the framework in a dozen lines, on the card
(the PyTorch / CUDA port of ``examples/01_build_and_sample.py``).

    python qcmrf_tpu_torch/examples/01_build_and_sample.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run (fewer shots, on
# the CPU); without it the example runs on the current CUDA device and
# raises where there is none
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
DEVICE = "cpu" if SMOKE else None

import numpy as np  # noqa: E402

from qcmrf_tpu_torch import MRF, compile_qcmrf, fidelity  # noqa: E402
from qcmrf_tpu_torch.evaluation.metrics import extract_probs  # noqa: E402
from qcmrf_tpu_torch.sim import analytic, sampler  # noqa: E402

# a triangle MRF over 3 binary variables; theta <= 0 (one weight per
# clique state, binary-counting order with y[0] slowest)
rng = np.random.RandomState(0)
mrf = MRF.create([[0, 1, 2]], theta=-np.abs(rng.randn(8)) * 0.4,
                 device=DEVICE)

# the compiled circuit (n variables + 1 ancilla/clique + 1 workspace)
circ = compile_qcmrf(mrf)
print(f"circuit: {circ.num_qubits} qubits, {len(circ.gates)} gates "
      f"on {mrf.device}")

# closed-form outcome law: post-selected distribution == Gibbs, and the
# acceptance rate delta == Z / 2^n
p_exact = mrf.gibbs_probs().double().cpu().numpy()
p_circ, delta = analytic.postselected_probs(mrf)
print(f"delta = {float(delta):.4f}  (Z/2^n = "
      f"{float(mrf.success_rate()):.4f})")

# shot sampling (the sampler kernel) + the reference's extract_probs
# post-selection
keys = analytic.sample_outcomes(0, mrf, 2_000 if SMOKE else 10_000)
counts = sampler.counts_from_samples(keys, circ.num_qubits)
q, delta_hat = extract_probs(counts, mrf.n, mrf.num_cliques + 1)
print(f"fidelity(exact, sampled) = {fidelity(p_exact, q):.4f}, "
      f"delta_hat = {delta_hat:.4f}")
