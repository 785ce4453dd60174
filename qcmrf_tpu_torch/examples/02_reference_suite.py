"""Run the reference's 70-circuit suite and evaluate it: pure library use.

Mirrors the CLI pipeline (``python -m qcmrf_tpu_torch run`` + ``eval``) in
code: regenerate the seed-1984 suite at scale 0.1, sample it with the
analytic engine, then compute the per-graph fidelity / success table
against exact inference (BASELINE.md scale 0.1: F 0.999-1.000, success
0.757-0.936). The PyTorch / CUDA port of
``examples/02_reference_suite.py``; the suite comes from
``generate_suite``, so no stored model file is read.

    python qcmrf_tpu_torch/examples/02_reference_suite.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run (fewer shots, on
# the CPU); without it the example runs on the current CUDA device
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
DEVICE = "cpu" if SMOKE else None

from qcmrf_tpu_torch.evaluation.harness import (  # noqa: E402
    evaluate_suite,
    results_table,
)
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.runners.run_experiment import run_suite  # noqa: E402

SHOTS = 1_000 if SMOKE else 10_000
suite = generate_suite(0.1)
counts = run_suite(suite, shots=SHOTS, engine="analytic", seed=0,
                   device=DEVICE)
results = evaluate_suite(suite, dists=counts, norm=SHOTS, device=DEVICE)
print(results_table(results))
if not SMOKE:
    assert all(r.mean_f >= 0.99 for r in results)
