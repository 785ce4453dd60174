"""Emulate IBM hardware: calibrated noise, mitigation, whisker figure.

The reference ran its suite on real IBM backends (ibm_torino etc.). This
example runs that pipeline without a cloud account: load the stored
PHYSICAL per-gate noise calibration of torino (gate-level depolarizing in
the density-matrix engine, readout and mitigation drift,
``noise/physical.py``), emulate the seed-1984 suite shot by shot
(sampling, then tensored readout mitigation: negative quasi-probs), and
hold each graph's mean emulated fidelity and acceptance against the
calibration's infinite-shot expectation (the same harness scores
both). It ends with the reference's
whisker figure rendered from the emulated tables of the three scales.

The PyTorch / CUDA port of ``examples/05_hardware_emulation.py``. The
suites come from ``generate_suite`` and the figure from the emulated
files, so no stored hardware table is read; the figure goes to
``torch_success_torino.pdf`` in the temporary directory (``$TMPDIR``).

    python qcmrf_tpu_torch/examples/05_hardware_emulation.py
"""

import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# QCMRF_EXAMPLE_SMOKE: the test tier's reduced-size run, on the CPU: the
# first 2 graphs at 2k shots (the tolerance checks below need the full
# suite's shots, so they run at full size only)
SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))
DEVICE = "cpu" if SMOKE else None
OUT = os.path.join(tempfile.gettempdir(), "torch_success_torino.pdf")

import numpy as np  # noqa: E402

from qcmrf_tpu_torch.evaluation.harness import evaluate_suite  # noqa: E402
from qcmrf_tpu_torch.models.mrf import MRF  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.noise import physical  # noqa: E402
from qcmrf_tpu_torch.viz import whisker  # noqa: E402

SHOTS = 2_000 if SMOKE else 10_000


def emulate(scale: float):
    """The suite at ``scale`` (its first 2 graphs in smoke mode, which the
    whisker's focus graph 1 needs) through the physical emulator."""
    suite = generate_suite(scale)
    if SMOKE:
        suite = dataclasses.replace(
            suite, graphs=suite.graphs[:2],
            thetas={j: suite.thetas[j] for j in (0, 1)})
    model = physical.load_physical("torino", scale)
    return suite, model, physical.run_physical_suite(
        0, suite, model, shots=SHOTS, device=DEVICE)


def expected_dists(suite, model):
    """Every circuit's infinite-shot mitigated quasi-distribution under the
    calibration (mitigation is linear, so it is the expectation of the
    emulated one), as a result file's dicts."""
    from qcmrf_tpu_torch.sim.sampler import key_string

    dists = []
    for g, C in enumerate(suite.graphs):
        mrfs = [MRF.create(C, theta=t, device=DEVICE)
                for t in suite.thetas[g]]
        width = mrfs[0].n + len(C) + 1
        mults = physical.rep_multipliers(model, g, len(mrfs))
        probs = physical.gate_noisy_probs_batch(
            mrfs, [model.lam[g] * u for u in mults])
        for r, m in enumerate(mrfs):
            q = physical.expected_quasi(m, model, g, probs[r], mults[r])
            dists.append({key_string(k, width): float(v) for k, v in
                          enumerate(q.double().cpu().numpy()) if v != 0})
    return dists


with tempfile.TemporaryDirectory() as root:
    for scale in whisker.SCALES:
        suite, model, result = emulate(scale)
        os.makedirs(os.path.join(root, f"res_{scale:g}"))
        with open(os.path.join(root, f"res_{scale:g}",
                               "result_emulated_torino.json"), "w") as f:
            json.dump(result, f)
        if scale != 0.1:
            continue
        emu = evaluate_suite(suite, dists=result["quasi_dists"], norm=1,
                             device=DEVICE)
        exp = evaluate_suite(suite, dists=expected_dists(suite, model),
                             norm=1, device=DEVICE)
        print(f"{'graph':>34}  {'F(exp)':>6} {'F(emu)':>6}  "
              f"{'d(exp)':>6} {'d(emu)':>6}  {'KL(exp)':>7} {'KL(emu)':>7}")
        for e, x in zip(emu, exp):
            print(f"{str(e.graph):>34}  {x.mean_f:6.3f} {e.mean_f:6.3f}  "
                  f"{x.mean_delta:6.3f} {e.mean_delta:6.3f}  "
                  f"{x.mean_kl:7.4f} {e.mean_kl:7.4f}")
            if not SMOKE:  # sliced-suite means are shot-noise-dominated
                assert abs(e.mean_delta - x.mean_delta) <= 0.02
                assert abs(e.mean_f - x.mean_f) <= 0.02

    # the reference's success_{backend}.pdf from the emulated tables
    if os.path.exists(OUT):
        os.remove(OUT)
    whisker.main(["--backend", "emulated_torino", "--res-root", root,
                  "--out", OUT,
                  "--platform", "cpu" if SMOKE else "default"])
assert os.path.exists(OUT)
