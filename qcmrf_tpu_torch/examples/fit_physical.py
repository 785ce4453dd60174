"""Fit the physical per-gate noise model to stored hardware tables and
write the calibration JSONs the ``calibrated:<hw>`` engine loads.

    python qcmrf_tpu_torch/examples/fit_physical.py --res-root DIR \
        [--combos torino:0.1 ...] [--polish-only] [--platform cpu]

``DIR`` holds the reference's ``res_<scale>/models_<scale>.json`` and
``res_<scale>/result_<backend>.json`` (5 hardware tables: torino at
scales 0.1, 0.25 and 0.5, sherbrooke and ehningen at 0.1). The fitted
models go into ``qcmrf_tpu_torch/noise/calibrations/``. The density
engine runs on the card unless ``--platform cpu``. The PyTorch / CUDA
port of ``examples/fit_physical.py``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from qcmrf_tpu_torch.evaluation.harness import (  # noqa: E402
    evaluate_suite,
    load_result_dists,
)
from qcmrf_tpu_torch.models.suite import (  # noqa: E402
    load_suite,
    reference_models_path,
    reference_results_path,
)
from qcmrf_tpu_torch.noise import physical as ph  # noqa: E402
from qcmrf_tpu_torch.utils.config import resolve_platform  # noqa: E402

ALL_COMBOS = [
    ("torino", 0.1), ("sherbrooke", 0.1), ("ehningen", 0.1),
    ("torino", 0.25), ("torino", 0.5),
]


def _tables(backend: str, scale: float, root: str):
    suite = load_suite(reference_models_path(scale, root), scale)
    dists, norm = load_result_dists(
        reference_results_path(scale, backend, root))
    return suite, dists, norm


def _report(suite, dists, norm, model, device) -> None:
    targets = evaluate_suite(suite, dists=dists, norm=norm, device=device)
    out = ph.run_physical_suite(1, suite, model, shots=10_000,
                                device=device)
    got = evaluate_suite(suite, dists=out["quasi_dists"], norm=1,
                         device=device)
    print("graph | F tgt->got | std tgt->got | d tgt->got | "
          "stdd tgt->got | KL tgt->got")
    for t, g in zip(targets, got):
        print(f"  F {t.mean_f:.4f}->{g.mean_f:.4f} "
              f"stdF {t.std_f:.4f}->{g.std_f:.4f} | "
              f"d {t.mean_delta:.3f}->{g.mean_delta:.3f} "
              f"stdd {t.std_delta:.3f}->{g.std_delta:.3f} | "
              f"KL {t.mean_kl:.4f}->{g.mean_kl:.4f}")


def fit_one(backend: str, scale: float, root: str, device):
    suite, dists, norm = _tables(backend, scale, root)
    t0 = time.time()
    # predictive per-backend-rate fit: one p2q per backend; per-graph
    # mean-statistic freedom = the two readout-drift residuals
    model = ph.fit_physical_predictive(backend, suite, dists, norm,
                                       verbose=True, device=device)
    path = ph.save_physical(model)
    print(f"{backend}@{scale}: fitted in {time.time() - t0:.0f} s -> {path}")
    _report(suite, dists, norm, model, device)
    rates = ph.effective_cx_rates(suite, model, device)
    print("effective per-cx rates:", [round(r, 5) for r in rates])
    return model


def polish_one(backend: str, scale: float, root: str, device):
    suite, dists, norm = _tables(backend, scale, root)
    model = ph.load_physical(backend, scale)
    t0 = time.time()
    model = ph.polish_physical(suite, dists, norm, model, verbose=True,
                               device=device)
    path = ph.save_physical(model)
    print(f"{backend}@{scale}: polished in {time.time() - t0:.0f} s "
          f"-> {path}")
    _report(suite, dists, norm, model, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--combos", nargs="*", default=None,
                    help="backend:scale pairs (default: all stored tables)")
    ap.add_argument("--res-root", default="/root/reference",
                    help="directory of the reference's res_<scale>/ tables")
    ap.add_argument("--polish-only", action="store_true")
    ap.add_argument("--platform", default="default",
                    choices=["cpu", "gpu", "default"],
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    device = resolve_platform(args.platform)
    combos = ALL_COMBOS
    if args.combos:
        combos = [(c.split(":")[0], float(c.split(":")[1]))
                  for c in args.combos]
    for backend, scale in combos:
        if args.polish_only:
            polish_one(backend, scale, args.res_root, device)
        else:
            fit_one(backend, scale, args.res_root, device)


if __name__ == "__main__":
    main()
