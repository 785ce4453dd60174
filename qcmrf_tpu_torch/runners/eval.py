"""Evaluation CLI (port of :mod:`qcmrf_tpu.runners.eval`)::

    python -m qcmrf_tpu_torch eval --results result_analytic_0.1.json \\
        --scale 0.1 --res-root <dir holding res_0.1/> [--kl] [--platform gpu]
    python -m qcmrf_tpu_torch eval --mode gibbs|pam --scale 0.1 \\
        [--num-samples 10000] [--platform cpu]

Prints the fidelity / success-rate table and returns the per-graph
results. Every mode runs on the card unless ``--platform cpu`` is given
(the JAX CLI's ``cpu`` default for ``--mode file`` is not carried over);
``--native`` draws the gibbs/pam samples from the C++ engine on the host
(``qcmrf_tpu_torch/native``), the exact distributions staying on the
platform's device.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from qcmrf_tpu_torch.evaluation.harness import (
    GraphResult,
    evaluate_suite,
    load_result_dists,
    results_table,
)
from qcmrf_tpu_torch.models.suite import generate_suite, load_suite


def main(argv: Optional[List[str]] = None) -> List[GraphResult]:
    parser = argparse.ArgumentParser(
        prog="QCMRF result evaluation (PyTorch / CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--results", type=str,
                        default="result_ehningen.json",
                        help="Result file as downloaded from backend.")
    parser.add_argument("--scale", type=str, default="0.1",
                        help="Variance of parameter prior.")
    parser.add_argument("--mode", type=str, default="file",
                        help="file or gibbs or pam.")
    parser.add_argument("--native", action="store_true",
                        help="Use the C++ engine for gibbs/pam sampling.")
    parser.add_argument("--res-root", type=str, default=".",
                        help="Directory containing res_{scale}/ folders.")
    parser.add_argument("--kl", action="store_true",
                        help="Also report mean KL divergence.")
    parser.add_argument("--norm", type=float, default=None,
                        help="Override the counts normalization (10000 "
                             "for raw counts); pass the actual shot count "
                             "for files produced with --shots != 10000.")
    parser.add_argument("--platform", type=str, default=None,
                        choices=["cpu", "gpu", "default"],
                        help="Device for the exact Gibbs tables, lnZ and "
                             "the samplers; 'default' (also when unset) "
                             "means 'gpu'.")
    parser.add_argument("--num-samples", type=int, default=10_000,
                        help="gibbs/pam modes: samples to histogram (the "
                             "success column divides by the fixed 10000 "
                             "norm, as the reference does).")
    parser.add_argument("--seed", type=int, default=0,
                        help="gibbs/pam modes: keys the chains and seeds "
                             "the perturbations.")
    from qcmrf_tpu_torch.utils.config import (
        parse_with_config,
        resolve_platform,
    )

    args = parse_with_config(parser, argv)
    device = resolve_platform(args.platform or "default")

    # suite: prefer the stored models file, else regenerate
    res_dir = os.path.join(args.res_root, f"res_{args.scale}")
    suite = None
    for name in (f"models_{args.scale}.json", "models.json"):
        p = os.path.join(res_dir, name)
        if os.path.isfile(p):
            suite = load_suite(p, float(args.scale))
            break
    if suite is None:
        suite = generate_suite(float(args.scale))

    dists, norm = (None, 10_000)
    if args.mode == "file":
        dists, norm = load_result_dists(os.path.join(res_dir, args.results))
    if args.norm is not None:
        norm = args.norm

    results = evaluate_suite(suite, dists=dists, norm=norm, mode=args.mode,
                             native=args.native, device=device,
                             num_samples=args.num_samples, seed=args.seed)
    print(results_table(results, with_kl=args.kl))
    return results


if __name__ == "__main__":
    main()
