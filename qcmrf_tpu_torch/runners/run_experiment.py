"""Experiment driver: generate/load a suite, sample it, dump counts JSON
(port of :mod:`qcmrf_tpu.runners.run_experiment`).

Builds the 70 circuits of a suite, samples each at ``--shots`` shots, and
writes ``result_{engine}_{scale}.json`` in the schema of the stored result
files, so either package's evaluation harness reads it: a JSON list of 70
``{bitstring: count}`` dicts, or for a mitigated noisy engine a hardware
file ``{"quasi_dists": [...], "metadata": [...]}``.

* ``analytic``: the shots of one graph's reps are drawn from the
  closed-form outcome law by one launch of the fused sampler (on the CPU,
  its plain version); circuit ``i`` of the suite draws from Philox key
  ``(--sample-seed, i)``.
* ``statevector``: the suite's 70 gate-level circuits run as one launch
  of the whole-circuit kernel (on the CPU, its plain version, the dense
  engine), and circuit ``i`` of the suite draws its shots from its
  ``|psi|^2`` by inverse CDF with a ``torch.Generator`` on the run's
  device seeded with ``--sample-seed * 65536 + i``. The probabilities are
  those of the JAX package's dense engine; the counts are not its counts,
  since ``jax.random`` and ``torch`` draw different numbers.
* ``noisy:<preset>``: the preset's closed-form noisy law
  (:mod:`qcmrf_tpu_torch.noise.backends`), circuit ``i`` sampled as under
  the statevector engine; mitigated presets write the hardware schema.
* ``calibrated:<hw>``: the physical per-gate noise model of the stored
  calibration for that backend and scale
  (:mod:`qcmrf_tpu_torch.noise.physical`: each graph's reps as one batch
  of the density engine on the device), mitigated. With ``--res-root``
  given and ``res_{scale}/result_{hw}.json`` under it, the per-graph
  calibrated model is fitted to that file instead
  (:func:`qcmrf_tpu_torch.noise.fit.fit_calibrated`) and emulated.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Union

from qcmrf_tpu_torch.models.suite import (
    SHOTS,
    ModelSuite,
    generate_suite,
    load_suite,
    reference_models_path,
    reference_results_path,
)
from qcmrf_tpu_torch.ops import circuit_kernel
from qcmrf_tpu_torch.sim import batch as sbatch
from qcmrf_tpu_torch.sim import sampler
from qcmrf_tpu_torch.sim.sampler import circuit_seed
from qcmrf_tpu_torch.utils.config import resolve_device

def _calibrated(suite: ModelSuite, backend: str, shots: int, seed: int,
                device, res_root: Optional[str]) -> dict:
    """The ``calibrated:<hw>`` engine: a fit to target data when
    ``res_root`` holds ``res_{scale}/result_{hw}.json``, else the stored
    physical calibration."""
    from qcmrf_tpu_torch.noise import physical

    target = (None if res_root is None else
              reference_results_path(suite.scale, backend, res_root))
    if target is not None and os.path.isfile(target):
        from qcmrf_tpu_torch.evaluation.harness import load_result_dists
        from qcmrf_tpu_torch.noise.backends import run_calibrated_suite
        from qcmrf_tpu_torch.noise.fit import fit_calibrated

        dists, norm = load_result_dists(target)
        model = fit_calibrated(backend, suite, dists, norm, device=device)
        return run_calibrated_suite(seed, suite, model, shots, device=device)
    path = physical.calibration_path(backend, suite.scale)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"calibrated:{backend} at scale {suite.scale:g} needs the stored "
            f"calibration {path} or target data "
            + (f"{target}" if target else
               f"res_{suite.scale:g}/result_{backend}.json under --res-root"))
    model = physical.load_physical(backend, suite.scale)
    return physical.run_physical_suite(seed, suite, model, shots,
                                       device=device)


def run_suite(
    suite: ModelSuite,
    shots: int = SHOTS,
    engine: str = "analytic",
    seed: int = 0,
    device=None,
    res_root: Optional[str] = None,
) -> Union[List[Dict[str, int]], dict]:
    """Sample every circuit of the suite on ``device`` (the current CUDA
    device unless the caller names one); returns counts dicts in order,
    or a hardware result file (``quasi_dists`` and ``metadata``) for a
    mitigated noisy engine. ``res_root`` holds the ``calibrated:``
    engine's target data, when there are any."""
    family, _, backend = engine.partition(":")
    if family == "calibrated":
        return _calibrated(suite, backend or "torino", shots, seed,
                           resolve_device(device), res_root)
    if family == "noisy":
        from qcmrf_tpu_torch.noise import backends

        model = backends.preset(backend or "torino")
        return backends.run_noisy_suite(seed, suite, model, shots,
                                        device=device)
    if engine not in ("analytic", "statevector"):
        raise ValueError(f"unknown engine {engine!r}")
    device = resolve_device(device)
    counts_list: List[Dict[str, int]] = []
    if engine == "statevector":
        probs = circuit_kernel.batched_circuits_probs(
            [(C, suite.thetas[j]) for j, C in enumerate(suite.graphs)],
            device=device)
    for j, C in enumerate(suite.graphs):
        n = max(v for c in C for v in c) + 1
        width = n + len(C) + 1
        if engine == "analytic":
            keys = sbatch.batched_sample_outcomes(
                C, suite.thetas[j], seed, shots, stream0=len(counts_list),
                device=device).cpu().numpy()
            for row in keys:
                counts_list.append(sampler.counts_from_samples(row, width))
        else:
            for row in probs[j]:
                counts_list.append(sampler.sample_counts(
                    circuit_seed(seed, len(counts_list)), row, shots,
                    width))
    return counts_list


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(
        prog="QCMRF experiment driver (PyTorch / CUDA).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--scale", type=str, default="0.5",
                        help="Variance of parameter prior.")
    parser.add_argument("--shots", type=int, default=SHOTS)
    parser.add_argument("--engine", type=str, default="analytic",
                        help="analytic | statevector | noisy:<preset> | "
                             "calibrated:<hw backend>")
    parser.add_argument("--res-root", type=str, default=None,
                        help="Root holding res_{scale}/models_{scale}.json "
                             "(the stored suite there is used when "
                             "present; default '.') and the calibrated "
                             "engine's target data res_{scale}/result_"
                             "{hw}.json (refit only when this is given).")
    parser.add_argument("--models", type=str, default=None,
                        help="Load suite from this models_*.json instead of "
                             "regenerating from seed 1984.")
    parser.add_argument("--outdir", type=str, default=".")
    parser.add_argument("--sample-seed", "--seed", dest="sample_seed",
                        type=int, default=0)
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="Device for sampling; 'default' means 'gpu', "
                             "and a GPU that is not there raises.")
    from qcmrf_tpu_torch.utils.config import (
        dump_effective_config,
        parse_with_config,
        resolve_platform,
    )

    args = parse_with_config(parser, argv)
    device = resolve_platform(args.platform)

    if args.models:
        suite = load_suite(args.models, float(args.scale))
    else:
        ref = reference_models_path(float(args.scale), args.res_root or ".")
        if os.path.isfile(ref):
            suite = load_suite(ref, float(args.scale))
        else:
            suite = generate_suite(float(args.scale))

    os.makedirs(args.outdir, exist_ok=True)
    suite.save(os.path.join(args.outdir, f"models_{args.scale}.json"))
    dump_effective_config(
        args, os.path.join(args.outdir, f"config_run_{args.scale}.json")
    )

    from qcmrf_tpu_torch.utils import profiling

    ctr = profiling.Counter()
    with profiling.stopwatch(ctr, device=device):
        counts = run_suite(suite, shots=args.shots, engine=args.engine,
                           seed=args.sample_seed, device=device,
                           res_root=args.res_root)
    tag = args.engine.replace(":", "_")
    out_path = os.path.join(args.outdir, f"result_{tag}_{args.scale}.json")
    with open(out_path, "w") as f:
        f.write(json.dumps(counts, indent=4))
    num = (len(counts["quasi_dists"]) if isinstance(counts, dict)
           else len(counts))
    ctr.add(items=float(num) * args.shots)
    print(f"wrote {out_path} ({num} circuits, {args.shots} shots on "
          f"{device}; {ctr.seconds:.1f}s, {ctr.items_per_sec:,.0f} "
          "shots/sec end-to-end)")
    return out_path


if __name__ == "__main__":
    main()
