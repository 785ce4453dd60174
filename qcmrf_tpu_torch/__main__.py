"""Unified CLI: ``python -m qcmrf_tpu_torch <command> [args]``.

Commands:
    run       experiment driver (counts JSON): analytic and statevector
              engines, noisy:<preset> and calibrated:<hw> hardware emulation
    eval      evaluation tables: --mode file, or the classical samplers
              (--mode gibbs|pam, --native for the C++ engine)
    whisker   success-rate figures (success_<backend>.pdf)
    infer     inference queries: lnz, prob, map, mmap, marginals, sample
              (--method ais: annealed importance sampling, no cap)
    train     MLE training (exact, shot and AIS gradients, bit-array data
              past n = 30, structure learning), with checkpoints
    bench     micro-benchmarks on the card: sampler shots/s, table, lnZ,
              gate rates, the suite's gate-level circuits (--json,
              --trace DIR for a Kineto trace)

``infer`` and ``train`` take ``--mesh AxB`` (the sweeps, shots and AIS
chains sharded over a device mesh).
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        from qcmrf_tpu_torch.runners.run_experiment import main as m

        m(rest)
    elif cmd == "eval":
        from qcmrf_tpu_torch.runners.eval import main as m

        m(rest)
    elif cmd == "whisker":
        from qcmrf_tpu_torch.viz.whisker import main as m

        m(rest)
    elif cmd == "infer":
        from qcmrf_tpu_torch.runners.infer_cli import main as m

        m(rest)
    elif cmd == "train":
        from qcmrf_tpu_torch.runners.train_cli import main as m

        m(rest)
    elif cmd == "bench":
        from qcmrf_tpu_torch.runners.bench import main as m

        m(rest)
    else:
        print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
