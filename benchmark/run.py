"""Run one cell of the benchmark of ``qcmrf_tpu_torch`` on this machine's
card and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic mix and
metrics are found from ``BENCHMARK.json`` (see ``benchmark/harness.py``).
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a Kineto trace of the window.
The run exits non-zero and prints no result where PyTorch sees fewer CUDA
devices than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or
``qcmrf_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout;
    no library may load JAX on its own."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch_kernels")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        parser.error("--seed must be >= 0 and --seconds > 0")
    _environment()
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    cell, _, _ = harness.cell_inputs(spec, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"PyTorch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
