"""Times the plane engine's host-bound paths in one source tree, so that two
trees, or two ways of uploading the kernels' tables, can be compared in
one session on one card (run the variants as A, B, B, A).

    python3 qcmrf_tpu_torch/runners/host_ab.py sandwich24 [--root DIR]
    python3 qcmrf_tpu_torch/runners/host_ab.py lowered28 [--sync-upload]

``sandwich24`` runs ``chip_smoke.py``'s width-24 sandwich cases (k = 1, 2
and 7, and the write-only k = 7 form: each held against its plain version,
then timed by CUDA events) with the ``qcmrf_tpu_torch`` package found
under ``DIR`` (default: this checkout), so an older tree unpacked there is
timed by the same code. ``lowered28`` runs bench.py's qcmrf28 chain
lowered to basis gates through ``planes.run_statevector`` twice, timed by
CUDA events and by the host clock; ``--sync-upload`` sends every term and
matrix table up with a plain ``.to(device)``, which waits for the card,
in place of the pinned, non-blocking upload. Prints one JSON line. Needs
a CUDA device; the script file is run by its path, not with ``-m``.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sync_upload(K) -> None:
    """Replace the kernels' table upload with a synchronous copy from
    pageable memory."""
    import torch

    @functools.lru_cache(maxsize=64)
    def device_bytes(blob: bytes, device):
        return torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device)

    K._device_bytes = device_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=("sandwich24", "lowered28"))
    ap.add_argument("--root", type=Path, default=CHECKOUT,
                    help="tree whose qcmrf_tpu_torch package is timed")
    ap.add_argument("--sync-upload", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from qcmrf_tpu_torch.ops import _build, kernels as K
    if not torch.cuda.is_available():
        print("host_ab: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    if args.sync_upload:
        _sync_upload(K)
    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    _build.build()
    _build.library()
    out = dict(case=args.case, package=str(Path(K.__file__).parents[1]),
               sync_upload=args.sync_upload)
    if args.case == "sandwich24":
        report = {}
        smoke.phase_sandwich_kernels(dev, report)
        out["ms"] = {k: v["ms"] for k, v in report["sandwich_w24"].items()}
    else:
        from qcmrf_tpu_torch.sim import planes

        _, low = smoke.lowered_chain(smoke.LOWERED_WIDTH // 2)
        runs = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            re, im = planes.run_statevector(low, device=dev)
            end.record()
            torch.cuda.synchronize()
            runs.append(dict(ms=start.elapsed_time(end),
                             host_s=time.perf_counter() - t0))
            del re, im
        out["runs"] = runs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
