"""Times the candidate designs of the plane copy against the library's
``copy_kernel`` and the planes' two ``copy_`` calls, on the same planes in
one process, and checks that each copies both planes exactly.

    python3 qcmrf_tpu_torch/runners/copy_designs.py [--n 28] [--reps 50]

The candidates are the kernels of ``copy_designs.cu`` beside this script
(built here with ``nvcc`` into the git-ignored ``build/`` directory; not
part of the kernel library). Every design is timed by CUDA events over
``--reps`` launches after one warm-up, in two rounds, the second in the
reverse order; the JSON line gives each round's milliseconds, their mean
and the rate in TB/s (16 bytes a value). Prints the card's name and power
limit on the line before. Needs a CUDA device; the script file is run by
its path, not with ``-m``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().with_suffix(".cu")


def _library():
    from qcmrf_tpu_torch.ops import _build

    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = (_build.BUILD_ROOT / "copy_designs" / digest.hexdigest()[:16]
           / "libcopy_designs.so")
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(out), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "copy_strided": (P, P, P, P, I64, P),
        "copy_plane_by_plane": (P, P, P, P, I64, P),
        "copy_unrolled": (I, P, P, P, P, I64, P),
        "copy_bulk": (I, I, I, P, P, P, P, I64, P),
    }
    for name, args in signatures.items():
        getattr(lib, name).argtypes = list(args)
        getattr(lib, name).restype = I
    lib.design_error_string.argtypes = [I]
    lib.design_error_string.restype = ctypes.c_char_p
    return lib


def _designs(lib, torch, K):
    """name -> copy(src pair, dst pair)."""

    def call(name, *head):
        fn = getattr(lib, name)

        def run(src, dst):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(*head, *(ctypes.c_void_p(t.data_ptr())
                               for t in (*src, *dst)), src[0].numel(),
                      ctypes.c_void_p(stream))
            if code:
                raise RuntimeError(f"{name}{head}: CUDA error {code} "
                                   f"({lib.design_error_string(code)})")
        return run

    designs = {
        "library copy_kernel (b: 2 float4 a thread, covering grid)":
            lambda s, d: K.copy_planes(*s, out=d),
        "copy_ x2": lambda s, d: (d[0].copy_(s[0]), d[1].copy_(s[1])),
        "s: the earlier grid-stride loop, 4 interleaved streams":
            call("copy_strided"),
        "a: plane by plane, grid-stride": call("copy_plane_by_plane"),
    }
    for unroll in (4, 8):
        designs[f"b: {unroll} float4 a thread, covering grid"] = call(
            "copy_unrolled", unroll)
    for chunk, stages, per_sm in ((32768, 4, 1), (32768, 3, 2)):
        designs[f"c: bulk ring {chunk >> 10} KB x {stages}, {per_sm} "
                f"block/SM"] = call("copy_bulk", chunk, stages, per_sm)
    return designs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=28)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.runners import bench

    if not torch.cuda.is_available():
        print("copy_designs: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    designs = _designs(_library(), torch, K)
    src = bench._random_planes(args.n, dev)
    dst = tuple(torch.empty_like(t) for t in src)
    for name, fn in designs.items():
        for t in dst:
            t.zero_()
        fn(src, dst)
        torch.cuda.synchronize()
        if not (torch.equal(dst[0], src[0]) and torch.equal(dst[1], src[1])):
            raise AssertionError(f"{name}: planes not copied exactly")
    rounds = []
    for order in (list(designs), list(designs)[::-1]):
        rounds.append({name: bench._chain_pass_ms(
            lambda i, fn=designs[name]: fn(src, dst), dev,
            passes=args.reps, reps=1) for name in order})
    nbytes = 16 << args.n
    result = {}
    for name in designs:
        ms = [r[name] for r in rounds]
        mean = sum(ms) / len(ms)
        result[name] = dict(ms=mean, rounds=ms, tb_per_s=nbytes / mean / 1e9)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    print(json.dumps(dict(n=args.n, reps=args.reps, card=smi,
                          designs=result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
