"""Times the candidate designs of the dense lane pass against the library's
``lane_kernel`` and one float32 ``torch.matmul`` on the same planes in one
process, and holds each to the float64 product of the same input.

    python3 qcmrf_tpu_torch/runners/lane_designs.py [--n 28] [--reps 20]

The candidates are the kernels of ``lane_designs.cu`` beside this script
(built here with ``nvcc`` into the git-ignored ``build/`` directory; not
part of the kernel library); the header of that file describes them. The
lane op is a random unitary M (so that passes chained in place neither
grow nor shrink the state) on a random unit-norm state of ``2^n``
values. Each design's error is the relative 2-norm of its output against
the float64 product (:func:`relative_error`); it passes the card's
accuracy check when that is at most ``REL_LIMIT`` and at most
``F32_FACTOR`` times float32 ``torch.matmul``'s error on the same input
(:func:`accurate`). Every design is timed by CUDA events over ``--reps``
passes after one warm-up, in two rounds, the second in the reverse
order. Prints the card's name and power limit on the line before the JSON
line. Needs a CUDA device; the script file is run by its path, not with
``-m``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().with_suffix(".cu")

#: the card's accuracy check of a dense lane pass: relative 2-norm error
#: against the float64 product at most REL_LIMIT, and at most F32_FACTOR
#: times float32 torch.matmul's on the same input
REL_LIMIT = 2e-6
F32_FACTOR = 4.0


def stacked_w(M, device, dtype=torch.float32) -> torch.Tensor:
    """The lane op as one real (256, 256) matrix on planes stacked as
    ``[re | im]``: ``[[Mr^T, Mi^T], [-Mi^T, Mr^T]]``, from M's float32
    parts."""
    M = np.asarray(M, np.complex64)
    mr = torch.from_numpy(np.ascontiguousarray(M.real)).to(device, dtype)
    mi = torch.from_numpy(np.ascontiguousarray(M.imag)).to(device, dtype)
    return torch.cat([torch.cat([mr.T, mi.T], 1),
                      torch.cat([-mi.T, mr.T], 1)])


def relative_error(M, planes_in, planes_out, chunk=1 << 19) -> float:
    """``|out - X W|_2 / |X W|_2`` with ``X W`` the float64 product of the
    input planes, stacked as ``[re | im]``; ``planes_out`` is a pair of
    planes or one stacked ``(rows, 256)`` tensor."""
    W = stacked_w(M, planes_in[0].device, torch.float64)
    X = [p.reshape(-1, 128) for p in planes_in]
    if isinstance(planes_out, torch.Tensor):
        Y = [planes_out[:, :128], planes_out[:, 128:]]
    else:
        Y = [p.reshape(-1, 128) for p in planes_out]
    num = den = 0.0
    for lo in range(0, X[0].shape[0], chunk):
        ref = torch.cat([x[lo:lo + chunk] for x in X], 1).double() @ W
        got = torch.cat([y[lo:lo + chunk] for y in Y], 1).double()
        num += float(((got - ref) ** 2).sum())
        den += float((ref ** 2).sum())
    return (num / den) ** 0.5


def accurate(err: float, f32_err: float) -> bool:
    """The card's accuracy check of a dense lane pass."""
    return err <= REL_LIMIT and err <= F32_FACTOR * f32_err


def random_unitary(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    a = rng.randn(128, 128) + 1j * rng.randn(128, 128)
    return np.linalg.qr(a)[0].astype(np.complex64)


def _library():
    from qcmrf_tpu_torch.ops import _build

    digest = hashlib.sha256(SOURCE.read_bytes()
                            + (_build.CSRC / "gate_kernels.cu").read_bytes()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = (_build.BUILD_ROOT / "lane_designs" / digest.hexdigest()[:16]
           / "liblane_designs.so")
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(out), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "design_lane_fold": (I, P, P, P, I64, P),
        "design_lane_wgmma": (P, P, P, I64, P),
        "design_lane_mma": (I, I, P, P, P, I64, P),
        "design_lane_sync": (I, P, P, P, I64, P),
        "design_lane_one_pass": (P, P, P, I64, P),
        "design_lane_fma": (P, P, P, I64, P),
    }
    for name, args in signatures.items():
        getattr(lib, name).argtypes = list(args)
        getattr(lib, name).restype = I
    lib.design_error_string.argtypes = [I]
    lib.design_error_string.restype = ctypes.c_char_p
    return lib


def _planes_of(M, device) -> torch.Tensor:
    M = np.asarray(M, np.complex64)
    return torch.from_numpy(np.concatenate(
        [M.real.ravel(), M.imag.ravel()]).astype(np.float32)).to(device)


def _designs(lib, M):
    """name -> apply(re, im), each in place on the planes."""
    from qcmrf_tpu_torch.ops import kernels as K

    device = torch.device("cuda", torch.cuda.current_device())
    m, mt = _planes_of(M, device), _planes_of(M.T, device)

    def call(name, mat, *head):
        fn = getattr(lib, name)

        def run(re, im):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(*head, ctypes.c_void_p(mat.data_ptr()),
                      ctypes.c_void_p(re.data_ptr()),
                      ctypes.c_void_p(im.data_ptr()), re.numel() // 128,
                      ctypes.c_void_p(stream))
            if code:
                raise RuntimeError(f"{name}{head}: CUDA error {code} "
                                   f"({lib.design_error_string(code)})")
        return run

    designs = {"library lane_kernel (3xTF32 on wgmma, 2 warpgroups a CTA, "
               "fold 2)": lambda re, im: K.apply_lane(re, im, M),
               "f: the library's kernel at fold 4": call(
                   "design_lane_fold", m, 4),
               "w: wgmma, one warpgroup a CTA": call("design_lane_wgmma",
                                                     m)}
    for fold in (1, 2, 4):
        designs[f"m: mma.sync, fold {fold}"] = call("design_lane_mma", m,
                                                    fold, 1)
    designs["t: mma.sync, fold 2, lo left to the tensor cores"] = call(
        "design_lane_mma", m, 2, 0)
    for fold in (2, 16):
        designs[f"s: mma.sync, tile read whole, fold {fold}"] = call(
            "design_lane_sync", m, fold)
    designs["1: one TF32 pass (tile read whole)"] = call(
        "design_lane_one_pass", m)
    designs["c: float32 FMAs on the CUDA cores"] = call("design_lane_fma",
                                                        mt)
    return designs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=28)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from qcmrf_tpu_torch.runners import bench

    if not torch.cuda.is_available():
        print("lane_designs: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    M = random_unitary(28)
    re0, im0 = bench._random_planes(args.n, dev)
    scale = float(torch.cat([re0, im0]).double().norm())
    re0.div_(scale)
    im0.div_(scale)
    designs = _designs(_library(), M)
    errors = {}
    for name, fn in designs.items():
        re, im = re0.clone(), im0.clone()
        fn(re, im)
        torch.cuda.synchronize()
        errors[name] = relative_error(M, (re0, im0), (re, im))
        del re, im
    X = torch.cat([re0.reshape(-1, 128), im0.reshape(-1, 128)], 1)
    W = stacked_w(M, dev)
    out = torch.empty_like(X)
    matmuls = {"torch.matmul float32": False,
               "torch.matmul TF32 (allow_tf32)": True}
    for name, tf32 in matmuls.items():
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.matmul(X, W, out=out)
        torch.cuda.synchronize()
        errors[name] = relative_error(M, (re0, im0), out)
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = errors["torch.matmul float32"]
    re, im = re0.clone(), im0.clone()
    runs = {name: (lambda i, fn=fn: fn(re, im))
            for name, fn in designs.items()}
    for name, tf32 in matmuls.items():
        def run(i, tf32=tf32):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.matmul(X, W, out=out)
        runs[name] = run
    rounds = []
    for order in (list(runs), list(runs)[::-1]):
        rounds.append({name: bench._chain_pass_ms(runs[name], dev,
                                                  passes=args.reps, reps=1)
                       for name in order})
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {}
    for name in runs:
        ms = [r[name] for r in rounds]
        result[name] = dict(ms=sum(ms) / len(ms), rounds=ms,
                            rel_error=errors[name],
                            passes_check=accurate(errors[name], f32))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    print(json.dumps(dict(n=args.n, reps=args.reps, card=smi,
                          check=f"rel <= {REL_LIMIT} and <= {F32_FACTOR} x "
                                f"float32 torch.matmul's ({f32:.3e})",
                          designs=result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
