"""Times the store designs of the log-potential table against the
library's ``logpot_kernel`` on the same models in one process, and checks
that every design writes the library kernel's table bit for bit.

    python3 qcmrf_tpu_torch/runners/logpot_designs.py [--reps 20]

The candidates are the kernels of ``logpot_designs.cu`` beside this script
(built here with ``nvcc`` into the git-ignored ``build/`` directory; not
part of the kernel library); the header of that file describes them.
Shapes: bench.py's K27 (2^27 states, 512 MiB a table) and the n=24 grid
4x6 of ``chip_smoke.py``'s table phase. Every design is timed by CUDA
events over ``--reps`` launches after one warm-up, in two rounds, the
second in the reverse order; the JSON line gives each round's
milliseconds and their mean. Prints the card's name and power limit on
the line before. Needs a CUDA device; the script file is run by its path,
not with ``-m``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().with_suffix(".cu")


def _library():
    from qcmrf_tpu_torch.ops import _build

    digest = hashlib.sha256(SOURCE.read_bytes()
                            + (_build.CSRC / "qcmrf_kernels.cu").read_bytes()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = (_build.BUILD_ROOT / "logpot_designs" / digest.hexdigest()[:16]
           / "liblogpot_designs.so")
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(out), str(SOURCE)], check=True,
                       stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out))
    P, I, I64, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.design_logpot.argtypes = [I, _build.SplitTables, P, I, I, I64, I, F,
                                  I, F, P, P]
    lib.design_logpot.restype = I
    lib.qcmrf_error_string.argtypes = [I]
    lib.qcmrf_error_string.restype = ctypes.c_char_p
    return lib


def _designs(lib, torch, K, cliques, n, coef, beta):
    """name -> a call that writes the table of (cliques, n, coef, beta)
    into its own buffer; every design, the library's too, is launched
    through its C entry point, so that no wrapper's host work enters the
    times."""
    from qcmrf_tpu_torch.ops import _build

    plan, tables = K._plan(cliques, n, coef.device)
    B, x0, parts, per_part = K._split_args(
        cliques, n, coef, K.split_shared_bytes(plan))

    def call(fn, *head, offset=()):
        # the library's entry point takes the sweep's first block
        out = torch.empty((B, 1 << n), dtype=torch.float32,
                          device=coef.device)

        def run():
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*head, tables, ctypes.c_void_p(coef.data_ptr()), B,
                     coef.shape[1], per_part, *offset, parts, beta, 0,
                     2.0 ** (-0.5 * n), ctypes.c_void_p(out.data_ptr()),
                     ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"{fn.__name__}{head}: CUDA error {err} "
                                   f"({lib.qcmrf_error_string(err)})")
            return out
        return run

    return {
        "i: stores from registers (library logpot_kernel)":
            call(_build.library().qcmrf_logpot, offset=(x0,)),
        "i': the same stores, evict-first (st.global.cs)":
            call(lib.design_logpot, 0),
        "ii: cp.async.bulk of each sub-block, two 2^L-float buffers":
            call(lib.design_logpot, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("logpot_designs: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    lib = _library()
    models = {
        "K27": MRF.create(smoke.complete_cliques(smoke.INFER_N),
                          theta=smoke.k27_theta(), device=dev),
        "grid 4x6 n=24": smoke.grid_model(4, 6, 1, dev),
    }
    result = {}
    for what, m in models.items():
        coef = K.moebius_coefficients(m)[None]
        designs = _designs(lib, torch, K, m.cliques, m.n, coef, m.beta)
        want = K.logpot_table(m.cliques, m.n, coef, m.beta).clone()
        for name, fn in designs.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{what}, {name}: not the library "
                                     "kernel's table bit for bit")
        rounds = []
        for order in (list(designs), list(designs)[::-1]):
            rounds.append({name: smoke.cuda_ms(designs[name], args.reps)
                           for name in order})
        result[what] = {name: dict(ms=sum(r[name] for r in rounds) / 2,
                                   rounds=[r[name] for r in rounds])
                        for name in designs}
        del want
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    print(json.dumps(dict(reps=args.reps, card=smi, designs=result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
