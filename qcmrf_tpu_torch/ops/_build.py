"""Build and bind the CUDA kernels of ``csrc/*.cu``.

At first use on a CUDA tensor, :func:`library` compiles every source under
``csrc/`` with its own ``nvcc`` process, all started together, and links
the objects into ``build/qcmrf_tpu_torch/<hash>/libqcmrf_kernels.so`` at
the repository root, keyed on a hash of the sources and the flags; it
loads the library with ``ctypes``. The C entry points take every pointer
and the stream as ``c_void_p`` and return ``cudaGetLastError()``;
:func:`launch` raises when that is not 0. Nothing here runs at import
time.

The helpers below also check the tensors handed to a kernel and build the
small per-structure tensors (clique shifts and sizes) the kernels read.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Tuple

import torch

from qcmrf_tpu_torch.sim.analytic import _moebius_layout
from qcmrf_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "qcmrf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: shared memory (static and dynamic) one block may hold on sm_90; the
#: entry points opt in past the default 48 KB
SHARED_BYTES_LIMIT = 227 * 1024

_P, _I, _I64, _U32, _U64, _F, _D = (ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_uint32,
                                    ctypes.c_uint64, ctypes.c_float,
                                    ctypes.c_double)


class GateMatrix(ctypes.Structure):
    """A row gate's matrix as ``gate_kernels.cu`` takes it by value:
    row-major (out, in), 2x2 in the first 4 entries or 4x4."""

    _fields_ = [("re", ctypes.c_float * 16), ("im", ctypes.c_float * 16)]


class LaneFactors(ctypes.Structure):
    """A lane op's seven 2x2 factors as ``gate_kernels.cu`` takes them by
    value: factor q's entry (o, i) at ``4 q + 2 o + i``."""

    _fields_ = [("re", ctypes.c_float * 28), ("im", ctypes.c_float * 28)]


class SplitTables(ctypes.Structure):
    """A split plan as ``qcmrf_kernels.cu`` takes it by value
    (``SplitPlan``): device pointers to the plan's tables and its counts
    (``kernels.SplitPlan``)."""

    _fields_ = [("hm", ctypes.c_void_p), ("coef_index", ctypes.c_void_p),
                ("c_items", ctypes.c_void_p), ("c_heads", ctypes.c_void_p),
                ("m_items", ctypes.c_void_p), ("m_heads", ctypes.c_void_p),
                ("targets", ctypes.c_void_p), ("L", ctypes.c_int),
                ("U", ctypes.c_int), ("CI", ctypes.c_int),
                ("MI", ctypes.c_int), ("G", ctypes.c_int)]


_SIGNATURES = {
    # keep, slot shifts, B, K, cmax, n, shots, seed, stream0, mode, x_out,
    # a_out, count_out, stream
    "qcmrf_sample": (_P, _P, _I, _I, _I, _I, _I64, _U32, _U32, _I, _P, _P,
                     _P, _P),
    # plan, coef, B, ncoef, per_block, x0_blocks, parts, beta, fuse_amp,
    # amp_scale, out, stream
    "qcmrf_logpot": (SplitTables, _P, _I, _I, _I64, _I64, _I, _F, _I, _F,
                     _P, _P),
    # plan, coef, B, ncoef, per_block, x0_blocks, parts, beta, m_out, s_out,
    # stream
    "qcmrf_lse": (SplitTables, _P, _I, _I, _I64, _I64, _I, _F, _P, _P, _P),
    # plan, coef, shifts, sizes, B, K, cmax, per_block, x0_blocks, parts,
    # beta, tol, v_out, x_out, cand_out, stream
    "qcmrf_map": (SplitTables, _P, _P, _P, _I, _I, _I, _I64, _I64, _I, _F,
                  _P, _P, _P, _P, _P),
    # plan, coef, B, ncoef, per_block, x0_blocks, parts, beta, lnz, masks,
    # m, s_out, stream
    "qcmrf_moments": (SplitTables, _P, _I, _I, _I64, _I64, _I, _F, _P, _P,
                      _I, _P, _P),
    # plan, coef, B, ncoef, per_block, x0_blocks, parts, beta, masks, m,
    # m_out, s_out, stream
    "qcmrf_lnz_moments": (SplitTables, _P, _I, _I, _I64, _I64, _I, _F, _P,
                          _I, _P, _P, _P),
    # table, n_terms, k, re, im, num_anchors, a_lo, stream
    "qcmrf_hdh_multi": (_P, _I, _I, _P, _P, _I64, _I, _P),
    # table, n_terms, k, re (probabilities out), im, num_anchors, a_lo,
    # stream
    "qcmrf_hdh_multi_probs": (_P, _I, _I, _P, _P, _I64, _I, _P),
    # table, n_terms, k, re, im, num_anchors, a_lo, comp, amp, stream
    "qcmrf_hdh_multi_uniform": (_P, _I, _I, _P, _P, _I64, _I, _U64, _F, _P),
    # table, n_terms, k, out (probabilities), num_anchors, a_lo, comp, amp,
    # stream
    "qcmrf_hdh_multi_uniform_probs": (_P, _I, _I, _P, _I64, _I, _U64, _F,
                                      _P),
    # circuit descriptors, structure tables, thetas, circuits, beta,
    # shared bytes, scratch, out, stream
    "qcmrf_circuit": (_P, _P, _P, _I, _D, _I, _P, _P, _P),
    # table, n_terms, re, im, num_groups, stream
    "qcmrf_diag": (_P, _I, _P, _P, _I64, _P),
    # matrix, k, re, im, num_quads, q_lo, stream
    "qcmrf_row_gate": (GateMatrix, _I, _P, _P, _I64, _I, _P),
    # M planes (row-major), re, im, rows, stream
    "qcmrf_lane": (_P, _P, _P, _I64, _P),
    # factors, mask of the non-identity factors, re, im, rows, stream
    "qcmrf_lane_factored": (LaneFactors, _I, _P, _P, _I64, _P),
    # src_re, src_im, dst_re, dst_im, num_groups, stream
    "qcmrf_copy": (_P, _P, _P, _P, _I64, _P),
    # x, b, steps, num_quads, block_max, out (or null), stream
    "qcmrf_fma_peak": (_P, _F, _I, _I64, _P, _P, _P),
    # chains, C, structures, records, lane table, meta, others, evidence,
    # thetas, D tables (or null), out, beta, seed, sweeps, burn, thin,
    # num_samples, register state, shared bytes, stream
    "qcmrf_gibbs": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _U32, _I,
                    _I, _I, _I, _I, _I, _P),
    # chains, C, structures, records, lane table, meta, others, thetas, D
    # tables (or null), out, schedule, cliques, variables, cliques' count,
    # packed cliques, rungs, sweeps a rung, log-weights, seed, register
    # state, shared bytes, stream
    "qcmrf_gibbs_ais": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P, _U32, _I, _I, _P),
    # register state, D in shared memory, shared bytes, out (one int32),
    # stream (unused)
    "qcmrf_gibbs_ais_occupancy": (_I, _I, _I, _P, _P),
    # count, out (count float32), stream
    "qcmrf_gibbs_thresholds": (_I, _P, _P),
    # chase, steps, beta, out (10 int64), sink (32 int32), stream
    "qcmrf_gibbs_latency": (_P, _I, _F, _P, _P, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources() -> Tuple[Path, ...]:
    """Every CUDA source of the library, in name order."""
    return tuple(sorted(CSRC.glob("*.cu")))


def library_path() -> Path:
    """Where the built library lives for the current sources and flags."""
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libqcmrf_kernels.so"


def build() -> Tuple[Path, float]:
    """Compile the kernels unless these sources are built already; returns
    the library's path and the seconds the build took (0.0 when cached).
    One ``nvcc`` per source runs at once, then one links them. The
    compilers' register and shared-memory reports land in ``nvcc.log``
    beside the library."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = out.parent / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [(src.name, p.communicate()[0], p.returncode)
            for src, p in zip(sources(), procs)]
    tmp = out.with_name(f"{out.name}.{tag}")
    link = None
    if all(code == 0 for _, _, code in logs):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
    seconds = time.perf_counter() - t0
    text = "".join(f"== {name} (exit {code})\n{log}"
                   for name, log, code in logs)
    if link is not None:
        text += f"== link (exit {link.returncode})\n{link.stdout}{link.stderr}"
    (out.parent / "nvcc.log").write_text(text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, out)
    return out, seconds


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.qcmrf_error_string.argtypes = [ctypes.c_int]
    lib.qcmrf_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise if
    the launch reports a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.qcmrf_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` has the device, dtype, shape and contiguity a
    kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def refuse_grad(t: torch.Tensor, name: str) -> None:
    """Raise where autograd would lose a gradient without a word: the
    kernels have no backward, so under grad mode a tensor that requires
    grad is refused, on every device (the CPU plain versions too, so that
    a CPU run shows what the card does)."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise ValueError(
            f"{name} requires grad and this kernel has no backward: "
            "differentiate lnZ through models.moments."
            "log_partition_streaming or MRF.log_partition, or pass a "
            "detached tensor")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def structure_bytes(K: int, cmax: int) -> int:
    """Shared memory of the structure tables a block loads: one row of
    coefficients, the shifts and the sizes."""
    return ((K << cmax) + K * (cmax + 1)) * 4


def structure_args(cliques: tuple, n: int, coef: torch.Tensor,
                   extra: int = 0):
    """Checked kernel arguments of a structure and its ``(B, K << cmax)``
    coefficient rows: ``(shifts, sizes, B, K, cmax)``. Raises when the
    tables and ``extra`` bytes (the kernel's own shared memory) would not
    fit a block's shared memory."""
    K = len(cliques)
    cmax = max(len(C) for C in cliques)
    B = check_rows(coef, K, cmax, structure_bytes(K, cmax) + extra,
                   "structure tables and kernel")
    shifts, sizes = _device_layout(cliques, n, coef.device)
    return shifts, sizes, B, K, cmax


def check_rows(coef: torch.Tensor, K: int, cmax: int, need: int,
               what: str) -> int:
    """The number B of ``(B, K << cmax)`` float32 coefficient rows, checked;
    raises when ``need`` bytes of shared memory (``what`` needs them) do not
    fit a block."""
    B = coef.shape[0]
    check(coef, "coef", torch.float32, (B, K << cmax), coef.device)
    if need > SHARED_BYTES_LIMIT:
        raise ValueError(f"{what} need {need} bytes of shared memory; a "
                         f"block holds at most {SHARED_BYTES_LIMIT}")
    if not 1 <= B <= 65535:
        raise ValueError(f"{B} coefficient rows; the kernels take 1..65535")
    return B


@functools.lru_cache(maxsize=256)
def _device_layout(cliques: tuple, n: int, device: torch.device):
    """(shifts (K, cmax) int32, sizes (K,) int32) on ``device``."""
    _, shifts, _ = _moebius_layout(cliques, n)
    sizes = [len(C) for C in cliques]
    with profiling.span("qcmrf.wait"):
        return (torch.from_numpy(shifts.T.copy()).to(device),
                torch.tensor(sizes, dtype=torch.int32, device=device))
