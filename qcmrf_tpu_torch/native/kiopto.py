"""ctypes wrapper of the native exact-inference engine (port of
:mod:`qcmrf_tpu.native.kiopto`).

The ``kiopto_native`` API surface the reference uses as ``px``
(``backend``, ``weights`` (a mutable view), ``infer``, ``logpot``,
``map_state``, ``sample``), backed by this package's own ``kiopto.cpp``
(the JAX package's source, byte for byte). It is host C++ by nature: bucket
elimination, a Gibbs chain and perturb-and-MAP on the CPU, asked for
explicitly (``eval --native``), never a stand-in for a device path.

At first use g++ builds the source with the JAX wrapper's flags (``-O3
-march=native -std=c++17 -shared -fPIC``) into
``build/qcmrf_tpu_torch/native/<hash>/libqcmrf_native.so`` at the
repository root, keyed on a hash of the source and the flags, and loads it
with ``ctypes``; a failed build raises. Nothing is written beside the
source::

    from qcmrf_tpu_torch.native import kiopto as px
    b = px.backend(cliques, [2] * n, inference="exact")
    px.weights(b)[:] = theta          # in place, as the reference does
    lnZ = px.infer(b, task="partition")
    lp = px.logpot(b, xid)
    S = px.sample(b)                  # Gibbs chain, thin with S[::10][1:]
    S = px.sample(b, pam=True)        # perturb-and-MAP
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "kiopto.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the built library lives for this source and these flags."""
    from qcmrf_tpu_torch.ops._build import BUILD_ROOT

    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / "native" / h.hexdigest()[:16] / "libqcmrf_native.so"


def build() -> Path:
    """Compile the engine unless this source is built already; returns the
    library's path. Written under a temporary name and renamed into place,
    so concurrent first uses do not see a half-written file."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.qk_create.restype = ctypes.c_void_p
        lib.qk_create.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.qk_destroy.argtypes = [ctypes.c_void_p]
        lib.qk_dim.restype = ctypes.c_longlong
        lib.qk_dim.argtypes = [ctypes.c_void_p]
        lib.qk_num_vars.restype = ctypes.c_int
        lib.qk_num_vars.argtypes = [ctypes.c_void_p]
        lib.qk_weights.restype = ctypes.POINTER(ctypes.c_double)
        lib.qk_weights.argtypes = [ctypes.c_void_p]
        lib.qk_logpot.restype = ctypes.c_double
        lib.qk_logpot.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
        lib.qk_partition.restype = ctypes.c_double
        lib.qk_partition.argtypes = [ctypes.c_void_p]
        lib.qk_map.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int)]
        lib.qk_sample_gibbs.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_ulonglong,
        ]
        lib.qk_sample_pam.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_ulonglong,
        ]
        _LIB = lib
        return lib


class Backend:
    """Handle to a native MRF (the reference's object from
    ``px.backend``)."""

    def __init__(self, cliques: Sequence[Sequence[int]], num_vars: int = 0):
        lib = _lib()
        if any(len(C) == 0 for C in cliques):
            raise ValueError("empty cliques are not allowed (their weight "
                             "would be dropped from elimination but kept "
                             "by logpot)")
        flat: List[int] = [int(v) for C in cliques for v in C]
        sizes = [len(C) for C in cliques]
        self._h = lib.qk_create(
            (ctypes.c_int * len(flat))(*flat),
            (ctypes.c_int * len(sizes))(*sizes),
            len(sizes), int(num_vars),
        )
        self._lib = lib
        self.cliques = [list(map(int, C)) for C in cliques]

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.qk_destroy(h)

    @property
    def n(self) -> int:
        return self._lib.qk_num_vars(self._h)

    @property
    def dim(self) -> int:
        return int(self._lib.qk_dim(self._h))


def backend(cliques, states_per_var=None,
            inference: str = "exact") -> Backend:
    """A native MRF backend (``px.backend``). Binary variables only, the
    reference's use (``[2] * n`` at every call site); ``n`` is
    ``len(states_per_var)``, so trailing variables in no clique are real
    (a factor 2 of Z each, a bit of sample width, a logpot bit)."""
    num_vars = 0
    if states_per_var is not None:
        spv = np.asarray(states_per_var).flatten()
        if any(int(s) != 2 for s in spv):
            raise ValueError("only binary variables are supported")
        num_vars = len(spv)
    if inference != "exact":
        raise ValueError("only inference='exact' is supported")
    return Backend(cliques, num_vars)


class _WeightsView(np.ndarray):
    """An ndarray that keeps its Backend alive: the view aliases the C++
    heap buffer, which a collected temporary Backend would free."""

    _qk_backend = None


def weights(b: Backend) -> np.ndarray:
    """Mutable float64 view of the weight vector (``px.weights``; the
    reference writes through it in place)."""
    ptr = b._lib.qk_weights(b._h)
    arr = np.ctypeslib.as_array(ptr, shape=(b.dim,)).view(_WeightsView)
    arr._qk_backend = b
    return arr


def infer(b: Backend, task: str = "partition") -> float:
    """ln Z by bucket elimination (``px.infer``)."""
    if task != "partition":
        raise ValueError("only task='partition' is supported")
    return float(b._lib.qk_partition(b._h))


def logpot(b: Backend, xid: int) -> float:
    """theta^T phi(x) of a state id, variable 0 the most significant bit
    (``px.logpot``); n <= 64."""
    if b.n > 64:
        raise ValueError("packed state ids are 64-bit; logpot supports "
                         "n <= 64 (partition/MAP/sampling have no limit)")
    return float(b._lib.qk_logpot(b._h, int(xid)))


def map_state(b: Backend) -> np.ndarray:
    """The MAP state's bits, int32 (n,) in variable order."""
    out = (ctypes.c_int * b.n)()
    b._lib.qk_map(b._h, out)
    return np.asarray(out, dtype=np.int32)


def sample(b: Backend, pam: bool = False, num: int = None,
           seed: int = 0) -> np.ndarray:
    """Samples as int32 (num, n) bit rows in variable order (``px.sample``).
    The Gibbs default emits 100 010 raw sweeps, which the reference thins
    ``S[::10][1:]`` to 10 000; PAM returns 10 000 directly."""
    if pam:
        num = 10_000 if num is None else num
        out = (ctypes.c_int * (num * b.n))()
        b._lib.qk_sample_pam(b._h, num, out, seed)
    else:
        num = 100_010 if num is None else num
        out = (ctypes.c_int * (num * b.n))()
        b._lib.qk_sample_gibbs(b._h, num, 10, out, seed)
    return np.asarray(out, dtype=np.int32).reshape(num, b.n)
