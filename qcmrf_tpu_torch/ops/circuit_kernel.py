"""Whole-circuit kernel: one launch per call, any number of clique
structures (port of :mod:`qcmrf_tpu.ops.circuit_kernel`).

:func:`batched_circuits_probs` runs the entire gate-level QCMRF circuit of
every parameter row of every structure it is given: the Hadamard wall,
each clique's real-part-extraction sandwich, then ``|psi|^2``. On a CUDA
device that is one launch of ``circuit_kernel``
(``csrc/circuit_kernels.cu``), one block per circuit, whatever the mix of
structures (the default: the current CUDA device unless the caller names
another); on the CPU it is the plain version,
:func:`batched_circuit_probs_reference` per structure, which compiles each
circuit and runs it through the dense engine. :func:`batched_circuit_probs`
is JAX's one-structure signature, a call of it.

The host packs one buffer per call (:func:`pack_circuits`): a descriptor
per circuit, a table per structure and every theta row in float64; it
reaches the card in one copy. The kernel makes the rotation pairs from
theta itself, ``(cos 2 gamma, sin 2 gamma) = (exp(beta theta / 2),
sqrt(-expm1(beta theta)))`` (:func:`rotation_pairs` is that formula on
the host).

The layout is the dense engine's (qubit 0 = LSB; the workspace qubit ``n``
is kept in the width and never touched), so a row is the counts-key
distribution of its circuit directly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
from qcmrf_tpu_torch.circuits.params import validate_theta_domain
from qcmrf_tpu_torch.models.mrf import MRF, _normalize_cliques
from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.sim import dense
from qcmrf_tpu_torch.utils import profiling
from qcmrf_tpu_torch.utils.config import resolve_device

#: launches of the CUDA kernels (the port's one launch counter)
LAUNCHES = profiling.LAUNCHES

#: widest circuit the kernel takes: a block holds its whole state
_MAX_WIDTH = 16
#: up to this width the state lives in shared memory (2^14 x 8 bytes =
#: 128 KB); wider ones use a global scratch
_SHARED_MAX_WIDTH = 14


def _shape(cliques):
    cliques = _normalize_cliques(cliques)
    n = max(v for C in cliques for v in C) + 1
    width = n + len(cliques) + 1
    if width > _MAX_WIDTH:
        raise ValueError(
            f"circuit width {width} exceeds the whole-state kernel's "
            f"limit (max {_MAX_WIDTH}); use sim.planes for wider circuits"
        )
    return cliques, n, width


def _thetas64(thetas) -> np.ndarray:
    if isinstance(thetas, torch.Tensor):
        thetas = thetas.detach().cpu().numpy()
    t = np.asarray(thetas, np.float64)
    return t[None] if t.ndim == 1 else t


def batched_circuit_probs_reference(cliques, thetas, beta: float = 1.0,
                                    device=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_circuit_probs`: each row's
    circuit from :func:`compile_qcmrf`, run by the dense engine on
    ``device`` (the current CUDA device unless one is named)."""
    cliques, _, _ = _shape(cliques)
    device = resolve_device(device)
    rows = []
    for theta in _thetas64(thetas):
        mrf = MRF.create(cliques, theta=theta, beta=beta, device=device)
        state = dense.run_statevector(
            compile_qcmrf(mrf, with_measurements=False), device=device)
        rows.append((state.abs() ** 2).to(torch.float32))
    return torch.stack(rows)


def rotation_pairs(thetas, beta: float = 1.0):
    """``(cos 2 gamma, sin 2 gamma)`` of ``gamma = theta_to_gamma(theta,
    beta)`` in float64, in closed form: ``2 gamma`` lies in ``[0, pi/2]``,
    so the pair is ``(exp(beta theta / 2), sqrt(-expm1(beta theta)))``, the
    kernel's arithmetic (which rounds each to float32 once)."""
    t = beta * np.asarray(thetas, np.float64)
    return np.exp(0.5 * t), np.sqrt(-np.expm1(t))


@functools.lru_cache(maxsize=64)
def structure_table(cliques: tuple, n: int) -> np.ndarray:
    """A structure's table as the kernel reads it, int32 words: n, K,
    cmax, width, d (thetas a row), the float32 bits of ``2^(-n/2)``, the
    K clique sizes, then the ``(K, cmax)`` qubits (``(n - 1) - v`` for
    clique slot v, 0 past the clique's size)."""
    K = len(cliques)
    cmax = max(len(C) for C in cliques)
    qubits = np.zeros((K, cmax), np.int32)
    for k, C in enumerate(cliques):
        qubits[k, :len(C)] = [(n - 1) - v for v in C]
    amp = np.float32(2.0 ** (-0.5 * n)).view(np.int32)
    head = [n, K, cmax, n + K + 1, sum(1 << len(C) for C in cliques), amp]
    return np.concatenate([np.asarray(head, np.int32),
                           np.array([len(C) for C in cliques], np.int32),
                           qubits.ravel()])


#: a circuit's descriptor as the kernel reads it (``CircuitDesc``): its
#: first theta (float64 element), its first output float, its state's
#: first scratch float (-1: the state in shared memory) and its
#: structure's first table word
CIRCUIT_DTYPE = np.dtype([("theta", "<i8"), ("out", "<i8"),
                          ("scratch", "<i8"), ("structure", "<i4"),
                          ("pad", "<i4")])


class CircuitPack(NamedTuple):
    """One call's host buffer and its layout (:func:`pack_circuits`)."""

    blob: np.ndarray           # uint8: circuits | structure tables | thetas
    circuits: np.ndarray       # CIRCUIT_DTYPE, one a circuit
    structures_at: int         # byte offset of the tables in blob
    thetas_at: int             # byte offset of the thetas in blob
    shapes: tuple              # (B_j, 2^w_j) a problem
    out_offsets: tuple         # first output float of each problem
    out_floats: int
    scratch_floats: int
    shared_bytes: int          # dynamic shared memory of the launch


def _pad8(nbytes: int) -> int:
    return (nbytes + 7) & ~7


def pack_circuits(problems) -> CircuitPack:
    """The host side of one launch: ``problems`` is a sequence of
    ``(cliques, n, width, thetas)`` (normalised cliques, float64 theta
    rows ``(B, d)``). Circuits are numbered problem by problem, row by
    row; outputs follow in the same order, each ``2^width`` floats; a
    circuit wider than 14 qubits keeps its state (``2 x 2^width``
    floats) in a global scratch, the others in shared memory beside
    their rotation pairs (8 bytes a theta)."""
    tables, table_at = [], {}
    words = 0
    runs, thetas = [], []
    shapes, out_offsets = [], []
    out = scratch = theta = 0
    shared = 0
    for cliques, n, width, t64 in problems:
        key = (cliques, n)
        if key not in table_at:
            table_at[key] = words
            tables.append(structure_table(cliques, n))
            words += tables[-1].size
        B, d = t64.shape
        N = 1 << width
        shapes.append((B, N))
        out_offsets.append(out)
        in_shared = width <= _SHARED_MAX_WIDTH
        shared = max(shared, (8 * N if in_shared else 0) + 8 * d)
        # a descriptor's last word is its structure's (little-endian, pad 0)
        run = np.empty((B, 4), np.int64)
        run[:, 0] = np.arange(theta, theta + B * d, d)
        run[:, 1] = np.arange(out, out + B * N, N)
        run[:, 2] = (-1 if in_shared else
                     np.arange(scratch, scratch + 2 * N * B, 2 * N))
        run[:, 3] = table_at[key]
        runs.append(run)
        theta += B * d
        out += B * N
        scratch += 0 if in_shared else 2 * N * B
        thetas.append(t64.reshape(-1))
    circuits = np.concatenate(runs).astype("<i8").view(CIRCUIT_DTYPE)[:, 0]
    tables_bytes = np.concatenate(tables).astype("<i4").tobytes()
    structures_at = circuits.nbytes
    thetas_at = structures_at + _pad8(len(tables_bytes))
    blob = np.zeros(thetas_at + 8 * theta, np.uint8)
    blob[:structures_at] = circuits.view(np.uint8)
    blob[structures_at:structures_at + len(tables_bytes)] = np.frombuffer(
        tables_bytes, np.uint8)
    blob[thetas_at:] = np.concatenate(thetas).astype("<f8").view(np.uint8)
    return CircuitPack(blob, circuits, structures_at, thetas_at,
                       tuple(shapes), tuple(out_offsets), out, scratch,
                       shared)


def _problem(cliques, thetas):
    """(normalised cliques, n, width, float64 thetas (B, d)), checked."""
    cliques, n, width = _shape(cliques)
    t64 = _thetas64(thetas)
    d = sum(1 << len(C) for C in cliques)
    if t64.shape[1] != d:
        raise ValueError(f"thetas have {t64.shape[1]} columns; the "
                         f"structure has {d}")
    return cliques, n, width, t64


def batched_circuits_probs(problems, beta: float = 1.0,
                           device=None) -> list:
    """Gate-level outcome distributions of ``problems``, a sequence of
    ``(cliques, thetas)`` with thetas ``(B_j, d_j)``: one float32 ``(B_j,
    2**(n_j+K_j+1))`` tensor per problem, the statistics of
    ``dense.simulate_probs(compile_qcmrf(...))`` per row. On a CUDA
    ``device`` (the current one unless the caller names a device) every
    circuit of every problem runs in one launch, and the results are views
    of one output buffer; ``device="cpu"`` runs the plain version."""
    problems = [_problem(C, t) for C, t in problems]
    if not problems:
        return []
    validate_theta_domain(np.concatenate([p[3].reshape(-1)
                                          for p in problems]))
    device = resolve_device(device)
    if device.type == "cpu":
        return [batched_circuit_probs_reference(C, t64, beta, device)
                for C, _, _, t64 in problems]
    pack = pack_circuits(problems)
    buffers = upload(pack, device)
    launch(pack, buffers, beta, device)
    out = buffers[1]
    return [out[o:o + B * N].view(B, N)
            for o, (B, N) in zip(pack.out_offsets, pack.shapes)]


def upload(pack: CircuitPack, device: torch.device):
    """``(blob, out, scratch)`` on ``device``: the call's one
    host-to-device copy (from pinned memory, without waiting) and its
    output and scratch buffers (scratch None when no circuit needs it)."""
    if pack.shared_bytes > _build.SHARED_BYTES_LIMIT:
        raise ValueError(f"a circuit needs {pack.shared_bytes} bytes of "
                         "shared memory; a block holds at most "
                         f"{_build.SHARED_BYTES_LIMIT}")
    blob = torch.from_numpy(pack.blob).pin_memory().to(device,
                                                       non_blocking=True)
    out = torch.empty(pack.out_floats, dtype=torch.float32, device=device)
    scratch = (torch.empty(pack.scratch_floats, dtype=torch.float32,
                           device=device) if pack.scratch_floats else None)
    return blob, out, scratch


def launch(pack: CircuitPack, buffers, beta: float,
           device: torch.device) -> None:
    """One launch of ``circuit_kernel`` over every circuit of ``pack``, on
    buffers from :func:`upload`."""
    blob, out, scratch = buffers
    base = blob.data_ptr()
    _build.launch("qcmrf_circuit", device, ctypes.c_void_p(base),
                  ctypes.c_void_p(base + pack.structures_at),
                  ctypes.c_void_p(base + pack.thetas_at),
                  len(pack.circuits), float(beta), pack.shared_bytes,
                  None if scratch is None else _build.ptr(scratch),
                  _build.ptr(out))
    profiling.launch("circuit")


def batched_circuit_probs(cliques, thetas, beta: float = 1.0,
                          device=None) -> torch.Tensor:
    """Gate-level outcome distributions for a stack of thetas ``(B, d)``
    of one structure (JAX's signature): float32 ``(B, 2**(n+K+1))``, one
    launch on a CUDA ``device`` (the current one unless the caller names a
    device; ``device="cpu"`` runs the plain version); a call of
    :func:`batched_circuits_probs` with one problem."""
    return batched_circuits_probs([(cliques, thetas)], beta, device)[0]
