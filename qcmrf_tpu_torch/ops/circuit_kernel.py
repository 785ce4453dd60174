"""Whole-circuit kernel: one launch per batch of QCMRF circuits (port of
:mod:`qcmrf_tpu.ops.circuit_kernel`).

:func:`batched_circuit_probs` runs the entire gate-level QCMRF circuit of
every parameter row of one clique structure: the Hadamard wall, each
clique's real-part-extraction sandwich, then ``|psi|^2``. On a CUDA device
that is one launch of ``circuit_kernel`` (``csrc/circuit_kernels.cu``),
one block per circuit (the default: the current CUDA device unless the
caller names another); on the CPU it is the plain version,
:func:`batched_circuit_probs_reference`, which compiles each circuit and
runs it through the dense engine.

The layout is the dense engine's (qubit 0 = LSB; the workspace qubit ``n``
is kept in the width and never touched), so a row is the counts-key
distribution of its circuit directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
from qcmrf_tpu_torch.circuits.params import (theta_to_gamma,
                                             validate_theta_domain)
from qcmrf_tpu_torch.models.mrf import MRF, _normalize_cliques
from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.sim import dense
from qcmrf_tpu_torch.utils.config import resolve_device

#: launches of the CUDA kernel, bumped where it is launched
LAUNCHES = {"circuit": 0}

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


@functools.lru_cache(maxsize=64)
def _device_structure(cliques: tuple, n: int, device: torch.device):
    """(qubits (K, cmax) int32: qubit of each clique slot; sizes (K,))."""
    cmax = max(len(C) for C in cliques)
    qubits = np.zeros((len(cliques), cmax), np.int32)
    for k, C in enumerate(cliques):
        qubits[k, :len(C)] = [(n - 1) - v for v in C]
    sizes = np.array([len(C) for C in cliques], np.int32)
    return (torch.from_numpy(qubits).to(device),
            torch.from_numpy(sizes).to(device))


def batched_circuit_probs(cliques, thetas, beta: float = 1.0,
                          device=None) -> torch.Tensor:
    """Gate-level outcome distributions for a stack of thetas ``(B, d)``,
    one launch on a CUDA ``device`` (the current one unless the caller
    names a device; ``device="cpu"`` runs the plain version): float32
    ``(B, 2**(n+K+1))``, the statistics of
    ``dense.simulate_probs(compile_qcmrf(...))`` per row.

    Gamma is taken from the thetas in float64 on the host, and so are the
    (cos 2 gamma, sin 2 gamma) pairs the kernel reads."""
    cliques, n, width = _shape(cliques)
    t64 = _thetas64(thetas)
    validate_theta_domain(t64)
    device = resolve_device(device)
    if device.type == "cpu":
        return batched_circuit_probs_reference(cliques, t64, beta, device)
    B, d = t64.shape
    if d != sum(1 << len(C) for C in cliques):
        raise ValueError(f"thetas have {d} columns; the structure has "
                         f"{sum(1 << len(C) for C in cliques)}")
    two_g = 2.0 * np.asarray(theta_to_gamma(t64, beta))
    trig = np.stack([np.cos(two_g), np.sin(two_g)], axis=-1)
    trig = torch.from_numpy(trig.astype(np.float32)).to(device)
    qubits, sizes = _device_structure(cliques, n, device)
    out = torch.empty((B, 1 << width), dtype=torch.float32, device=device)
    scratch = (None if width <= _SHARED_MAX_WIDTH else
               torch.empty((B, 2, 1 << width), dtype=torch.float32,
                           device=device))
    amp = float(np.float32(2.0 ** (-0.5 * n)))
    _build.launch("qcmrf_circuit", device, _build.ptr(trig),
                  _build.ptr(qubits), _build.ptr(sizes), B, n, len(cliques),
                  qubits.shape[1], d, width, amp,
                  None if scratch is None else _build.ptr(scratch),
                  _build.ptr(out))
    LAUNCHES["circuit"] += 1
    return out

