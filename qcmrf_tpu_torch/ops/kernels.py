"""Log-potential table and streaming logsumexp (the slice-1 part of
:mod:`qcmrf_tpu.ops.kernels`).

Both evaluate ``beta * theta^T phi(x)`` per state id from the per-clique
Moebius coefficients of :func:`moebius_coefficients`, clique by clique in
the order of ``_logpot_block``, with ``beta`` applied after the clique sum.

* :func:`logpot_table` writes the ``(B, 2**n)`` table (``logpot_kernel``);
* :func:`lse_partials` sweeps the states without a table and returns one
  (max, scaled sum) pair per block of states (``lse_kernel``);
  :func:`combine_lse` finishes the logsumexp.

On a CUDA tensor each launches its kernel of ``csrc/qcmrf_kernels.cu``; on a
CPU tensor it runs its plain PyTorch version (``*_reference``), which any
device can run. Rows of a coefficient batch are separate models of one
structure, evaluated in one launch.
"""

from __future__ import annotations

import math

import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.sim.analytic import _moebius_layout
from qcmrf_tpu_torch.utils import moebius

#: launches of the CUDA kernels, bumped where each is launched
LAUNCHES = {"logpot": 0, "lse": 0}

#: the streaming logsumexp writes at most this many partial pairs a row
MAX_LSE_PARTS = 4096
#: and gives each block at least this many states
MIN_LSE_BLOCK_STATES = 1024


def coefficient_table(cliques: tuple, n: int,
                      thetas: torch.Tensor) -> torch.Tensor:
    """Multilinear coefficients of every clique table for a stack of thetas
    ``(..., d)``; returns ``(..., K << cmax)`` float32. Entry layout per
    clique: subset ``s`` with bit ``i`` <-> clique slot ``i``; cliques
    smaller than cmax alias the extra slots, whose coefficients vanish."""
    idx_map, _, cmax = _moebius_layout(cliques, n)
    idx = torch.from_numpy(idx_map).to(thetas.device)
    tab = thetas[..., idx].to(torch.float32)
    return moebius.transform(tab, cmax).reshape(*thetas.shape[:-1], -1)


def moebius_coefficients(mrf: MRF) -> torch.Tensor:
    """Multilinear coefficients of ``mrf``'s clique tables, (K * 2^cmax,)."""
    return coefficient_table(mrf.cliques, mrf.n, mrf.theta)


def _clique_sum(cliques: tuple, n: int, coef: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """``theta^T phi(x)`` per row of ``coef`` at ids ``x``: (B, len(x))."""
    cmax = max(len(C) for C in cliques)
    acc = torch.zeros((coef.shape[0], x.shape[0]), dtype=torch.float32,
                      device=coef.device)
    for k, C in enumerate(cliques):
        off = k << cmax
        bits = [((x >> (n - 1 - v)) & 1).to(torch.float32) for v in C]
        acc = moebius.eval_multilinear(
            bits, len(C), lambda s: coef[:, off + s, None], acc)
    return acc


def logpot_table_reference(cliques: tuple, n: int, coef: torch.Tensor,
                           beta: float, fuse_amp: bool = False):
    """Plain PyTorch version of :func:`logpot_table`, on any device."""
    x = torch.arange(1 << n, dtype=torch.int64, device=coef.device)
    acc = _clique_sum(cliques, n, coef, x) * beta
    if fuse_amp:
        return torch.exp(0.5 * acc) * (2.0 ** (-0.5 * n))
    return acc


def logpot_table(cliques: tuple, n: int, coef: torch.Tensor, beta: float,
                 fuse_amp: bool = False) -> torch.Tensor:
    """``beta * theta^T phi(x)`` for all ``2**n`` states and every row of
    ``coef`` ((B, K << cmax)); float32 (B, 2**n). ``fuse_amp`` returns the
    post-selected amplitudes ``2^(-n/2) * exp(lp / 2)`` instead."""
    if coef.device.type == "cpu":
        return logpot_table_reference(cliques, n, coef, beta, fuse_amp)
    dev = coef.device
    shifts, sizes, B, K, cmax = _build.structure_args(cliques, n, coef)
    out = torch.empty((B, 1 << n), dtype=torch.float32, device=dev)
    _build.launch("qcmrf_logpot", dev, _build.ptr(coef), _build.ptr(shifts),
                  _build.ptr(sizes), B, K, cmax, 1 << n, beta, int(fuse_amp),
                  2.0 ** (-0.5 * n), _build.ptr(out))
    LAUNCHES["logpot"] += 1
    return out


def lse_geometry(num_states: int):
    """(parts, states per part) of the streaming logsumexp: every part
    holds at least one state."""
    parts = min(MAX_LSE_PARTS, -(-num_states // MIN_LSE_BLOCK_STATES))
    per_part = -(-num_states // parts)
    return -(-num_states // per_part), per_part


def lse_partials_reference(cliques: tuple, n: int, coef: torch.Tensor,
                           beta: float):
    """Plain PyTorch version of :func:`lse_partials`, on any device."""
    N = 1 << n
    parts, per_part = lse_geometry(N)
    lp = logpot_table_reference(cliques, n, coef, beta)
    pad = parts * per_part - N
    lp = torch.nn.functional.pad(lp, (0, pad), value=-math.inf)
    lp = lp.reshape(coef.shape[0], parts, per_part)
    m = lp.amax(dim=-1)
    return m, torch.exp(lp - m[..., None]).sum(dim=-1)


def lse_partials(cliques: tuple, n: int, coef: torch.Tensor, beta: float):
    """Per-block (max, scaled sum) of ``beta * theta^T phi(x)`` over all
    ``2**n`` states, for every row of ``coef``: two float32 (B, parts)
    tensors (``lse_geometry`` gives ``parts``). No table is written."""
    if coef.device.type == "cpu":
        return lse_partials_reference(cliques, n, coef, beta)
    dev = coef.device
    shifts, sizes, B, K, cmax = _build.structure_args(cliques, n, coef)
    parts, per_part = lse_geometry(1 << n)
    m = torch.empty((B, parts), dtype=torch.float32, device=dev)
    s = torch.empty((B, parts), dtype=torch.float32, device=dev)
    _build.launch("qcmrf_lse", dev, _build.ptr(coef), _build.ptr(shifts),
                  _build.ptr(sizes), B, K, cmax, 1 << n, per_part, parts,
                  beta, _build.ptr(m), _build.ptr(s))
    LAUNCHES["lse"] += 1
    return m, s


def combine_lse(m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """logsumexp along the last axis from (max, scaled sum) partials."""
    M = m.amax(dim=-1, keepdim=True)
    return (M + torch.log((s * torch.exp(m - M)).sum(dim=-1,
                                                      keepdim=True)))[..., 0]


def all_log_potentials(mrf: MRF) -> torch.Tensor:
    """``beta * theta^T phi(x)`` for all ``2**n`` states."""
    coef = moebius_coefficients(mrf)[None]
    return logpot_table(mrf.cliques, mrf.n, coef, mrf.beta)[0]


def postselected_amplitudes(mrf: MRF) -> torch.Tensor:
    """Amplitudes ``2^(-n/2) * exp(beta * theta^T phi(x) / 2)`` of the
    all-ancilla-zero branch, from the table kernel's epilogue."""
    coef = moebius_coefficients(mrf)[None]
    return logpot_table(mrf.cliques, mrf.n, coef, mrf.beta, True)[0]


def gibbs_probs(mrf: MRF) -> torch.Tensor:
    """Exact Gibbs probabilities from the log-potential table."""
    return torch.softmax(all_log_potentials(mrf), dim=-1)


def log_partition(mrf: MRF) -> torch.Tensor:
    """``ln Z`` by the streaming logsumexp (no table)."""
    coef = moebius_coefficients(mrf)[None]
    return combine_lse(*lse_partials(mrf.cliques, mrf.n, coef, mrf.beta))[0]
