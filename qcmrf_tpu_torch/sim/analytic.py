"""Closed-form QCMRF outcome distribution (port of
:mod:`qcmrf_tpu.sim.analytic`).

The circuit's measurement statistics factorize exactly:

    P(x, a_1..a_K) = 2^{-n} * prod_k [ c2_k(x) if a_k = 0 else 1 - c2_k(x) ]

with ``c2_k(x) = exp(beta * theta_{k, y_k(x)})``. So sampling is "draw x
uniformly, then flip K independent Bernoulli ancillas", and post-selection
on all-zero ancillas yields the Gibbs distribution with success rate
``delta = Z / 2**n``.

The sampling entry points route to :mod:`qcmrf_tpu_torch.ops.sampler_kernel`
(the fused CUDA sampler on a CUDA model, its plain version on the CPU);
:func:`postselected_probs` uses the log-potential and streaming-logsumexp
kernels of :mod:`qcmrf_tpu_torch.ops.kernels`. Where the JAX package takes
a ``PRNGKey``, these take an integer ``seed`` and a ``stream``: the two
words of the Philox key.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.utils import moebius, profiling


def check_theta_domain(mrf: MRF) -> None:
    """Guard for the sampling entry points: theta > 0 makes ``c2 =
    exp(beta*theta) > 1``, so the Bernoulli ``u >= c2`` silently never fires
    and ``1 - c2`` goes negative in the joint law."""
    check_thetas(mrf.theta)


def check_thetas(thetas: torch.Tensor) -> None:
    """:func:`check_theta_domain` for a tensor of thetas of any shape."""
    positive = (thetas > 0).any()
    with profiling.span("qcmrf.wait"):
        positive = bool(positive)
    if positive:
        raise ValueError(
            "theta must be <= 0 (QCMRF.py:139 domain): positive entries "
            "give clique keep-probabilities > 1 and a silently wrong "
            "outcome law"
        )


def clique_keep_probs(mrf: MRF, x) -> torch.Tensor:
    """``c2_k(x) = exp(beta * theta_k(y_k(x)))`` for each clique k, by
    gather; shape ``x.shape + (K,)``."""
    flat_idx = mrf.suff_stat_flat_indices(x)
    return torch.exp(mrf.beta * mrf.theta[flat_idx])


@functools.lru_cache(maxsize=256)
def _moebius_layout(cliques: tuple, n: int):
    """Static tables for the gather-free keep-prob evaluation.

    Returns (idx_map (K, 2^cmax) int64, shifts (cmax, K) int32, cmax):
    ``idx_map[k, s]`` maps slot-encoded subset ``s`` (bit i <-> clique slot
    i; out-of-range slots aliased down so their Moebius coefficients vanish)
    to the flat theta index; ``shifts[i, k]`` is the state-id right-shift of
    clique k's slot-i variable.
    """
    K = len(cliques)
    cmax = max(len(C) for C in cliques)
    offsets, o = [], 0
    for C in cliques:
        offsets.append(o)
        o += 1 << len(C)
    idx_map = np.zeros((K, 1 << cmax), dtype=np.int64)
    shifts = np.zeros((cmax, K), dtype=np.int32)
    for k, C in enumerate(cliques):
        m = len(C)
        for i, v in enumerate(C):
            shifts[i, k] = n - 1 - v
        for s in range(1 << cmax):
            sm = s & ((1 << m) - 1)
            yidx = 0
            for i in range(m):
                if (sm >> i) & 1:
                    yidx |= 1 << (m - 1 - i)
            idx_map[k, s] = offsets[k] + yidx
    return idx_map, shifts, cmax


def _broadcast_multilinear(mrf: MRF, x, tab) -> torch.Tensor:
    """Evaluate per-clique multilinear coefficient tables ``tab``
    ((K, 2^cmax), slot-encoded) at state ids ``x``; returns (..., K)."""
    _, shifts, cmax = _moebius_layout(mrf.cliques, mrf.n)
    x = torch.as_tensor(x, dtype=torch.int64, device=tab.device)
    sh = torch.from_numpy(shifts.astype(np.int64)).to(tab.device)
    bits = [((x[..., None] >> sh[i]) & 1).to(tab.dtype) for i in range(cmax)]
    zero = torch.zeros(x.shape + (tab.shape[0],), dtype=tab.dtype,
                       device=tab.device)
    return moebius.eval_multilinear(bits, cmax, lambda s: tab[:, s], zero)


def clique_keep_probs_fast(mrf: MRF, x) -> torch.Tensor:
    """Gather-free ``c2_k(x)``: the per-clique exp-theta table converted to
    Moebius coefficients, evaluated per state as a chain over bit
    monomials. Exact."""
    idx_map, _, cmax = _moebius_layout(mrf.cliques, mrf.n)
    idx = torch.from_numpy(idx_map).to(mrf.device)
    tab = moebius.transform(torch.exp(mrf.beta * mrf.theta[idx]), cmax)
    return _broadcast_multilinear(mrf, x, tab)


def log_potentials_fast(mrf: MRF, x) -> torch.Tensor:
    """Gather-free ``beta * theta^T phi(x)`` by per-clique Moebius
    coefficients summed over cliques. Exact."""
    idx_map, _, cmax = _moebius_layout(mrf.cliques, mrf.n)
    idx = torch.from_numpy(idx_map).to(mrf.device)
    tab = moebius.transform(mrf.beta * mrf.theta[idx], cmax)
    return _broadcast_multilinear(mrf, x, tab).sum(-1)


def postselected_probs(mrf: MRF) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact post-selected distribution and success rate.

    Returns ``(p, delta)`` where ``p[x]`` is the Gibbs distribution over the
    ``2**n`` variable states and ``delta = Z / 2**n``; the table comes from
    the log-potential kernel and ``ln Z`` from the streaming logsumexp.
    """
    from qcmrf_tpu_torch.ops import kernels

    check_theta_domain(mrf)
    logpot = kernels.all_log_potentials(mrf)
    lse = kernels.log_partition(mrf)
    p = torch.exp(logpot - lse)
    delta = torch.exp(lse - mrf.n * math.log(2.0))
    return p, delta


def joint_outcome_probs(mrf: MRF) -> torch.Tensor:
    """Full joint distribution over counts keys, shape ``2**(n+K+1)``.

    Key layout: bits ``0..n-1`` = variable state id, bit ``n`` = workspace
    (always 0), bits ``n+1+k`` = ancilla of clique ``k``. Only sensible for
    small models; large models use :func:`sample_outcome_parts`.
    """
    check_theta_domain(mrf)
    n, K = mrf.n, mrf.num_cliques
    if max(K * (1 << (n + K)), 1 << (n + K + 1)) > (1 << 28):
        raise ValueError(
            f"joint distribution would need ~max({K} * 2**{n + K}, "
            f"2**{n + K + 1}) floats; use sample_outcome_parts / "
            "sample_postselected for large models (they never materialize "
            "the joint)"
        )
    dev = mrf.device
    x = torch.arange(mrf.num_states, dtype=torch.int64, device=dev)
    c2 = clique_keep_probs(mrf, x)  # (2**n, K)
    s2 = 1.0 - c2
    a = torch.arange(1 << K, dtype=torch.int64, device=dev)
    abits = (a[:, None] >> torch.arange(K, device=dev)) & 1  # (2**K, K)
    logs = torch.log(torch.where(abits[:, None, :] == 1, s2[None], c2[None]))
    P = torch.exp(logs.sum(-1)) * (2.0 ** -n)  # (2**K, 2**n)
    keys = (a[:, None] << (n + 1)) + x[None, :]
    out = torch.zeros((1 << (n + K + 1),), dtype=c2.dtype, device=dev)
    return out.index_add_(0, keys.reshape(-1), P.reshape(-1))


def sample_outcome_parts(seed: int, mrf: MRF, shots: int, stream: int = 0):
    """Sample full measurement outcomes without materializing any 2^Q
    vector: ``x`` uniform, ancilla ``k`` ~ Bernoulli(1 - c2_k(x)). Returns
    ``(x, a)``: the variable state ids (int32) and the ancilla bitmask as
    int32 bits (bit k = clique k's ancilla; K <= 32; read it as unsigned
    with ``.numpy().view(np.uint32)``)."""
    from qcmrf_tpu_torch.ops import sampler_kernel

    return sampler_kernel.sample_outcome_parts(seed, mrf, shots, stream)


def sample_outcomes(seed: int, mrf: MRF, shots: int,
                    stream: int = 0) -> torch.Tensor:
    """Sampled measurement keys packed as int32 (layout of
    :func:`joint_outcome_probs`). Requires n + K + 1 <= 31."""
    n, K = mrf.n, mrf.num_cliques
    if n + K + 1 > 31:
        raise ValueError(
            "packed keys need n + K + 1 <= 31 bits; "
            "use sample_outcome_parts for wider circuits"
        )
    x, a = sample_outcome_parts(seed, mrf, shots, stream)
    return x + (a << (n + 1))


def sample_postselected(seed: int, mrf: MRF, shots: int, stream: int = 0):
    """``(x, accepted)``: uniform variable draws and whether each shot's
    ancillas all read 0. No clique-count limit."""
    from qcmrf_tpu_torch.ops import sampler_kernel

    return sampler_kernel.sample_postselected(seed, mrf, shots, stream)
