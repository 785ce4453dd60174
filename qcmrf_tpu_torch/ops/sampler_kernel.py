"""Fused QCMRF outcome sampler (port of :mod:`qcmrf_tpu.ops.sampler_kernel`).

Per shot: a uniform state ``x`` and one Bernoulli per clique with keep
probability ``c2_k(x)``, evaluated from Moebius coefficients. On a CUDA
tensor, :func:`sample_call` launches ``sampler_kernel`` of
``csrc/qcmrf_kernels.cu``, which keeps everything but the outputs in
registers; on a CPU tensor it runs :func:`sample_call_reference`, the plain
PyTorch version of the same arithmetic. The two agree bit for bit:

* random words come from Philox4x32-10 with key ``(seed, stream)`` and
  counter ``(shot_lo, shot_hi, j, 0)``; word 0 of ``j = 0`` gives ``x = w &
  (2^n - 1)``, and word ``t = k + 1`` of the shot (``j = t // 4``, word ``t
  % 4``) gives clique k's uniform ``u = (w >> 8) * 2^-24``;
* ``c2`` is :func:`qcmrf_tpu_torch.utils.moebius.eval_multilinear`'s chain,
  whose products and sums the kernel rounds one by one.

Rows of a ``(B, K << cmax)`` coefficient batch sample in one launch, row
``b`` on stream ``stream0 + b`` (the run driver passes each circuit's
suite-order index), so no two circuits share random words. Any ``shots``
is allowed: the kernel masks the ragged tail.
"""

from __future__ import annotations

import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.sim.analytic import _moebius_layout, check_theta_domain
from qcmrf_tpu_torch.utils import moebius

#: launches of the CUDA kernel, bumped where it is launched
LAUNCHES = {"sampler": 0}

#: output modes: (x, ancilla mask) | (x, accept flag) | flags | count
MODES = {"parts": 0, "flags_x": 1, "flags": 2, "count": 3}

_MASK32 = 0xFFFFFFFF
_U24 = 2.0 ** -24


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 words.

    A 32x32-bit product wraps in int64 with its bit pattern intact, so its
    low word is ``p & 0xFFFFFFFF`` and its high word ``(p >> 32) &
    0xFFFFFFFF``. Returns the four output words.
    """
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        p0 = c0 * 0xD2511F53
        p1 = c2 * 0xCD9E8D57
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK32) ^ c1 ^ k0, p1 & _MASK32,
                          ((p0 >> 32) & _MASK32) ^ c3 ^ k1, p0 & _MASK32)
    return c0, c1, c2, c3


def _check_shape(cliques: tuple, n: int, shots: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {sorted(MODES)}")
    if not 1 <= n <= 31:
        raise ValueError(f"n={n}: state ids are drawn as int32, n <= 31")
    if mode == "parts" and len(cliques) > 32:
        raise ValueError("ancilla bitmask limited to 32 cliques")
    if shots < 1:
        raise ValueError("shots must be >= 1")


def sample_call_reference(seed: int, cliques: tuple, n: int,
                          coef: torch.Tensor, shots: int, mode: str,
                          stream0: int = 0):
    """Plain PyTorch version of :func:`sample_call`, on any device."""
    _check_shape(cliques, n, shots, mode)
    _, shifts, cmax = _moebius_layout(cliques, n)
    B, dev = coef.shape[0], coef.device
    shot = torch.arange(shots, dtype=torch.int64, device=dev)
    lo, hi = shot & _MASK32, shot >> 32
    k0 = seed & _MASK32
    k1 = ((stream0 + torch.arange(B, dtype=torch.int64, device=dev))
          & _MASK32)[:, None]
    words = philox4x32_10(lo, hi, 0, 0, k0, k1)
    x = words[0] & ((1 << n) - 1)  # (B, shots): k1 is per row
    zero = torch.zeros((B, shots), dtype=torch.float32, device=dev)
    fired = torch.zeros((B, shots), dtype=torch.int64, device=dev)
    accept = torch.ones((B, shots), dtype=torch.bool, device=dev)
    for k, C in enumerate(cliques):
        t = k + 1
        if t % 4 == 0:
            words = philox4x32_10(lo, hi, t >> 2, 0, k0, k1)
        u = (words[t % 4] >> 8).to(torch.float32) * _U24
        bits = [((x >> int(shifts[i, k])) & 1).to(torch.float32)
                for i in range(len(C))]
        off = k << cmax
        c2 = moebius.eval_multilinear(
            bits, len(C), lambda s: coef[:, off + s, None], zero)
        if mode == "parts":
            fired |= (u >= c2).to(torch.int64) << k
        else:
            accept &= u < c2
    if mode == "count":
        return accept.sum(dim=1)
    flags = accept.to(torch.int32)
    if mode == "flags":
        return flags
    x = x.to(torch.int32)
    if mode == "flags_x":
        return x, flags
    # bit 31 (clique 31) would overflow int32: keep the bit pattern
    return x, torch.where(fired >= 1 << 31, fired - (1 << 32),
                          fired).to(torch.int32)


def sample_call(seed: int, cliques: tuple, n: int, coef: torch.Tensor,
                shots: int, mode: str, stream0: int = 0):
    """Sample ``shots`` outcomes for each row of ``coef`` ((B, K << cmax)
    keep-probability coefficients).

    Returns, per ``mode``: ``parts`` -> (x int32 (B, shots), ancilla mask as
    int32 bits (B, shots)); ``flags_x`` -> (x, accept flag int32 0/1);
    ``flags`` -> accept flags; ``count`` -> accepted shots, int64 (B,).
    On a CPU tensor this is the plain version; on a CUDA tensor, the kernel.
    The kernel has no backward: ``coef`` that requires grad under grad
    mode is refused on every device.
    """
    _build.refuse_grad(coef, "coef")
    if coef.device.type == "cpu":
        return sample_call_reference(seed, cliques, n, coef, shots, mode,
                                     stream0)
    _check_shape(cliques, n, shots, mode)
    dev = coef.device
    # extra: the count mode's eight int32 warp sums
    shifts, sizes, B, K, cmax = _build.structure_args(cliques, n, coef,
                                                      extra=32)
    x = a = count = None
    if mode in ("parts", "flags_x"):
        x = torch.empty((B, shots), dtype=torch.int32, device=dev)
    if mode == "count":
        # the kernel adds block partial counts into it atomically
        count = torch.zeros((B,), dtype=torch.int64, device=dev)
    else:
        a = torch.empty((B, shots), dtype=torch.int32, device=dev)
    nul = _build.ctypes.c_void_p(0)
    _build.launch(
        "qcmrf_sample", dev, _build.ptr(coef), _build.ptr(shifts),
        _build.ptr(sizes), B, K, cmax, n, shots, seed & _MASK32,
        stream0 & _MASK32, MODES[mode],
        _build.ptr(x) if x is not None else nul,
        _build.ptr(a) if a is not None else nul,
        _build.ptr(count) if count is not None else nul)
    LAUNCHES["sampler"] += 1
    if mode == "count":
        return count
    if mode == "flags":
        return a
    return x, a


def keep_prob_table(cliques: tuple, n: int, thetas: torch.Tensor,
                    beta: float) -> torch.Tensor:
    """Moebius coefficients of each clique's ``exp(beta*theta)`` table for
    a stack of thetas ``(..., d)``; returns ``(..., K << cmax)``."""
    idx_map, _, cmax = _moebius_layout(cliques, n)
    idx = torch.from_numpy(idx_map).to(thetas.device)
    tab = torch.exp(beta * thetas[..., idx])
    return moebius.transform(tab, cmax).reshape(*thetas.shape[:-1], -1)


def keep_prob_coefficients(mrf: MRF) -> torch.Tensor:
    """Moebius coefficients of each clique's exp(beta*theta) table,
    flattened (K * 2^cmax,)."""
    return keep_prob_table(mrf.cliques, mrf.n, mrf.theta, mrf.beta)


def _sample(seed: int, mrf: MRF, shots: int, mode: str, stream: int):
    check_theta_domain(mrf)
    coef = keep_prob_coefficients(mrf)[None]
    out = sample_call(seed, mrf.cliques, mrf.n, coef, shots, mode, stream)
    if isinstance(out, tuple):
        return tuple(o[0] for o in out)
    return out[0]


def sample_outcome_parts(seed: int, mrf: MRF, shots: int, stream: int = 0):
    """``(x, ancilla_mask)``: int32 state ids and the ancilla bitmask as
    int32 bits (bit k = clique k fired; torch has few uint32 operations, so
    read it as unsigned with ``.numpy().view(np.uint32)``). K <= 32."""
    return _sample(seed, mrf, shots, "parts", stream)


def sample_postselected(seed: int, mrf: MRF, shots: int, stream: int = 0):
    """``(x, accepted)``: state ids and whether all ancillas read 0. No
    clique-count limit."""
    x, a = _sample(seed, mrf, shots, "flags_x", stream)
    return x, a == 1


def sample_accept_flags(seed: int, mrf: MRF, shots: int, stream: int = 0):
    """Acceptance flags only: the same random words as
    :func:`sample_postselected`, without writing ``x``."""
    return _sample(seed, mrf, shots, "flags", stream) == 1


def sample_accept_count(seed: int, mrf: MRF, shots: int,
                        stream: int = 0) -> torch.Tensor:
    """Number of accepted shots out of ``shots`` (int64, exact), reduced in
    the kernel; equals ``sample_accept_flags(...).sum()`` for the same
    seed and stream."""
    return _sample(seed, mrf, shots, "count", stream)
