"""Fused QCMRF outcome sampler (port of :mod:`qcmrf_tpu.ops.sampler_kernel`).

Per shot: a uniform state ``x`` and one Bernoulli per clique with keep
probability ``c2_k(x) = exp(beta * theta_{k, y})``, read from each clique's
table of keep probabilities (:func:`keep_prob_values`) at the clique's slot
word ``y`` of ``x``. On a CUDA tensor, :func:`sample_call` launches
``sampler_kernel`` of ``csrc/qcmrf_kernels.cu``, which holds the table in
shared memory and everything but the outputs in registers; on a CPU tensor
it runs :func:`sample_call_reference`, the plain PyTorch version of the
same arithmetic. The two agree bit for bit:

* random words come from Philox4x32-10 with key ``(seed, stream)`` and
  counter ``(shot_lo, shot_hi, j, 0)``; word 0 of ``j = 0`` gives ``x = w &
  (2^n - 1)``, and word ``t = k + 1`` of the shot (``j = t // 4``, word ``t
  % 4``) gives clique k's uniform ``u = (w >> 8) * 2^-24``
  (:func:`shot_uniforms`);
* clique k fires when ``u >= c2``, ``c2`` the table's float32 entry.

The JAX kernel rebuilds ``c2`` from the table's Moebius coefficients
(:func:`keep_prob_table`) by a chain of products and sums, which rounds
differently: an ancilla bit of the two can differ only on a shot whose
``u`` lies within an ulp or two of ``c2``.

Rows of a ``(B, K << cmax)`` table batch sample in one launch, row ``b`` on
stream ``stream0 + b`` (the run driver passes each circuit's suite-order
index), so no two circuits share random words. Any ``shots`` is allowed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.sim.analytic import _moebius_layout, check_theta_domain
from qcmrf_tpu_torch.utils import moebius, profiling

#: launches of the CUDA kernels (the port's one launch counter)
LAUNCHES = profiling.LAUNCHES

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


def shot_uniforms(seed: int, n: int, K: int, shots: int, B: int = 1,
                  stream0: int = 0, device=None, first: int = 0):
    """The random words of shots ``first .. first + shots`` of every row:
    ``(x, uniforms)``, ``x`` int64 (B, shots) and ``uniforms`` an iterator
    over the cliques that yields clique k's ``u`` float32 (B, shots) in
    turn (one Philox call every four cliques)."""
    shot = torch.arange(first, first + shots, dtype=torch.int64,
                        device=device)
    lo, hi = shot & _MASK32, shot >> 32
    k0 = seed & _MASK32
    k1 = ((stream0 + torch.arange(B, dtype=torch.int64, device=device))
          & _MASK32)[:, None]
    words = philox4x32_10(lo, hi, 0, 0, k0, k1)

    def uniforms(words=words):
        for k in range(K):
            t = k + 1
            if t % 4 == 0:
                words = philox4x32_10(lo, hi, t >> 2, 0, k0, k1)
            yield (words[t % 4] >> 8).to(torch.float32) * _U24

    return words[0] & ((1 << n) - 1), uniforms()


@functools.lru_cache(maxsize=256)
def _slot_shifts(cliques: tuple, n: int, device: torch.device):
    """(K, cmax) int32 on ``device``: the id right-shift of each clique
    slot's variable, 31 for a slot past the clique's size (id bit 31 is 0
    for n <= 31, so the slot word's bit is 0)."""
    cmax = max(len(C) for C in cliques)
    sh = np.full((len(cliques), cmax), 31, np.int32)
    for k, C in enumerate(cliques):
        sh[k, :len(C)] = [n - 1 - v for v in C]
    return torch.from_numpy(sh).to(device)


def sample_call_reference(seed: int, cliques: tuple, n: int,
                          values: torch.Tensor, shots: int, mode: str,
                          stream0: int = 0):
    """Plain PyTorch version of :func:`sample_call`, on any device."""
    _check_shape(cliques, n, shots, mode)
    B, dev = values.shape[0], values.device
    cmax = max(len(C) for C in cliques)
    x, uniforms = shot_uniforms(seed, n, len(cliques), shots, B, stream0,
                                dev)
    sh = _slot_shifts(cliques, n, dev).long()
    fired = torch.zeros((B, shots), dtype=torch.int64, device=dev)
    accept = torch.ones((B, shots), dtype=torch.bool, device=dev)
    for k, u in enumerate(uniforms):
        y = sum(((x >> sh[k, i]) & 1) << i for i in range(cmax))
        c2 = values.gather(1, (k << cmax) + y)
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


def sampler_shared_bytes(K: int, cmax: int) -> int:
    """Shared memory of a sampler block: the table's thresholds and slot
    shifts, padded to whole Philox calls (``4 * ((K + 4) // 4) - 1``
    cliques), and the count mode's eight 64-bit warp sums."""
    return (4 * ((K + 4) // 4) - 1) * ((1 << cmax) + cmax) * 4 + 64


def sample_call(seed: int, cliques: tuple, n: int, values: torch.Tensor,
                shots: int, mode: str, stream0: int = 0):
    """Sample ``shots`` outcomes for each row of ``values`` ((B, K << cmax)
    keep probabilities, :func:`keep_prob_values`).

    Returns, per ``mode``: ``parts`` -> (x int32 (B, shots), ancilla mask as
    int32 bits (B, shots)); ``flags_x`` -> (x, accept flag int32 0/1);
    ``flags`` -> accept flags; ``count`` -> accepted shots, int64 (B,).
    On a CPU tensor this is the plain version; on a CUDA tensor, the kernel.
    The kernel has no backward: ``values`` that require grad under grad
    mode are refused on every device.
    """
    _build.refuse_grad(values, "values")
    if values.device.type == "cpu":
        return sample_call_reference(seed, cliques, n, values, shots, mode,
                                     stream0)
    _check_shape(cliques, n, shots, mode)
    dev = values.device
    K, cmax = len(cliques), max(len(C) for C in cliques)
    B = _build.check_rows(values, K, cmax, sampler_shared_bytes(K, cmax),
                          "the sampler's table")
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
        "qcmrf_sample", dev, _build.ptr(values),
        _build.ptr(_slot_shifts(cliques, n, dev)), B, K, cmax, n, shots,
        seed & _MASK32, stream0 & _MASK32, MODES[mode],
        _build.ptr(x) if x is not None else nul,
        _build.ptr(a) if a is not None else nul,
        _build.ptr(count) if count is not None else nul)
    profiling.launch("sampler")
    if mode == "count":
        return count
    if mode == "flags":
        return a
    return x, a


def keep_prob_values(cliques: tuple, n: int, thetas: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """Each clique's keep probabilities ``exp(beta*theta)`` for a stack of
    thetas ``(..., d)``, at ``k * 2^cmax + y`` with ``y`` the clique's slot
    word (bit i <-> slot i; a smaller clique's table repeats over the
    unused slots): ``(..., K << cmax)``, what :func:`sample_call` takes."""
    idx_map, _, _ = _moebius_layout(cliques, n)
    with profiling.span("qcmrf.wait"):
        idx = torch.from_numpy(idx_map).to(thetas.device)
    return torch.exp(beta * thetas[..., idx]).reshape(
        *thetas.shape[:-1], -1)


def keep_prob_table(cliques: tuple, n: int, thetas: torch.Tensor,
                    beta: float) -> torch.Tensor:
    """Moebius coefficients of each clique's ``exp(beta*theta)`` table for
    a stack of thetas ``(..., d)`` (the JAX kernel's chain evaluates them):
    the transform of :func:`keep_prob_values`, ``(..., K << cmax)``."""
    cmax = max(len(C) for C in cliques)
    tab = keep_prob_values(cliques, n, thetas, beta)
    lead = thetas.shape[:-1]
    return moebius.transform(tab.reshape(*lead, len(cliques), 1 << cmax),
                             cmax).reshape(*lead, -1)


def keep_prob_coefficients(mrf: MRF) -> torch.Tensor:
    """Moebius coefficients of each clique's exp(beta*theta) table,
    flattened (K * 2^cmax,)."""
    return keep_prob_table(mrf.cliques, mrf.n, mrf.theta, mrf.beta)


@profiling.spanned("qcmrf.sampler")
def _sample(seed: int, mrf: MRF, shots: int, mode: str, stream: int):
    check_theta_domain(mrf)
    with profiling.span("qcmrf.sampler.table"):
        values = keep_prob_values(mrf.cliques, mrf.n, mrf.theta,
                                  mrf.beta)[None]
    out = sample_call(seed, mrf.cliques, mrf.n, values, shots, mode, stream)
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
