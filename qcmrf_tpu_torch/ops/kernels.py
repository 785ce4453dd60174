"""Log-potential table, the streaming sweeps (logsumexp, argmax, monomial
moments), the H·D·H sandwich passes and the generic gate passes of the
plane engine (the port of :mod:`qcmrf_tpu.ops.kernels`).

The plain versions evaluate ``beta * theta^T phi(x)`` per state id from
the per-clique Moebius coefficients of :func:`moebius_coefficients`,
clique by clique in the order of ``_logpot_block``, with ``beta`` applied
after the clique sum (the chain). On the card the table, the logsumexp and
both moment sweeps evaluate sub-blocks of ``2**L`` consecutive states at
once through the block-invariant split (:func:`split_plan`), a subset-sum
transform of per-sub-block monomial coefficients, as the JAX package's
loop kernels do: the same entries summed in another order, each value
within :func:`split_gap` of the chain's. The argmax screens states
through the split and evaluates the chain only for those within
:func:`map_tolerance` of the running maximum, so its answer is the
chain's, bit for bit.

* :func:`logpot_table` writes the ``(B, 2**n)`` table (``logpot_kernel``,
  the split; :func:`logpot_table_split_reference` is its plain version
  bit for bit, :func:`logpot_table_reference` the chain's table);
* :func:`lse_partials` sweeps the states without a table and returns one
  (max, scaled sum) pair per block of states (``lse_kernel``);
  :func:`combine_lse` finishes the logsumexp;
* :func:`map_partials` returns one (best value, earliest id) pair per
  block (``map_kernel``: the split screens, the chain decides);
  :func:`combine_map` finishes the argmax;
* :func:`monomial_moments` sums ``p(x)`` over the states of each monomial
  for a given lnZ (``lnz_moments_kernel`` with ``lnz`` given);
* :func:`lnz_moments_partials` does both in one sweep by a running max
  per block (``lnz_moments_kernel``); :func:`combine_lnz_moments` gives
  ``(lnZ, E_p[monomials])``.

Each of these sweeps, and its plain versions, takes ``x0_blocks`` and
``blocks`` (a :func:`sweep_range`): it covers only those blocks of the
whole sweep's geometry, and its outputs are the whole sweep's for those
blocks bit for bit (the JAX loop kernels' ``x0_blocks``; the sharded
sweeps of :mod:`qcmrf_tpu_torch.parallel.sharded` give each shard its
range).

On a CUDA tensor each launches its kernel of ``csrc/qcmrf_kernels.cu``; on a
CPU tensor it runs its plain PyTorch version (``*_reference``, the chain),
which any device can run. Rows of a coefficient batch are separate models of one
structure, evaluated in one launch. The kernels have no backward: under
grad mode each wrapper refuses coefficients that require grad, on every
device. The differentiable lnZ is :func:`log_partition`, whose backward
is the moments of the fused sweep (:func:`lnz_and_moments`).

The sandwich passes (kernels of ``csrc/circuit_kernels.cu``) act on a
statevector held as two float32 planes, real and imaginary, of ``2**nq``
values each (any shape, contiguous; qubit 0 is the least significant bit
of the flat index):

* :func:`apply_hdh_sandwich_multi`: k <= 7 H(a)·D·H(a) on adjacent
  ancillas (``hdh_multi_kernel``); :func:`apply_hdh_sandwich`,
  :func:`apply_hdh_sandwich_pair` and :func:`apply_hdh_sandwich_quad` are
  its k = 1, 2 and 4 calls;
* :func:`apply_hdh_sandwich_multi_uniform`: the same k sandwiches on the
  folded uniform H-wall state, write-only (``hdh_multi_uniform_kernel``).

The generic gate passes (kernels of ``csrc/gate_kernels.cu``) take planes
of at least 7 qubits:

* :func:`apply_diagonal_profile`: a run of diagonal gates as one phase
  profile; :func:`apply_masked_rotation` is its one-term call
  (``diag_kernel``);
* :func:`apply_1q` on a row qubit (q >= 7) and :func:`apply_2q_row_pair`
  on two adjacent row qubits (``row_gate_kernel<K>``, K = 1, 2);
* :func:`apply_lane_factored`: the planner's ``lane`` op, ``M = F6 ⊗ ...
  ⊗ F0`` on qubits 0-6 given by its seven 2x2 factors, one butterfly a
  value a factor, and :func:`apply_1q` on a lane qubit
  (``lane_factored_kernel``);
* :func:`apply_lane`: ``out = state · Mᵀ`` per 128-value row for a complex
  128x128 ``M`` given without factors (``lane_kernel``, the dense
  product on the tensor cores at float32 accuracy);
* :func:`copy_planes`: both planes copied, the bytes of a gate pass
  (``copy_kernel``), the rate the passes are held against;
* :func:`fma_chain_max`: chained float32 FMAs (``fma_peak_kernel``), the
  compute rate the float kernels are held against.

Every pass but the copy updates the planes **in place** and returns them:
the JAX versions alias their inputs to their outputs, and at 32 qubits two
planes take 32 GiB, which the card does not hold twice. A profile (``mu``
or a ``nu`` of a sandwich, or a diagonal pass) is ``base + sum_t
angles[t] * [terms[t] holds]``, a term being a tuple of ``(qubit, wanted
bit)`` conditions; no term of a sandwich may condition on its ancillas.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.sim.analytic import _moebius_layout
from qcmrf_tpu_torch.utils import moebius
from qcmrf_tpu_torch.utils.config import resolve_device

#: launches of the CUDA kernels, bumped where each is launched
LAUNCHES = {"logpot": 0, "lse": 0, "map": 0, "moments": 0,
            "lnz_moments": 0, "hdh_multi": 0, "hdh_multi_uniform": 0,
            "diag": 0, "row_gate": 0, "lane": 0, "lane_factored": 0,
            "copy": 0, "fma_peak": 0}

#: the streaming logsumexp writes at most this many partial pairs a row
MAX_LSE_PARTS = 4096
#: and gives each block at least this many states
MIN_LSE_BLOCK_STATES = 1024

#: threads a block of the streaming kernels (kThreads of the CUDA source)
_BLOCK_THREADS = 256
#: static shared memory of the lse and map kernels' block reductions: a
#: float32 max and sum, or a float32 value and int64 id, per thread (and
#: for map a float32 max and an int64 candidate count per warp, and the
#: list of 256 int64 candidate ids with its int32 length)
_LSE_STATIC_BYTES = _BLOCK_THREADS * 8
_MAP_STATIC_BYTES = (_BLOCK_THREADS * 12 + (_BLOCK_THREADS // 32) * 12
                     + 256 * 8 + 4)
#: the moment sweeps' shared memory per monomial (int64 mask, float32 sum)
_MOMENT_BYTES = 12
#: lnz_moments_kernel's static shared memory: one float32 max a warp
_LNZ_STATIC_BYTES = (_BLOCK_THREADS // 32) * 4


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
    acc = torch.zeros((coef.shape[0], x.shape[0]), dtype=coef.dtype,
                      device=coef.device)
    for k, C in enumerate(cliques):
        off = k << cmax
        bits = [((x >> (n - 1 - v)) & 1).to(torch.float32) for v in C]
        acc = moebius.eval_multilinear(
            bits, len(C), lambda s: coef[:, off + s, None], acc)
    return acc


def _amplitudes(lp: torch.Tensor, n: int) -> torch.Tensor:
    """The table's amplitude epilogue ``2^(-n/2) * exp(lp / 2)``."""
    return torch.exp(0.5 * lp) * (2.0 ** (-0.5 * n))


def lse_geometry(num_states: int):
    """(parts, states per part) of the streaming logsumexp: every part
    holds at least one state."""
    parts = min(MAX_LSE_PARTS, -(-num_states // MIN_LSE_BLOCK_STATES))
    per_part = -(-num_states // parts)
    return -(-num_states // per_part), per_part


def sweep_range(n: int, x0_blocks: int = 0, blocks: int = None):
    """``(x0_blocks, blocks, per_part)`` of a sweep over the blocks
    ``[x0_blocks, x0_blocks + blocks)`` of ``lse_geometry(2**n)``, the
    state ids ``[x0_blocks * per_part, (x0_blocks + blocks) * per_part)``
    (``blocks`` defaults to the rest of the sweep). The offset is in block
    units, as the JAX package's loop kernels take it, and a Python int:
    ids past 2^31 are exact. Raises outside the sweep or when empty."""
    parts, per_part = lse_geometry(1 << n)
    x0 = int(x0_blocks)
    count = parts - x0 if blocks is None else int(blocks)
    if x0 < 0 or count < 1 or x0 + count > parts:
        raise ValueError(f"blocks [{x0}, {x0 + count}) outside the "
                         f"{parts} blocks of a {n}-variable sweep")
    return x0, count, per_part


def _range_ids(n: int, x0_blocks: int, blocks, device) -> torch.Tensor:
    """int64 state ids of a :func:`sweep_range`."""
    x0, count, per_part = sweep_range(n, x0_blocks, blocks)
    return torch.arange(x0 * per_part, (x0 + count) * per_part,
                        dtype=torch.int64, device=device)


def _range_sub_blocks(n: int, L: int, x0_blocks: int, blocks) -> range:
    """The sub-blocks of ``2**L`` ids of a :func:`sweep_range`."""
    x0, count, per_part = sweep_range(n, x0_blocks, blocks)
    return range((x0 * per_part) >> L, ((x0 + count) * per_part) >> L)


def logpot_table_reference(cliques: tuple, n: int, coef: torch.Tensor,
                           beta: float, fuse_amp: bool = False,
                           x0_blocks: int = 0, blocks: int = None):
    """Plain PyTorch version of :func:`logpot_table` by the chain, on any
    device: the CPU route, and the card's oracle independent of its
    kernel. In ``coef``'s dtype: float64 coefficients give the chain in
    float64."""
    x = _range_ids(n, x0_blocks, blocks, coef.device)
    acc = _clique_sum(cliques, n, coef, x) * beta
    return _amplitudes(acc, n) if fuse_amp else acc


def logpot_table_split_reference(cliques: tuple, n: int, coef: torch.Tensor,
                                 beta: float, fuse_amp: bool = False,
                                 x0_blocks: int = 0, blocks: int = None):
    """Plain PyTorch version of ``logpot_kernel``, on any device, equal to
    it bit for bit: :func:`split_log_potentials_reference` over every
    sub-block of the range at ``L = split_bits(n)``, then the epilogue.
    Each value lies within :func:`split_gap` of
    :func:`logpot_table_reference`'s."""
    plan = split_plan(cliques, n, split_bits(n))
    subs = _range_sub_blocks(n, plan.L, x0_blocks, blocks)
    lp = split_log_potentials_reference(plan, coef, beta, subs).reshape(
        coef.shape[0], len(subs) << plan.L)
    return _amplitudes(lp, n) if fuse_amp else lp


def logpot_table(cliques: tuple, n: int, coef: torch.Tensor, beta: float,
                 fuse_amp: bool = False, x0_blocks: int = 0,
                 blocks: int = None) -> torch.Tensor:
    """``beta * theta^T phi(x)`` for all ``2**n`` states and every row of
    ``coef`` ((B, K << cmax)); float32 (B, 2**n). ``fuse_amp`` returns the
    post-selected amplitudes ``2^(-n/2) * exp(lp / 2)`` instead. On the
    card the states go through the split (``logpot_kernel``,
    :func:`logpot_table_split_reference` bit for bit), as the JAX
    package's loop kernel: each value within :func:`split_gap` of the
    chain's, which the CPU route computes. ``x0_blocks`` and ``blocks``
    write only the slice of a :func:`sweep_range` (its columns, in
    order)."""
    _build.refuse_grad(coef, "coef")
    if coef.device.type == "cpu":
        return logpot_table_reference(cliques, n, coef, beta, fuse_amp,
                                      x0_blocks, blocks)
    dev = coef.device
    plan = split_plan(cliques, n, split_bits(n))
    tables, B, x0, count, per_part = _split_args(
        cliques, n, coef, split_shared_bytes(plan), x0_blocks, blocks)
    out = torch.empty((B, count * per_part), dtype=torch.float32, device=dev)
    _build.launch("qcmrf_logpot", dev, tables, _build.ptr(coef), B,
                  coef.shape[1], per_part, x0, count, beta, int(fuse_amp),
                  2.0 ** (-0.5 * n), _build.ptr(out))
    LAUNCHES["logpot"] += 1
    return out


# --------------------------------------------------------------------------
# The block-invariant split of the streaming lnZ sweeps
# --------------------------------------------------------------------------
#
# A block of lse_geometry is cut into sub-blocks of 2^L consecutive state
# ids, across which the high bits h = x >> L are fixed (variable v at id
# bit n - 1 - v). The log-potential is a sum over monomials g (the
# variable sets of the clique subsets) of c_g [x holds g], with c_g the sum
# of the coefficient entries whose subset is g. Split g into its low part
# t (an index into [0, 2^L)) and its high part hm (a mask on h): then, per
# sub-block, P[t] = sum of c_g over the monomials of target t with (h & hm)
# == hm, and the subset-sum (zeta) transform value[xl] = sum_{t subset of
# xl} P[t] gives the log-potential of all 2^L states of the sub-block. The
# sums of the moments come back the dual way: the superset sums W[t] =
# sum_{xl superset of t} w[xl], then one test a monomial a sub-block.

#: state-id bits of a sub-block of the split sweeps (fewer when a block
#: of ``lse_geometry`` holds fewer states)
SPLIT_BITS = 12


class SplitPlan(NamedTuple):
    """The split of a structure at ``L`` low id bits, from the structure
    alone. Monomials (variable sets of clique subsets) are sorted by
    target; each fixed-order sum of the plan is cut into items of about
    sqrt(its length) entries, so that no thread sums a long chain:

    * ``hm`` int64 (U,): each monomial's high mask on ``h = x >> L``;
    * ``target`` int32 (U,): its low part, an index into [0, 2^L);
    * ``coef_index`` int32 (C,): the coefficient entries ``k * 2^cmax +
      s`` of every monomial, grouped by monomial in clique order;
    * ``c_items`` (CI + 1,), ``c_heads`` (U + 1,): entry offsets of the
      items of the monomial coefficients, and item offsets of each
      monomial;
    * ``m_items`` (MI + 1,), ``m_heads`` (G + 1,), ``targets`` (G,):
      monomial offsets of the items of a sub-block's ``P``, item offsets
      of each target group, and the group's target."""

    L: int
    hm: np.ndarray
    target: np.ndarray
    coef_index: np.ndarray
    c_items: np.ndarray
    c_heads: np.ndarray
    m_items: np.ndarray
    m_heads: np.ndarray
    targets: np.ndarray


def split_bits(n: int) -> int:
    """``L`` of the split sweeps over ``2**n`` states: ``SPLIT_BITS``, or
    log2 of a block's states when a block holds fewer (then ``L = n`` below
    10 variables: one sub-block)."""
    per_part = lse_geometry(1 << n)[1]
    return min(SPLIT_BITS, per_part.bit_length() - 1)


def _segments(counts) -> tuple:
    """Items of a segmented sum of groups of ``counts`` entries: each group
    in pieces of ceil(sqrt(count)) entries. Returns (entry offsets of the
    items, item offsets of the groups), int32."""
    items, heads, pos = [0], [0], 0
    for c in counts:
        size = math.isqrt(c - 1) + 1
        items.extend(pos + min(lo + size, c) for lo in range(0, c, size))
        pos += c
        heads.append(len(items) - 1)
    return np.asarray(items, np.int32), np.asarray(heads, np.int32)


@functools.lru_cache(maxsize=256)
def split_plan(cliques: tuple, n: int, L: int) -> SplitPlan:
    """The :class:`SplitPlan` of ``cliques`` over ``n`` variables at ``L``
    low id bits (``1 <= L <= n``)."""
    if not 1 <= L <= n:
        raise ValueError(f"L={L} outside 1..{n}")
    cmax = max(len(C) for C in cliques)
    layout = moebius.monomial_layout(cliques)
    masks = moebius.monomial_masks(cliques, n).astype(np.uint64)
    low = np.uint64((1 << L) - 1)
    target = (masks & low).astype(np.int64)
    order = np.argsort(target, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    # contributions (monomial, entry) in clique order, grouped by monomial
    contrib = sorted((int(rank[u]), (k << cmax) | s)
                     for k, cmap in enumerate(layout.cmaps)
                     for s, u in enumerate(cmap))
    per_mono = np.bincount([u for u, _ in contrib], minlength=len(order))
    c_items, c_heads = _segments(per_mono.tolist())
    tsorted = target[order]
    targets, per_target = np.unique(tsorted, return_counts=True)
    m_items, m_heads = _segments(per_target.tolist())
    return SplitPlan(
        L=L, hm=(masks[order] >> np.uint64(L)).astype(np.int64),
        target=tsorted.astype(np.int32),
        coef_index=np.asarray([e for _, e in contrib], np.int32),
        c_items=c_items, c_heads=c_heads, m_items=m_items, m_heads=m_heads,
        targets=targets.astype(np.int32))


def _transform(a: torch.Tensor, L: int, bits, superset: bool):
    """The subset-sum (or, ``superset``, the superset-sum) transform along
    the last axis (2^L), one stage a bit in the order of ``bits``."""
    lead = a.shape[:-1]
    for j in bits:
        t = a.reshape(*lead, 1 << (L - 1 - j), 2, 1 << j)
        lo, hi = t[..., 0, :], t[..., 1, :]
        pair = (lo + hi, hi) if superset else (lo, hi + lo)
        a = torch.stack(pair, dim=-2).reshape(*lead, 1 << L)
    return a


def subset_sum(a: torch.Tensor, L: int) -> torch.Tensor:
    """The zeta transform along the last axis (2^L): ``out[x] = sum_{t
    subset of x} a[t]``, one stage a bit."""
    return _transform(a, L, range(L), False)


def superset_sum(a: torch.Tensor, L: int) -> torch.Tensor:
    """The dual transform along the last axis (2^L): ``out[t] = sum_{x
    superset of t} a[x]``, one stage a bit."""
    return _transform(a, L, range(L), True)


def _kernel_stages(L: int, superset: bool) -> list:
    """The kernels' order of the transform's stages: the warp bits 5-7 in
    shared memory, the lane bits 0-4 by shuffles and the register bits 8
    up; the subset sums take the warp bits first, the superset sums
    last."""
    warp = list(range(5, min(L, 8)))
    rest = list(range(min(L, 5))) + list(range(8, L))
    return rest + warp if superset else warp + rest


def _ordered_sums(values: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """Sums of the runs ``values[..., offsets[i]:offsets[i + 1]]``, each
    from 0 left to right as one thread of the kernels takes it (exact
    zeros pad the shorter runs): (..., len(offsets) - 1)."""
    lens = np.diff(offsets)
    width = int(lens.max(initial=0))
    pick = offsets[:-1, None] + np.arange(width)
    held = np.arange(width) < lens[:, None]
    dev = values.device
    g = values[..., torch.from_numpy(np.where(held, pick, 0)).to(dev)]
    g = torch.where(torch.from_numpy(held).to(dev), g, 0.0)
    acc = values.new_zeros(g.shape[:-1])
    for k in range(width):
        acc = acc + g[..., k]
    return acc


def _segment_sum(values: torch.Tensor, items: np.ndarray,
                 heads: np.ndarray) -> torch.Tensor:
    """Group sums of ``values`` (..., entries) through the plan's items,
    in the kernels' order on any device: (..., groups)."""
    return _ordered_sums(_ordered_sums(values, items), heads)


def split_log_potentials_reference(plan: SplitPlan, coef: torch.Tensor,
                                   beta: float, sub_blocks) -> torch.Tensor:
    """Plain PyTorch version of the split evaluator of the table, lse,
    map and moment kernels (``split_values``), on any device and bit for
    bit: ``beta * theta^T phi(x)`` at the ids ``x = h * 2^L + xl`` of
    every sub-block ``h`` of ``sub_blocks`` and every ``xl`` in [0, 2^L),
    for every row of ``coef`` ((B, K << cmax)): float32 (B,
    len(sub_blocks), 2^L). The monomial coefficients, then ``P`` per
    sub-block through the plan's items and target groups, both in float64
    and ``P`` rounded to float32 once, then the float32 subset-sum
    transform in the kernels' stage order and ``beta``, every sum in the
    kernels' order."""
    dev = coef.device
    c = _segment_sum(
        coef[:, torch.from_numpy(plan.coef_index).to(dev)].double(),
        plan.c_items, plan.c_heads)
    h = torch.as_tensor(sub_blocks, dtype=torch.int64, device=dev)
    hm = torch.from_numpy(plan.hm).to(dev)
    hit = (h[:, None] & hm) == hm
    groups = _segment_sum(torch.where(hit, c[:, None, :], 0.0),
                          plan.m_items, plan.m_heads)
    P = coef.new_zeros((coef.shape[0], len(h), 1 << plan.L))
    P[..., torch.from_numpy(plan.targets).to(dev).long()] = groups.float()
    return _transform(P, plan.L, _kernel_stages(plan.L, False),
                      False) * beta


def split_moment_sums_reference(w: torch.Tensor, L: int, sub_blocks,
                                masks: torch.Tensor,
                                per_part: int = None) -> torch.Tensor:
    """Plain PyTorch version of ``lnz_moments_kernel``'s moment rule, in
    its order: for weights ``w`` (B, len(sub_blocks), 2^L) of the states
    of each sub-block, the superset sums ``W`` (the kernels' stage
    order), then per monomial mask ``g`` (id bits) the sum, sub-block by
    sub-block from 0, over the sub-blocks ``h`` with ``(h & (g >> L)) ==
    g >> L`` of ``W[g & (2^L - 1)]``: (B, m) in ``w``'s dtype, the sum of
    ``w`` over each monomial's states. With ``per_part``, the sums start
    anew every ``per_part`` sub-blocks, as a kernel block's: (B,
    len(sub_blocks) // per_part, m)."""
    W = _transform(w, L, _kernel_stages(L, True), True)
    h = torch.as_tensor(sub_blocks, dtype=torch.int64, device=w.device)
    gh, gl = masks >> L, masks & ((1 << L) - 1)
    terms = torch.where((h[:, None] & gh) == gh, W[..., gl], 0.0)
    per = len(h) if per_part is None else per_part
    terms = terms.reshape(w.shape[0], -1, per, masks.numel())
    acc = terms.new_zeros((w.shape[0], terms.shape[1], masks.numel()))
    for i in range(per):
        acc = acc + terms[:, :, i]
    return acc[:, 0] if per_part is None else acc


def _block_table(cliques: tuple, n: int, coef: torch.Tensor, beta: float,
                 x0_blocks: int = 0, blocks: int = None):
    """The plain table of a :func:`sweep_range` cut into its blocks:
    ((B, blocks, per_part), per_part)."""
    _, count, per_part = sweep_range(n, x0_blocks, blocks)
    lp = logpot_table_reference(cliques, n, coef, beta, False, x0_blocks,
                                blocks)
    return lp.reshape(coef.shape[0], count, per_part), per_part


def lse_partials_reference(cliques: tuple, n: int, coef: torch.Tensor,
                           beta: float, x0_blocks: int = 0,
                           blocks: int = None):
    """Plain PyTorch version of :func:`lse_partials`, on any device."""
    lp, _ = _block_table(cliques, n, coef, beta, x0_blocks, blocks)
    m = lp.amax(dim=-1)
    return m, torch.exp(lp - m[..., None]).sum(dim=-1)


def split_shared_bytes(plan: SplitPlan, masks: int = 0) -> int:
    """Dynamic shared memory of a split kernel's block: the plan's tables,
    their item sums and ``P`` (``lse_kernel``, ``logpot_kernel``); with
    ``masks`` monomials, also their masks and sums and ``W``
    (``lnz_moments_kernel``)."""
    U, CI = len(plan.hm), len(plan.c_items) - 1
    MI, G = len(plan.m_items) - 1, len(plan.targets)
    size = 8 * (2 * U + max(CI, MI)) + 4 * (MI + 2 * G + 2 + (1 << plan.L))
    if masks:
        size += _MOMENT_BYTES * masks + 4 * (1 << plan.L)
    return size


@functools.lru_cache(maxsize=256)
def _device_plan(cliques: tuple, n: int, L: int, device: torch.device):
    """The plan's tables on ``device`` and the ``SplitTables`` that point
    at them (the tensors stay cached beside it)."""
    plan = split_plan(cliques, n, L)
    tabs = [torch.from_numpy(a).to(device) for a in (
        plan.hm, plan.coef_index, plan.c_items, plan.c_heads, plan.m_items,
        plan.m_heads, plan.targets)]
    return tabs, _build.SplitTables(
        *(t.data_ptr() for t in tabs), L, len(plan.hm),
        len(plan.c_items) - 1, len(plan.m_items) - 1, len(plan.targets))


def _split_args(cliques: tuple, n: int, coef: torch.Tensor, need: int,
                x0_blocks: int = 0, blocks: int = None):
    """Checked arguments of a split kernel: ``(tables, B, x0_blocks,
    blocks, per_part)`` of a :func:`sweep_range`. Raises when ``need``
    bytes of shared memory, static included, do not fit a block."""
    B = _build.check_rows(coef, len(cliques), max(len(C) for C in cliques),
                          need, "the split plan and kernel")
    x0, count, per_part = sweep_range(n, x0_blocks, blocks)
    _, tables = _device_plan(cliques, n, split_bits(n), coef.device)
    return tables, B, x0, count, per_part


def lse_partials(cliques: tuple, n: int, coef: torch.Tensor, beta: float,
                 x0_blocks: int = 0, blocks: int = None):
    """Per-block (max, scaled sum) of ``beta * theta^T phi(x)`` over all
    ``2**n`` states, for every row of ``coef``: two float32 (B, parts)
    tensors (``lse_geometry`` gives ``parts``). No table is written; on
    the card the states are evaluated through the split
    (:func:`split_plan`). ``x0_blocks`` and ``blocks`` sweep only those
    blocks of a :func:`sweep_range`: (B, blocks), the whole sweep's
    partials of those blocks."""
    _build.refuse_grad(coef, "coef")
    if coef.device.type == "cpu":
        return lse_partials_reference(cliques, n, coef, beta, x0_blocks,
                                      blocks)
    dev = coef.device
    plan = split_plan(cliques, n, split_bits(n))
    tables, B, x0, parts, per_part = _split_args(
        cliques, n, coef, split_shared_bytes(plan) + _LSE_STATIC_BYTES,
        x0_blocks, blocks)
    m = torch.empty((B, parts), dtype=torch.float32, device=dev)
    s = torch.empty((B, parts), dtype=torch.float32, device=dev)
    _build.launch("qcmrf_lse", dev, tables, _build.ptr(coef), B,
                  coef.shape[1], per_part, x0, parts, beta, _build.ptr(m),
                  _build.ptr(s))
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
    """``ln Z`` with no table, differentiable in ``mrf.theta``. The sweep is
    chosen before any runs: under differentiation (grad mode on and
    ``theta`` requiring grad) one fused lnZ + moments sweep
    (:func:`lnz_and_moments`), whose moments are the backward, ``beta *
    E_p[phi] * g``; otherwise the streaming logsumexp alone. ``beta`` is
    a constant."""
    if torch.is_grad_enabled() and mrf.theta.requires_grad:
        return _LogPartition.apply(mrf.theta, mrf.cliques, mrf.n,
                                   float(mrf.beta))
    coef = moebius_coefficients(mrf)[None]
    return combine_lse(*lse_partials(mrf.cliques, mrf.n, coef, mrf.beta))[0]


# --------------------------------------------------------------------------
# Streaming argmax and streaming monomial moments
# --------------------------------------------------------------------------

#: below this many variables map_state_streaming takes the dense argmax of
#: the table on the CPU (the JAX package's kernel floor); the card's table
#: is the split's, so there the map kernel serves every n
MIN_KERNEL_N = 10
_NO_STATE = torch.iinfo(torch.int64).max
#: coefficient rows one launch of the map kernel takes (its grid's y
#: dimension, capped at 65535 by the card); map_partials splits past it
MAX_LAUNCH_ROWS = 65535


def map_partials_reference(cliques: tuple, n: int, coef: torch.Tensor,
                           beta: float, x0_blocks: int = 0,
                           blocks: int = None):
    """Plain PyTorch version of :func:`map_partials`, on any device."""
    lp, per_part = _block_table(cliques, n, coef, beta, x0_blocks, blocks)
    best = lp.amax(dim=-1)
    ids = _range_ids(n, x0_blocks, blocks, coef.device).reshape(
        lp.shape[1:])
    hit = torch.where(lp == best[..., None], ids, _NO_STATE)
    return best, hit.amin(dim=-1)


#: float32 unit roundoff
_U = 2.0 ** -24


def split_gap(coef: torch.Tensor, beta: float) -> torch.Tensor:
    """Per row of ``coef`` ((B, N), N = K << cmax entries), float32 (B,) on
    its device: ``2 e_b``, with ``e_b = gamma_{N+1} |beta| sum |coef_b|``
    and ``gamma_k = k u / (1 - k u)``, widened by 2^-20 for its own
    rounding: how far the split's value of a state can lie from the
    chain's. The two sum the same held entries of row b in two orders,
    each result within ``gamma_N sum |coef_b|`` of the exact sum (an add
    rounds only where both operands are nonzero, at most N - 1 times on a
    path; the split's float64 sums round to float32 once in place of at
    least one such add, their own float64 error far inside the widening),
    and ``beta`` rounds once more: each value lies within ``e_b`` of the
    exact one, and the two within ``2 e_b`` of each other. No host
    synchronisation."""
    g = (coef.shape[-1] + 1) * _U
    scale = 2 * g / (1 - g) * abs(beta) * (1 + 2.0 ** -20)
    return (coef.double().abs().sum(dim=-1) * scale).float()


def map_tolerance(coef: torch.Tensor, beta: float) -> torch.Tensor:
    """``2 * split_gap`` (``4 e_b``) per row: a state of the chain's
    maximum has a split value within it of the split's maximum (its split
    value lies within ``2 e_b`` of its chain value, which is at or above
    the chain value of the split's best state, itself within ``2 e_b`` of
    that state's split value)."""
    return 2 * split_gap(coef, beta)


def _threshold(M: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """``M - tol`` rounded down in float32 (``__fsub_rd``)."""
    t = M - tol
    over = t.double() > M.double() - tol.double()
    return torch.where(over, torch.nextafter(t, torch.full_like(
        t, -math.inf)), t)


def map_partials_split_reference(cliques: tuple, n: int, coef: torch.Tensor,
                                 beta: float, parts=None, candidates=None,
                                 L: int = None):
    """Plain PyTorch version of ``map_kernel``'s algorithm, on any device:
    the split's values of every sub-block of each block of
    ``lse_geometry`` (:func:`split_log_potentials_reference`); a running
    maximum ``M`` over the block's sub-blocks; the chain (``_clique_sum``
    times ``beta``) at every state whose split value is at least
    ``M - map_tolerance`` rounded down; of those, the best chain value and
    the earliest id holding it. Equal to :func:`map_partials_reference`.
    ``parts`` picks blocks (all by default; outputs ``(B, len(parts))``);
    ``candidates``, an int64 tensor of the outputs' shape, receives each
    block's chain evaluations; ``L`` (default ``split_bits(n)``, the
    kernel's) sets the sub-blocks."""
    dev = coef.device
    B = coef.shape[0]
    n_parts, per_part = lse_geometry(1 << n)
    L = split_bits(n) if L is None else L
    subs = per_part >> L
    sel = torch.as_tensor(range(n_parts) if parts is None else parts,
                          dtype=torch.int64, device=dev)
    h = (sel[:, None] * subs + torch.arange(subs, device=dev)).reshape(-1)
    v = split_log_potentials_reference(
        split_plan(cliques, n, L), coef, beta, h).reshape(
            B, len(sel), subs, 1 << L)
    M = v.amax(dim=-1).cummax(dim=-1).values
    T = _threshold(M, map_tolerance(coef, beta)[:, None, None])
    b, p, i, xl = torch.nonzero(v >= T[..., None], as_tuple=True)
    ids = ((sel[p] * subs + i) << L) | xl
    val = torch.empty(ids.shape, dtype=torch.float32, device=dev)
    for r in range(B):
        at = b == r
        val[at] = _clique_sum(cliques, n, coef[r:r + 1], ids[at])[0] * beta
    key = b * len(sel) + p
    best = torch.full((B * len(sel),), -math.inf, device=dev).scatter_reduce(
        0, key, val, "amax")
    top = val == best[key]
    first = torch.full((B * len(sel),), _NO_STATE, dtype=torch.int64,
                       device=dev).scatter_reduce(0, key[top], ids[top],
                                                  "amin")
    if candidates is not None:
        candidates.copy_(torch.bincount(key, minlength=B * len(sel))
                         .reshape(B, len(sel)))
    return best.reshape(B, -1), first.reshape(B, -1)


def map_partials(cliques: tuple, n: int, coef: torch.Tensor, beta: float,
                 candidates: torch.Tensor = None, x0_blocks: int = 0,
                 blocks: int = None):
    """Per-block best value of ``beta * theta^T phi(x)`` over all ``2**n``
    states and the earliest state id that holds it, for every row of
    ``coef``: float32 and int64 (B, parts) tensors (``lse_geometry`` gives
    ``parts``), the chain's values (:func:`map_partials_reference` bit for
    bit). :func:`combine_map` finishes. No table is written: on the card
    the states are screened through the split and the chain evaluates the
    candidates (``map_kernel``), at most ``MAX_LAUNCH_ROWS`` rows a launch,
    each row the same in any launch. ``candidates``, an int64 (B, parts)
    tensor, receives each block's candidates; on a CPU tensor it makes the
    plain version that of the split algorithm
    (:func:`map_partials_split_reference`). ``x0_blocks`` and ``blocks``
    sweep only those blocks of a :func:`sweep_range` ((B, blocks); ids
    stay absolute)."""
    _build.refuse_grad(coef, "coef")
    if coef.device.type == "cpu":
        if candidates is None:
            return map_partials_reference(cliques, n, coef, beta, x0_blocks,
                                          blocks)
        x0, count, _ = sweep_range(n, x0_blocks, blocks)
        return map_partials_split_reference(
            cliques, n, coef, beta, parts=range(x0, x0 + count),
            candidates=candidates)
    dev = coef.device
    L = split_bits(n)
    B = coef.shape[0]
    shifts, sizes, _, K, cmax = _build.structure_args(
        cliques, n, coef[:MAX_LAUNCH_ROWS],
        extra=split_shared_bytes(split_plan(cliques, n, L))
        + _MAP_STATIC_BYTES)
    _build.check(coef, "coef", torch.float32, (B, K << cmax), dev)
    _, tables = _device_plan(cliques, n, L, dev)
    x0, parts, per_part = sweep_range(n, x0_blocks, blocks)
    if candidates is not None:
        _build.check(candidates, "candidates", torch.int64, (B, parts), dev)
    tol = map_tolerance(coef, beta)
    v = torch.empty((B, parts), dtype=torch.float32, device=dev)
    x = torch.empty((B, parts), dtype=torch.int64, device=dev)
    # grid.y holds a launch's rows: at most MAX_LAUNCH_ROWS a launch
    for lo in range(0, B, MAX_LAUNCH_ROWS):
        rows = slice(lo, min(B, lo + MAX_LAUNCH_ROWS))
        _build.launch("qcmrf_map", dev, tables, _build.ptr(coef[rows]),
                      _build.ptr(shifts), _build.ptr(sizes),
                      rows.stop - lo, K, cmax, per_part, x0, parts, beta,
                      _build.ptr(tol[rows]), _build.ptr(v[rows]),
                      _build.ptr(x[rows]),
                      _build.ptr(candidates[rows]) if candidates is not None
                      else _build.ctypes.c_void_p(0))
        LAUNCHES["map"] += 1
    return v, x


def combine_map(v: torch.Tensor, x: torch.Tensor):
    """(best value, earliest id holding it) along the last axis of the
    per-block partials."""
    best = v.amax(dim=-1, keepdim=True)
    return best[..., 0], torch.where(v == best, x, _NO_STATE).amin(dim=-1)


def map_state_streaming(mrf: MRF):
    """Exact MAP state by the streaming argmax, no table: ``(state_id,
    beta * theta^T phi(x))`` as host numbers, the chain's maximum with the
    earliest id of equal maxima. On the CPU below ``MIN_KERNEL_N``
    variables it takes the dense argmax of the chain's table (which also
    keeps the first maximum); on the card the map kernel serves every n,
    since the card's table is the split's."""
    if mrf.n < MIN_KERNEL_N and mrf.device.type == "cpu":
        lp = mrf.beta * mrf.all_log_potentials()
        i = int(torch.argmax(lp))
        return i, float(lp[i])
    coef = moebius_coefficients(mrf)[None]
    v, x = combine_map(*map_partials(mrf.cliques, mrf.n, coef, mrf.beta))
    return int(x[0]), float(v[0])


def monomial_moments_reference(cliques: tuple, n: int, coef: torch.Tensor,
                               beta: float, lnz: torch.Tensor,
                               masks: torch.Tensor, x0_blocks: int = 0,
                               blocks: int = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`monomial_moments` by the chain, on
    any device: the table's weights summed in float64 over each
    monomial's states. The CPU route; with float64 coefficients (the chain
    in float64), the card's oracle."""
    x = _range_ids(n, x0_blocks, blocks, coef.device)
    lp = logpot_table_reference(cliques, n, coef, beta, False, x0_blocks,
                                blocks)
    w = torch.exp(lp - lnz[:, None]).double()
    chunk = max(1, (1 << 24) // x.numel())
    out = []
    for s in range(0, masks.numel(), chunk):
        mk = masks[s:s + chunk]
        out.append(w @ ((x[:, None] & mk) == mk).double())
    return torch.cat(out, dim=-1)


def monomial_moments_split_reference(cliques: tuple, n: int,
                                     coef: torch.Tensor, beta: float,
                                     lnz: torch.Tensor,
                                     masks: torch.Tensor, x0_blocks: int = 0,
                                     blocks: int = None) -> torch.Tensor:
    """Plain PyTorch version of the moments kernel's algorithm, on any
    device: :func:`split_log_potentials_reference` over every sub-block,
    the weights ``exp(v - lnz)``, :func:`split_moment_sums_reference` per
    block of ``lse_geometry`` (float32, in the kernel's order), the blocks
    added in float64 as the wrapper adds them: float64 (B, m)."""
    L = split_bits(n)
    per_part = lse_geometry(1 << n)[1]
    subs = _range_sub_blocks(n, L, x0_blocks, blocks)
    v = split_log_potentials_reference(split_plan(cliques, n, L), coef,
                                       beta, subs)
    w = torch.exp(v - lnz[:, None, None])
    return split_moment_sums_reference(w, L, subs, masks,
                                       per_part >> L).sum(
                                           dim=1, dtype=torch.float64)


def moments_per_launch(cliques: tuple, n: int) -> int:
    """Most monomials one launch of ``lnz_moments_kernel`` (either form)
    takes: as many masks and sums as a block's shared memory holds beside
    :func:`lnz_moments_reserve`."""
    return ((_build.SHARED_BYTES_LIMIT - lnz_moments_reserve(cliques, n))
            // _MOMENT_BYTES)


def _block_mask_sums(w: torch.Tensor, x: torch.Tensor,
                     masks: torch.Tensor) -> torch.Tensor:
    """Per block, ``w`` (B, blocks, per_part) summed over the states ``x``
    (blocks, per_part) of each monomial mask, in float64: (B, blocks, m)."""
    chunk = max(1, (1 << 24) // x.numel())
    out = []
    for s in range(0, masks.numel(), chunk):
        mk = masks[s:s + chunk, None, None]
        out.append(torch.einsum("bpl,cpl->bpc", w.double(),
                                ((x & mk) == mk).double()))
    return torch.cat(out, dim=-1)


def monomial_moment_partials_reference(cliques: tuple, n: int,
                                       coef: torch.Tensor, beta: float,
                                       lnz: torch.Tensor,
                                       masks: torch.Tensor,
                                       x0_blocks: int = 0,
                                       blocks: int = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`monomial_moment_partials` by the
    chain, on any device: each block's weights ``exp(v - lnz)`` summed in
    float64 over each monomial's states, rounded to float32."""
    lp, _ = _block_table(cliques, n, coef, beta, x0_blocks, blocks)
    x = _range_ids(n, x0_blocks, blocks, coef.device).reshape(lp.shape[1:])
    return _block_mask_sums(torch.exp(lp - lnz[:, None, None]), x,
                            masks).float()


def monomial_moment_partials(cliques: tuple, n: int, coef: torch.Tensor,
                             beta: float, lnz: torch.Tensor,
                             masks: torch.Tensor, x0_blocks: int = 0,
                             blocks: int = None) -> torch.Tensor:
    """The moments kernel's per-block sums, float32 (B, blocks, m), of a
    :func:`sweep_range`: one launch for every :func:`moments_per_launch`
    monomials, each ``lnz_moments_kernel`` with ``lnz`` given (on a CPU
    tensor, :func:`monomial_moment_partials_reference`).
    :func:`monomial_moments` adds them in float64."""
    _build.refuse_grad(coef, "coef")
    if coef.device.type == "cpu":
        return monomial_moment_partials_reference(cliques, n, coef, beta,
                                                  lnz, masks, x0_blocks,
                                                  blocks)
    dev = coef.device
    m = masks.numel()
    step = moments_per_launch(cliques, n)
    if step < 1:
        raise ValueError("the split plan leaves no shared memory for a "
                         "monomial")
    plan = split_plan(cliques, n, split_bits(n))
    tables, B, x0, parts, per_part = _split_args(
        cliques, n, coef,
        split_shared_bytes(plan, min(m, step)) + _LNZ_STATIC_BYTES,
        x0_blocks, blocks)
    _build.check(lnz, "lnz", torch.float32, (B,), dev)
    _build.check(masks, "masks", torch.int64, (m,), dev)
    out = torch.empty((B, parts, m), dtype=torch.float32, device=dev)
    for lo in range(0, m, step):
        hi = min(m, lo + step)
        part = out if (lo, hi) == (0, m) else torch.empty(
            (B, parts, hi - lo), dtype=torch.float32, device=dev)
        _build.launch("qcmrf_moments", dev, tables, _build.ptr(coef), B,
                      coef.shape[1], per_part, x0, parts, beta,
                      _build.ptr(lnz), _build.ptr(masks[lo:hi]), hi - lo,
                      _build.ptr(part))
        LAUNCHES["moments"] += 1
        if part is not out:
            out[:, :, lo:hi] = part
    return out


def monomial_moments(cliques: tuple, n: int, coef: torch.Tensor,
                     beta: float, lnz: torch.Tensor,
                     masks: torch.Tensor, x0_blocks: int = 0,
                     blocks: int = None) -> torch.Tensor:
    """``E_p[prod_{v in S} x_v]`` for every monomial ``S`` and every row of
    ``coef``, with ``p(x) = exp(beta * theta^T phi(x) - lnz)``: float64
    (B, m). ``lnz`` is float32 (B,); ``masks`` int64 (m,), monomial ``S``
    as the state-id bits of its variables (it holds at ``x`` iff ``(x &
    mask) == mask``). One sweep of the states for every
    :func:`moments_per_launch` monomials, no table; on the card the split
    and its superset sums (``lnz_moments_kernel`` with ``lnz`` given,
    :func:`monomial_moments_split_reference`'s algorithm); the float32
    per-block partials (:func:`monomial_moment_partials`) are added in
    float64. ``x0_blocks`` and ``blocks`` sum only the states of a
    :func:`sweep_range`."""
    _build.refuse_grad(coef, "coef")
    if coef.device.type == "cpu":
        return monomial_moments_reference(cliques, n, coef, beta, lnz,
                                          masks, x0_blocks, blocks)
    return monomial_moment_partials(cliques, n, coef, beta, lnz, masks,
                                    x0_blocks, blocks).sum(
                                        dim=1, dtype=torch.float64)


# --------------------------------------------------------------------------
# Fused lnZ + monomial moments: one sweep by running max
# --------------------------------------------------------------------------


def lnz_moments_partials_reference(cliques: tuple, n: int,
                                   coef: torch.Tensor, beta: float,
                                   masks: torch.Tensor, x0_blocks: int = 0,
                                   blocks: int = None):
    """Plain PyTorch version of one launch of
    :func:`lnz_moments_partials`, on any device: the table cut into the
    sweep's blocks, each block's max ``M_b``, and its weights ``exp(v -
    M_b)`` summed in float64 over each monomial's states."""
    lp, _ = _block_table(cliques, n, coef, beta, x0_blocks, blocks)
    M = lp.amax(dim=-1)
    w = torch.where(lp == -math.inf, 0.0, torch.exp(lp - M[..., None]))
    x = _range_ids(n, x0_blocks, blocks, coef.device).reshape(lp.shape[1:])
    return M, _block_mask_sums(w, x, masks).float()


def lnz_moments_reserve(cliques: tuple, n: int) -> int:
    """Shared memory of ``lnz_moments_kernel`` beside its masks and sums:
    the split's tables, ``P`` and ``W``, and its static bytes."""
    plan = split_plan(cliques, n, split_bits(n))
    return (split_shared_bytes(plan, 1) - _MOMENT_BYTES
            + _LNZ_STATIC_BYTES)


def _lnz_moments_launch(cliques: tuple, n: int, coef: torch.Tensor,
                        beta: float, masks: torch.Tensor, x0_blocks: int = 0,
                        blocks: int = None):
    """One launch of ``lnz_moments_kernel``: the (M, S) partials of
    :func:`lnz_moments_partials_reference` for a mask list that fits."""
    dev = coef.device
    m = masks.numel()
    plan = split_plan(cliques, n, split_bits(n))
    tables, B, x0, parts, per_part = _split_args(
        cliques, n, coef, split_shared_bytes(plan, m) + _LNZ_STATIC_BYTES,
        x0_blocks, blocks)
    _build.check(masks, "masks", torch.int64, (m,), dev)
    M = torch.empty((B, parts), dtype=torch.float32, device=dev)
    S = torch.empty((B, parts, m), dtype=torch.float32, device=dev)
    _build.launch("qcmrf_lnz_moments", dev, tables, _build.ptr(coef), B,
                  coef.shape[1], per_part, x0, parts, beta,
                  _build.ptr(masks), m, _build.ptr(M), _build.ptr(S))
    LAUNCHES["lnz_moments"] += 1
    return M, S


def lnz_moments_partials(cliques: tuple, n: int, coef: torch.Tensor,
                         beta: float, masks: torch.Tensor, x0_blocks: int = 0,
                         blocks: int = None):
    """One sweep of all ``2**n`` states, no table and no lnZ needed:
    per block ``b`` of states (``lse_geometry``), the running max ``M_b``
    of ``v = beta * theta^T phi(x)`` and, per monomial ``g``, ``S_b[g] =
    sum exp(v - M_b)`` over the block's states holding it, for every row
    of ``coef``: float32 ``(B, parts)`` and ``(B, parts, m)``.
    :func:`combine_lnz_moments` finishes.

    ``masks`` is int64 (m,) as for :func:`monomial_moments`, and
    ``masks[0]`` must be 0, the empty monomial, whose sum is the block's
    scaled Z (checked for a CPU list; :func:`moebius.monomial_masks`
    gives such a list). A list longer than :func:`moments_per_launch` takes is
    split over launches: every launch takes mask 0 too and scales its own
    columns, block by block, by its own scaled Z onto the first launch's
    (``S_0[0] / S_j[0]``), so no two launches need to agree on ``M_b``.
    On a CUDA tensor each launch is ``lnz_moments_kernel``; on a CPU
    tensor the plain version. ``x0_blocks`` and ``blocks`` sweep only
    those blocks of a :func:`sweep_range`: ``(B, blocks)`` and ``(B,
    blocks, m)``, the whole sweep's partials of those blocks."""
    _build.refuse_grad(coef, "coef")
    m = masks.numel()
    # a mask list on the card is not read back (a sync a step):
    # moebius.monomial_masks puts the empty monomial first
    if m == 0 or (masks.device.type == "cpu" and int(masks[0]) != 0):
        raise ValueError("masks[0] must be 0, the empty monomial")
    run = (lnz_moments_partials_reference if coef.device.type == "cpu"
           else _lnz_moments_launch)
    step = moments_per_launch(cliques, n)
    if step < 2:
        raise ValueError(f"a launch takes {step} monomials; it needs 2")
    M, S = run(cliques, n, coef, beta, masks[:step], x0_blocks, blocks)
    cols = [S]
    for lo in range(step, m, step - 1):
        _, Sj = run(cliques, n, coef, beta,
                    torch.cat([masks[:1], masks[lo:lo + step - 1]]),
                    x0_blocks, blocks)
        z = Sj[..., :1]
        cols.append(Sj[..., 1:] * torch.where(z > 0, S[..., :1] / z, 0.0))
    return M, torch.cat(cols, dim=-1)


def combine_lnz_moments(M: torch.Tensor, S: torch.Tensor):
    """``(lnZ, E_p[monomials])`` in float64 from the partials of
    :func:`lnz_moments_partials`: ``M* = max_b M_b``, ``Z e^{-M*} = sum_b
    e^{M_b - M*} S_b[0]``, ``lnZ = M* + log(Z e^{-M*})`` and ``E_p[g] =
    sum_b e^{M_b - M*} S_b[g] / (Z e^{-M*})``; shapes (B,) and (B, m). A
    block with ``M_b = -inf`` weighs 0."""
    M, S = M.double(), S.double()
    top = M.amax(dim=-1, keepdim=True)
    w = torch.exp(M - top)[..., None]
    sums = (w * S).sum(dim=-2)
    z = sums[..., :1]
    return top[..., 0] + torch.log(z[..., 0]), sums / z


def lnz_and_moments(cliques: tuple, n: int, theta: torch.Tensor,
                    beta: float):
    """``(lnZ, E_p[phi])`` of the model ``(cliques, n, theta, beta)`` in one
    fused sweep (:func:`lnz_moments_partials` over the structure's
    monomial basis, :func:`combine_lnz_moments`, then the inverse-Moebius
    doubling onto the theta layout), both in ``theta``'s dtype on its
    device."""
    masks = moebius.device_masks(cliques, n, theta.device)
    coef = coefficient_table(cliques, n, theta)[None]
    lnz, mono = combine_lnz_moments(
        *lnz_moments_partials(cliques, n, coef, beta, masks))
    return (lnz[0].to(theta.dtype),
            moebius.masks_from_monomials(mono[0], cliques).to(theta.dtype))


class _LogPartition(torch.autograd.Function):
    """ln Z of ``theta`` whose backward is ``beta * E_p[phi] * g``: the
    forward's fused sweep computes ln Z and the moments together and saves
    the moments. ``beta`` is a host constant (no gradient), as in the JAX
    package's custom VJP."""

    @staticmethod
    def forward(ctx, theta, cliques, n, beta):
        lnz, mu = lnz_and_moments(cliques, n, theta.detach(), beta)
        ctx.save_for_backward(mu)
        ctx.beta = beta
        return lnz

    @staticmethod
    def backward(ctx, g):
        (mu,) = ctx.saved_tensors
        return ctx.beta * mu * g, None, None, None


# --------------------------------------------------------------------------
# Float32 FMA chain: the compute peak the float kernels are held against
# --------------------------------------------------------------------------

#: FMAs in each chain of ``fma_peak_kernel`` in the rate run (bench.py's)
FMA_CHAIN = 1024


def fma_chain_max_reference(x: torch.Tensor, b: float = 1e-9,
                            steps: int = FMA_CHAIN, out=None):
    """Plain PyTorch version of :func:`fma_chain_max`, on any device and in
    ``x``'s dtype (float64 makes it the oracle of a short chain)."""
    y = x.clone()
    for _ in range(steps):
        y.mul_(y).add_(b)
    if out is not None:
        out.copy_(y)
    return y.max()


# --------------------------------------------------------------------------
# H·D·H sandwich passes on real/imaginary planes
# --------------------------------------------------------------------------

#: most ancillas one sandwich pass takes
_MAX_SANDWICH_K = 7
#: most terms (all profiles of one pass together) the kernels' shared-memory
#: table holds: 24 bytes each
MAX_SANDWICH_TERMS = 1024

_PROFILE_DTYPE = np.dtype([("c", "<f4"), ("s", "<f4"), ("begin", "<i4"),
                           ("end", "<i4")])
_TERM_DTYPE = np.dtype([("care", "<u8"), ("want", "<u8"), ("c", "<f4"),
                        ("s", "<f4")])


def _lane_gate_matrix(U: np.ndarray, q: int) -> np.ndarray:
    """Embed a 2x2 gate on lane-qubit q (< 7) as a 128x128 matrix:
    I_{2^(6-q)} ⊗ U ⊗ I_{2^q} (the planner's ``lane`` op)."""
    return np.kron(
        np.kron(np.eye(1 << (6 - q)), U), np.eye(1 << q)
    ).astype(U.dtype)


def _canon_terms(ts):
    return tuple(
        tuple((int(p), int(w)) for p, w in conds) for conds in ts
    )


def _profile(terms, angles, base):
    terms = _canon_terms(terms)
    angles = tuple(float(a) for a in angles)
    if len(terms) != len(angles):
        raise ValueError(f"{len(terms)} terms but {len(angles)} angles")
    return terms, angles, float(base)


def plane_qubits(re: torch.Tensor, im: torch.Tensor) -> int:
    """Qubit count of a pair of planes; raises unless both are contiguous
    float32 tensors of one shape, on one device, with 2**nq values."""
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("re and im planes differ in shape or device")
    for t, name in ((re, "re"), (im, "im")):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} plane has dtype {t.dtype}, expected "
                             "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} plane is not contiguous")
    size = re.numel()
    if size < 2 or size & (size - 1):
        raise ValueError(f"planes hold {size} values, not a power of two")
    return size.bit_length() - 1


def _check_terms(nq: int, profiles, ancillas=range(0)) -> None:
    """Raises unless every condition names one of ``nq`` qubits, outside
    ``ancillas``, and a bit, and the terms fit the kernels' table."""
    n_terms = sum(len(terms) for terms, _, _ in profiles)
    if n_terms > MAX_SANDWICH_TERMS:
        raise ValueError(f"{n_terms} terms in one pass; the kernels take "
                         f"at most {MAX_SANDWICH_TERMS}")
    for terms, _, _ in profiles:
        for conds in terms:
            for p, w in conds:
                if not 0 <= p < nq or w not in (0, 1):
                    raise ValueError(f"condition ({p}, {w}) outside {nq} "
                                     "qubits or not a bit")
                if p in ancillas:
                    raise ValueError(f"a term conditions on ancilla {p} "
                                     "of its own pass")


def _check_pass(nq: int, a_lo: int, k: int, profiles) -> None:
    if not 1 <= k <= _MAX_SANDWICH_K:
        raise ValueError(f"{k} ancillas; a sandwich pass takes 1.."
                         f"{_MAX_SANDWICH_K}")
    if a_lo < 0 or a_lo + k > nq:
        raise ValueError(f"ancillas {a_lo}..{a_lo + k - 1} outside "
                         f"{nq} qubits")
    _check_terms(nq, profiles, range(a_lo, a_lo + k))


def _profile_table(profiles, device: torch.device):
    """``(table, n_terms)``: the profiles as the kernels read them (the
    record layout of ``csrc/circuit_kernels.cu``), on ``device``. The
    trig of every base and angle is taken in float64 on the host."""
    prof = np.zeros(len(profiles), _PROFILE_DTYPE)
    rows = []
    for i, (terms, angles, base) in enumerate(profiles):
        prof[i] = (math.cos(base), math.sin(base), len(rows),
                   len(rows) + len(terms))
        for conds, a in zip(terms, angles):
            care = want = 0
            dead = False
            for p, w in conds:
                bit = 1 << p
                dead |= bool(care & bit) and bool(want & bit) != bool(w)
                care |= bit
                want |= bit if w else 0
            if dead:  # contradictory conditions: never holds
                care, want = 0, 1
            rows.append((care, want, math.cos(a), math.sin(a)))
    terms = np.array(rows, _TERM_DTYPE)
    blob = prof.tobytes() + terms.tobytes()
    return _device_bytes(blob, device), len(rows)


@functools.lru_cache(maxsize=64)
def _uploaded(blob: bytes, device: torch.device):
    """``(copy, event)``: a device copy of ``blob`` that leaves from pinned
    host memory without waiting, and the event recorded after it on the
    stream that made it (None off CUDA)."""
    host = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    if device.type != "cuda":
        return host.to(device), None
    copy = host.pin_memory().to(device, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return copy, done


def _device_bytes(blob: bytes, device: torch.device) -> torch.Tensor:
    """A read-only device copy of ``blob``, kept so that a repeated pass
    does not copy again; a stream of passes with new tables never stalls
    the host on the card. The current stream waits for the upload's event
    (another stream may have made the copy: a shard's of the sharded
    engine) and is noted as a user of the copy for the allocator."""
    copy, done = _uploaded(blob, device)
    if done is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        copy.record_stream(stream)
    return copy


def _anchor_ids(nq: int, a_lo: int, k: int, device) -> torch.Tensor:
    """Indices with the k ancilla bits zero, shaped (hi, 2**a_lo)."""
    hi = torch.arange(1 << (nq - a_lo - k), dtype=torch.int64,
                      device=device)
    lo = torch.arange(1 << a_lo, dtype=torch.int64, device=device)
    return (hi[:, None] << (a_lo + k)) | lo[None, :]


def _profile_cos_sin(profile, x: torch.Tensor):
    """(cos, sin) of a profile at ids ``x``, angle summed in float64."""
    terms, angles, base = profile
    ang = torch.full(x.shape, base, dtype=torch.float64, device=x.device)
    for conds, a in zip(terms, angles):
        hold = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        for p, w in conds:
            hold &= ((x >> p) & 1) == w
        ang += a * hold
    return torch.cos(ang).float(), torch.sin(ang).float()


def _multi_reference(re, im, a_lo: int, nus, mu):
    """Plain PyTorch form of every sandwich pass: e^{i mu} prod_t
    e^{-i nu_t X_{a_lo+t}} on the planes, in place."""
    nq = plane_qubits(re, im)
    k = len(nus)
    x0 = _anchor_ids(nq, a_lo, k, re.device)
    hi, S = x0.shape
    v = torch.complex(re.reshape(hi, 1 << k, S), im.reshape(hi, 1 << k, S))
    for b, nu in enumerate(nus):
        c, s = _profile_cos_sin(nu, x0)
        c = c[:, None, None, :]
        s = s[:, None, None, :]
        v = v.reshape(hi, 1 << (k - 1 - b), 2, 1 << b, S)
        v0, v1 = v[:, :, 0], v[:, :, 1]
        v = torch.stack((c * v0 - 1j * s * v1, c * v1 - 1j * s * v0), dim=2)
    cm, sm = _profile_cos_sin(mu, x0)
    v = v.reshape(hi, 1 << k, S) * torch.complex(cm, sm)[:, None, :]
    re.copy_(v.real.reshape(re.shape))
    im.copy_(v.imag.reshape(im.shape))
    return re, im


def apply_hdh_sandwich_reference(re, im, anc: int, nu_terms, nu_angles,
                                 nu_base: float = 0.0, mu_terms=(),
                                 mu_angles=(), mu_base: float = 0.0):
    """Plain PyTorch version of :func:`apply_hdh_sandwich`, any device."""
    nu = _profile(nu_terms, nu_angles, nu_base)
    mu = _profile(mu_terms, mu_angles, mu_base)
    _check_pass(plane_qubits(re, im), anc, 1, (nu, mu))
    return _multi_reference(re, im, anc, (nu,), mu)


def apply_hdh_sandwich(re, im, anc: int, nu_terms, nu_angles,
                       nu_base: float = 0.0, mu_terms=(), mu_angles=(),
                       mu_base: float = 0.0):
    """Apply H(anc)·D·H(anc) in one pass, **in place**; returns the planes.

    ``D`` is given by its half-sum / half-difference phase profiles:
    ``mu(x) = mu_base + sum_t mu_angles[t] * [mu_terms[t] holds]`` (the
    common phase) and ``nu(x)`` likewise (the anc=1 minus anc=0
    half-difference), so the pass is ``e^{i mu} e^{-i nu X_anc}``: the
    multi pass at k = 1.
    """
    return apply_hdh_sandwich_multi(re, im, anc, (nu_terms,), (nu_angles,),
                                    (nu_base,), mu_terms, mu_angles, mu_base)


def _multi_profiles(nu_terms_k, nu_angles_k, nu_bases_k, mu_terms,
                    mu_angles, mu_base):
    if not len(nu_terms_k) == len(nu_angles_k) == len(nu_bases_k):
        raise ValueError("nu terms, angles and bases differ in count")
    nus = tuple(_profile(t, a, b) for t, a, b in
                zip(nu_terms_k, nu_angles_k, nu_bases_k))
    return nus, _profile(mu_terms, mu_angles, mu_base)


def apply_hdh_sandwich_multi_reference(re, im, anc_lo: int, nu_terms_k,
                                       nu_angles_k, nu_bases_k,
                                       mu_terms=(), mu_angles=(),
                                       mu_base=0.0):
    """Plain PyTorch version of :func:`apply_hdh_sandwich_multi`."""
    nus, mu = _multi_profiles(nu_terms_k, nu_angles_k, nu_bases_k,
                              mu_terms, mu_angles, mu_base)
    _check_pass(plane_qubits(re, im), anc_lo, len(nus), nus + (mu,))
    return _multi_reference(re, im, anc_lo, nus, mu)


def apply_hdh_sandwich_multi(re, im, anc_lo: int, nu_terms_k, nu_angles_k,
                             nu_bases_k, mu_terms=(), mu_angles=(),
                             mu_base=0.0):
    """Apply k H(a+t)·D_t·H(a+t) blocks (t = 0..k-1, a = anc_lo) in one
    pass, **in place**; returns the planes.

    ``nu_terms_k[t]`` / ``nu_angles_k[t]`` / ``nu_bases_k[t]`` describe
    ancilla ``anc_lo + t``'s half-difference profile; ``mu`` is the
    combined common-phase profile of all k sandwiches. No term may
    condition on any of the k ancillas; ``k <= 7``.
    """
    nus, mu = _multi_profiles(nu_terms_k, nu_angles_k, nu_bases_k,
                              mu_terms, mu_angles, mu_base)
    nq = plane_qubits(re, im)
    k = len(nus)
    _check_pass(nq, anc_lo, k, nus + (mu,))
    if re.device.type == "cpu":
        return _multi_reference(re, im, anc_lo, nus, mu)
    table, n_terms = _profile_table((mu,) + nus, re.device)
    _build.launch("qcmrf_hdh_multi", re.device, _build.ptr(table), n_terms,
                  k, _build.ptr(re), _build.ptr(im), (1 << nq) >> k,
                  int(anc_lo))
    LAUNCHES["hdh_multi"] += 1
    return re, im


def apply_hdh_sandwich_pair(re, im, anc_lo: int,
                            nu1_terms, nu1_angles, nu1_base,
                            nu2_terms, nu2_angles, nu2_base,
                            mu_terms=(), mu_angles=(), mu_base=0.0):
    """H(a)·D1·H(a) and H(a+1)·D2·H(a+1) in one pass (a = anc_lo), in
    place: the multi pass at k = 2. ``mu`` is the combined common-phase
    profile of both sandwiches."""
    return apply_hdh_sandwich_multi(
        re, im, anc_lo, (nu1_terms, nu2_terms), (nu1_angles, nu2_angles),
        (nu1_base, nu2_base), mu_terms, mu_angles, mu_base)


def apply_hdh_sandwich_quad(re, im, anc_lo: int, nu_terms4, nu_angles4,
                            nu_bases4, mu_terms=(), mu_angles=(),
                            mu_base=0.0):
    """Four adjacent-ancilla sandwiches in one pass, in place: the multi
    pass at k = 4."""
    if len(nu_terms4) != 4:
        raise ValueError(f"{len(nu_terms4)} profiles; a quad takes 4")
    return apply_hdh_sandwich_multi(re, im, anc_lo, nu_terms4, nu_angles4,
                                    nu_bases4, mu_terms, mu_angles,
                                    mu_base)


def plane_shape(num_qubits: int):
    """Shape of a plane of ``2**num_qubits`` values: ``(2**nq / 128,
    128)`` from 7 qubits on, the JAX package's layout."""
    if num_qubits >= 7:
        return ((1 << num_qubits) // 128, 128)
    return (1, 1 << num_qubits)


def _uniform_amp(folded, carrier: float) -> float:
    """The uniform state's amplitude ``2^{-|folded|/2}`` in float32, times
    ``carrier`` in float32 (JAX's ``amp * carrier``)."""
    return float(np.float32(2.0 ** (-0.5 * len(folded)))
                 * np.float32(carrier))


def uniform_planes(num_qubits: int, folded, out=None, device=None,
                   carrier: float = 1.0):
    """Planes of ``carrier * H^{folded}|0...0>``: amplitude ``carrier *
    2^{-|folded|/2}`` where every bit outside ``folded`` is 0, else 0.
    Written into ``out`` (a pair of planes) in place when given, else into
    new planes on ``device`` (the current CUDA device unless one is
    named). The sharded engine's shards take the rest of the global
    uniform amplitude as ``carrier``, 0 on a shard the state does not
    reach."""
    re, im = _output_planes(num_qubits, out, device)
    re.zero_()
    im.zero_()
    idx = torch.zeros(1, dtype=torch.int64, device=re.device)
    for q in sorted(set(folded)):
        idx = torch.cat([idx, idx + (1 << q)])
    re.view(-1)[idx] = _uniform_amp(folded, carrier)
    return re, im


def _uniform_args(num_qubits, folded, anc_lo, nu_terms_k, nu_angles_k,
                  nu_bases_k, mu_terms, mu_angles, mu_base):
    nus, mu = _multi_profiles(nu_terms_k, nu_angles_k, nu_bases_k,
                              mu_terms, mu_angles, mu_base)
    k = len(nus)
    _check_pass(num_qubits, anc_lo, k, nus + (mu,))
    folded = tuple(int(q) for q in folded)
    if any(anc_lo <= q < anc_lo + k for q in folded):
        raise ValueError("the folded qubits hold one of the pass's ancillas")
    if any(not 0 <= q < num_qubits for q in folded):
        raise ValueError(f"folded qubits {folded} outside {num_qubits}")
    return nus, mu, folded


def _output_planes(num_qubits, out, device):
    if out is None:
        shape = plane_shape(num_qubits)
        device = resolve_device(device)
        return (torch.empty(shape, dtype=torch.float32, device=device),
                torch.empty(shape, dtype=torch.float32, device=device))
    if plane_qubits(*out) != num_qubits:
        raise ValueError(f"output planes do not hold {num_qubits} qubits")
    return out


def apply_hdh_sandwich_multi_uniform_reference(
        num_qubits: int, folded, anc_lo: int, nu_terms_k, nu_angles_k,
        nu_bases_k, mu_terms=(), mu_angles=(), mu_base=0.0, out=None,
        device=None, carrier: float = 1.0):
    """Plain PyTorch version of :func:`apply_hdh_sandwich_multi_uniform`:
    the uniform planes, then the read-write pass."""
    nus, mu, folded = _uniform_args(num_qubits, folded, anc_lo, nu_terms_k,
                                    nu_angles_k, nu_bases_k, mu_terms,
                                    mu_angles, mu_base)
    re, im = uniform_planes(num_qubits, folded,
                            _output_planes(num_qubits, out, device),
                            carrier=carrier)
    return _multi_reference(re, im, anc_lo, nus, mu)


def apply_hdh_sandwich_multi_uniform(num_qubits: int, folded, anc_lo: int,
                                     nu_terms_k, nu_angles_k, nu_bases_k,
                                     mu_terms=(), mu_angles=(), mu_base=0.0,
                                     out=None, device=None,
                                     carrier: float = 1.0):
    """k sandwiches applied to the uniform H-wall state ``carrier *
    H^{folded}|0>`` (the planner's ``fold_uniform_prefix`` fold followed
    by :func:`apply_hdh_sandwich_multi`) in one write-only pass, without
    making the uniform planes. Writes into ``out`` (a pair of planes,
    whatever they hold) when given, else into new planes on ``device``
    (the current CUDA device unless one is named); returns the planes.
    ``folded`` must not hold any of the k ancillas. ``carrier`` scales the
    amplitude (:func:`uniform_planes`): 0 writes an all-zero state."""
    nus, mu, folded = _uniform_args(num_qubits, folded, anc_lo, nu_terms_k,
                                    nu_angles_k, nu_bases_k, mu_terms,
                                    mu_angles, mu_base)
    re, im = _output_planes(num_qubits, out, device)
    if re.device.type == "cpu":
        re, im = uniform_planes(num_qubits, folded, (re, im),
                                carrier=carrier)
        return _multi_reference(re, im, anc_lo, nus, mu)
    k = len(nus)
    comp = ((1 << num_qubits) - 1) ^ sum(1 << q for q in set(folded))
    amp = _uniform_amp(folded, carrier)
    table, n_terms = _profile_table((mu,) + nus, re.device)
    _build.launch("qcmrf_hdh_multi_uniform", re.device, _build.ptr(table),
                  n_terms, k, _build.ptr(re), _build.ptr(im),
                  (1 << num_qubits) >> k, int(anc_lo), comp, amp)
    LAUNCHES["hdh_multi_uniform"] += 1
    return re, im


# --------------------------------------------------------------------------
# Generic gate passes on real/imaginary planes
# --------------------------------------------------------------------------

#: shared memory of one lane_kernel block: Mᵀ as two float32 planes and a
#: tile of 64 state rows (kLaneShared of the CUDA source)
LANE_SHARED_BYTES = (2 * 128 * 128 + 2 * 64 * 128) * 4


def _gate_planes(re, im) -> int:
    """Qubit count of planes a gate pass takes: whole 128-value rows."""
    nq = plane_qubits(re, im)
    if nq < 7:
        raise ValueError(f"planes of {nq} qubits; the gate passes take "
                         ">= 7 (whole 128-value rows)")
    return nq


def _launch_ptrs(*planes):
    """Pointers of planes handed to a gate kernel, which moves them as
    float4: each must start on a 16-byte boundary."""
    for t in planes:
        if t.data_ptr() % 16:
            raise ValueError("a plane does not start on a 16-byte boundary")
    return [_build.ptr(t) for t in planes]


def _rotate(re, im, c, s):
    """``(re + i im) * (c + i s)`` written back into the planes."""
    new_re = re * c - im * s
    im.copy_(re * s + im * c)
    re.copy_(new_re)
    return re, im


def _diag_args(re, im, terms, angles, base):
    nq = _gate_planes(re, im)
    prof = _profile(terms, angles, base)
    _check_terms(nq, (prof,))
    return nq, prof


def apply_diagonal_profile_reference(re, im, terms, angles, base=0.0):
    """Plain PyTorch version of :func:`apply_diagonal_profile`, any device:
    the angle summed in float64 at every state id."""
    nq, prof = _diag_args(re, im, terms, angles, base)
    x = torch.arange(1 << nq, dtype=torch.int64,
                     device=re.device).reshape(re.shape)
    return _rotate(re, im, *_profile_cos_sin(prof, x))


def apply_diagonal_profile(re, im, terms, angles, base=0.0):
    """One pass applying ``e^{i (base + sum_t angles[t] [terms[t] hold])}``,
    **in place**; returns the planes. ``terms`` is a sequence of condition
    tuples ``((qubit, wanted bit), ...)``; an empty tuple holds everywhere.
    At most ``MAX_SANDWICH_TERMS`` terms (the planner emits at most 64)."""
    if re.device.type == "cpu":
        return apply_diagonal_profile_reference(re, im, terms, angles, base)
    nq, prof = _diag_args(re, im, terms, angles, base)
    table, n_terms = _profile_table((prof,), re.device)
    _build.launch("qcmrf_diag", re.device, _build.ptr(table), n_terms,
                  *_launch_ptrs(re, im), (1 << nq) >> 2)
    LAUNCHES["diag"] += 1
    return re, im


def apply_masked_rotation_reference(re, im, conds, base_angle: float,
                                    masked_angle: float):
    """Plain PyTorch version of :func:`apply_masked_rotation`."""
    return apply_diagonal_profile_reference(re, im, (conds,),
                                            (masked_angle,), base_angle)


def apply_masked_rotation(re, im, conds, base_angle: float,
                          masked_angle: float):
    """Phase ``e^{i (base + masked [all conds hold])}``, in place: the
    diagonal pass at one term."""
    return apply_diagonal_profile(re, im, (conds,), (masked_angle,),
                                  base_angle)


def _unitary(U, k: int) -> np.ndarray:
    U = np.asarray(U, dtype=np.complex64)
    if U.shape != (1 << k, 1 << k):
        raise ValueError(f"gate of shape {U.shape}, expected "
                         f"{(1 << k, 1 << k)}")
    return U


def _row_args(re, im, U, q_lo: int, k: int):
    nq = _gate_planes(re, im)
    if q_lo < 7 or q_lo + k > nq:
        raise ValueError(f"row qubits {q_lo}..{q_lo + k - 1}: a row pass "
                         f"takes qubits 7..{nq - 1}")
    return nq, _unitary(U, k)


def _row_gate_reference(re, im, U, q_lo: int, k: int):
    S = 1 << q_lo
    v = torch.complex(re.reshape(-1, 1 << k, S), im.reshape(-1, 1 << k, S))
    out = torch.einsum("oj,hjs->hos", torch.from_numpy(U).to(re.device), v)
    re.copy_(out.real.reshape(re.shape))
    im.copy_(out.imag.reshape(im.shape))
    return re, im


def _row_gate(re, im, U, q_lo: int, k: int):
    nq, U = _row_args(re, im, U, q_lo, k)
    if re.device.type == "cpu":
        return _row_gate_reference(re, im, U, q_lo, k)
    m = _build.GateMatrix()
    flat = U.reshape(-1)
    m.re[:flat.size] = flat.real.tolist()
    m.im[:flat.size] = flat.imag.tolist()
    _build.launch("qcmrf_row_gate", re.device, m, k, *_launch_ptrs(re, im),
                  (1 << nq) >> (k + 2), q_lo)
    LAUNCHES["row_gate"] += 1
    return re, im


def _lane_args(re, im, M):
    nq = _gate_planes(re, im)
    return nq, _unitary(M, 7)


def apply_lane_reference(re, im, M):
    """Plain PyTorch version of :func:`apply_lane`, any device: the four
    real float32 products of the JAX kernel."""
    _, M = _lane_args(re, im, M)
    mr = torch.from_numpy(np.ascontiguousarray(M.real)).to(re.device)
    mi = torch.from_numpy(np.ascontiguousarray(M.imag)).to(re.device)
    r, i = re.reshape(-1, 128), im.reshape(-1, 128)
    out_re = r @ mr.T - i @ mi.T
    im.copy_((r @ mi.T + i @ mr.T).reshape(im.shape))
    re.copy_(out_re.reshape(re.shape))
    return re, im


def apply_lane(re, im, M):
    """``out = state · Mᵀ`` on every 128-value row (qubits 0-6), M a
    complex 128x128 matrix given without factors, **in place**; returns
    the planes. On the card: ``lane_kernel``, the dense product on the
    tensor cores in three TF32 products a term (float32 accuracy)."""
    nq, M = _lane_args(re, im, M)
    if re.device.type == "cpu":
        return apply_lane_reference(re, im, M)
    m = _device_bytes(np.ascontiguousarray(M.real).tobytes()
                      + np.ascontiguousarray(M.imag).tobytes(), re.device)
    _build.launch("qcmrf_lane", re.device, _build.ptr(m),
                  *_launch_ptrs(re, im), (1 << nq) >> 7)
    LAUNCHES["lane"] += 1
    return re, im


def identity_factors() -> np.ndarray:
    """The ``(7, 2, 2)`` complex64 factors of a lane op that touches no
    qubit: one 2x2 identity a lane qubit."""
    return np.tile(np.eye(2, dtype=np.complex64), (7, 1, 1))


def lane_factor_mask(factors) -> int:
    """Bit q set where a lane op's factor q is not the identity: the
    factors the pass applies."""
    eye = np.eye(2, dtype=np.complex64)
    return sum(1 << q for q, F in enumerate(factors)
               if not np.array_equal(F, eye))


def _factored_args(re, im, factors):
    """(nq, factors as complex64, mask of the non-identity factors)."""
    nq = _gate_planes(re, im)
    F = np.asarray(factors, dtype=np.complex64)
    if F.shape != (7, 2, 2):
        raise ValueError(f"lane factors of shape {F.shape}, expected "
                         "(7, 2, 2)")
    return nq, F, lane_factor_mask(F)


def _butterfly(own, par, c_own, c_par):
    """``c_own * own + c_par * par`` on (re, im) pairs, rounded in the
    kernel's order."""
    (o_r, o_i), (p_r, p_i) = own, par
    cor, coi = float(c_own.real), float(c_own.imag)
    cpr, cpi = float(c_par.real), float(c_par.imag)
    return (o_r * cor - o_i * coi + p_r * cpr - p_i * cpi,
            o_i * cor + o_r * coi + p_i * cpr + p_r * cpi)


def apply_lane_factored_reference(re, im, factors):
    """Plain PyTorch version of :func:`apply_lane_factored`, any device: the
    kernel's butterflies, qubit 0 first, on a ``(rows, 2^(6-q), 2, 2^q)``
    view of the planes; each value becomes ``F[b][b] own + F[b][1-b]
    partner``, b its bit of q."""
    _, F, mask = _factored_args(re, im, factors)
    for q in range(7):
        if not mask >> q & 1:
            continue
        shape = (-1, 1 << (6 - q), 2, 1 << q)
        r, i = re.view(shape), im.view(shape)
        new = [_butterfly((r[:, :, b], i[:, :, b]),
                          (r[:, :, 1 - b], i[:, :, 1 - b]),
                          F[q, b, b], F[q, b, 1 - b]) for b in (0, 1)]
        for b, (nr, ni) in enumerate(new):
            r[:, :, b] = nr
            i[:, :, b] = ni
    return re, im


def apply_lane_factored(re, im, factors):
    """The lane op ``M = F6 ⊗ ... ⊗ F0`` on every 128-value row, given by
    its ``(7, 2, 2)`` factors (factor q acts on qubit q), **in place**;
    returns the planes. One 2x2 butterfly a value for each factor that is
    not the identity: ``lane_factored_kernel`` on the card, bound by its
    bytes. The planner's lane ops carry their factors; an ``M`` given
    without them goes to :func:`apply_lane`."""
    nq, F, mask = _factored_args(re, im, factors)
    if re.device.type == "cpu":
        return apply_lane_factored_reference(re, im, F)
    f = _build.LaneFactors()
    f.re[:] = F.real.reshape(-1).tolist()
    f.im[:] = F.imag.reshape(-1).tolist()
    _build.launch("qcmrf_lane_factored", re.device, f, mask,
                  *_launch_ptrs(re, im), (1 << nq) >> 7)
    LAUNCHES["lane_factored"] += 1
    return re, im


def _one_factor(U, q: int) -> np.ndarray:
    factors = identity_factors()
    factors[q] = _unitary(U, 1)
    return factors


def apply_1q_reference(re, im, U, q: int, n: int = None):
    """Plain PyTorch version of :func:`apply_1q`."""
    nq = _gate_planes(re, im)
    if n is not None and n != nq:
        raise ValueError(f"planes of {nq} qubits, not {n}")
    if 0 <= q < 7:
        return apply_lane_factored_reference(re, im, _one_factor(U, q))
    _, U = _row_args(re, im, U, q, 1)
    return _row_gate_reference(re, im, U, q, 1)


def apply_1q(re, im, U, q: int, n: int = None):
    """Apply a 2x2 unitary to qubit ``q``, in place; returns the planes.
    A lane qubit (q < 7) goes through :func:`apply_lane_factored` with one
    factor, a row qubit through ``row_gate_kernel<1>``. ``n``, when given,
    must be the planes' qubit count."""
    nq = _gate_planes(re, im)
    if n is not None and n != nq:
        raise ValueError(f"planes of {nq} qubits, not {n}")
    if 0 <= q < 7:
        return apply_lane_factored(re, im, _one_factor(U, q))
    return _row_gate(re, im, U, q, 1)


def apply_2q_row_pair_reference(re, im, U4, q_lo: int):
    """Plain PyTorch version of :func:`apply_2q_row_pair`."""
    _, U4 = _row_args(re, im, U4, q_lo, 2)
    return _row_gate_reference(re, im, U4, q_lo, 2)


def apply_2q_row_pair(re, im, U4, q_lo: int):
    """Apply a 4x4 unitary to the adjacent row qubits ``(q_lo, q_lo + 1)``,
    both >= 7, in place; the matrix index is ``bit(q_lo + 1) * 2 +
    bit(q_lo)`` (``row_gate_kernel<2>``)."""
    return _row_gate(re, im, U4, q_lo, 2)


def _copy_args(re, im, out):
    nq = _gate_planes(re, im)
    if plane_qubits(*out) != nq or out[0].device != re.device:
        raise ValueError("output planes differ from the input planes in "
                         "size or device")
    return nq


def copy_planes_reference(re, im, out):
    """Plain PyTorch version of :func:`copy_planes`."""
    _copy_args(re, im, out)
    out[0].copy_(re)
    out[1].copy_(im)
    return out


def copy_planes(re, im, out):
    """Copy both planes into ``out`` (a pair of planes): the bytes of a
    read-write gate pass and no arithmetic (``copy_kernel``); returns
    ``out``."""
    nq = _copy_args(re, im, out)
    if re.device.type == "cpu":
        return copy_planes_reference(re, im, out)
    _build.launch("qcmrf_copy", re.device, *_launch_ptrs(re, im, *out),
                  (1 << nq) >> 2)
    LAUNCHES["copy"] += 1
    return out


def fma_chain_max(x: torch.Tensor, b: float = 1e-9, steps: int = FMA_CHAIN,
                  out=None) -> torch.Tensor:
    """Run a chain of ``steps`` ``x = x * x + b`` on every value of ``x``
    (float32, contiguous, a multiple of 4 values) and return the largest
    final value, a 0-d tensor: ``fma_peak_kernel``, 2 * ``steps`` float32
    operations a value, reduced on the card so no chain is dead code.
    ``out`` (like ``x``), where given, receives every final value. ``x``
    is not changed."""
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % 4:
        raise ValueError("x must be contiguous float32 holding a multiple "
                         "of 4 values")
    if not 0 <= steps < 1 << 31:
        raise ValueError(f"steps must fit an int, got {steps}")
    if out is not None:
        _build.check(out, "out", torch.float32, x.shape, x.device)
    if x.device.type == "cpu":
        return fma_chain_max_reference(x, b, steps, out)
    quads = x.numel() // 4
    block_max = torch.empty(-(-quads // _BLOCK_THREADS), dtype=torch.float32,
                            device=x.device)
    _build.launch("qcmrf_fma_peak", x.device, *_launch_ptrs(x), b, steps,
                  quads, _build.ptr(block_max),
                  None if out is None else _launch_ptrs(out)[0])
    LAUNCHES["fma_peak"] += 1
    return block_max.max()
