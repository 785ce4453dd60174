"""Streaming exact inference for any clique structure (the serving part of
:mod:`qcmrf_tpu.models.moments`).

A sweep of all ``2**n`` states, with no ``2**n`` array, gives

* ``ln Z``: :func:`log_partition_streaming`, the streaming logsumexp of
  :func:`qcmrf_tpu_torch.ops.kernels.log_partition`;
* the exact clique marginals ``E_p[phi]``: :func:`clique_moments_streaming`,
  one fused lnZ + moments sweep (:func:`lnz_and_moments_streaming`), or,
  for a given ln Z, one sweep of the monomial-moments kernel
  (:func:`qcmrf_tpu_torch.ops.kernels.monomial_moments`), over the
  deduplicated bit-monomial basis of the structure (every subset of every
  clique), mapped once onto the theta layout by the inverse-Moebius
  doubling (:func:`qcmrf_tpu_torch.utils.moebius.masks_from_monomials`).

Evidence clamps by exact clique-table reduction (:func:`reduce_evidence`),
after which any ln Z backend serves the free variables: the clamped log
mass, conditional probabilities, clamped marginals and marginal MAP by
enumeration of the max variables.

The JAX package's MXU forms of the moment sweep (the lane-packed weighted
Gram kernel and its XLA fallback for cliques of more than 4 variables)
are one kernel here: it takes any list of monomial masks.

ln Z is differentiable in ``theta`` (:func:`log_partition_streaming`, that
is :func:`qcmrf_tpu_torch.ops.kernels.log_partition`): under
differentiation one fused sweep (``lnz_moments_kernel``,
:func:`lnz_and_moments_streaming`) gives ln Z and the moments that its
backward returns, ``beta * E_p[phi] * g``; a value-only call runs the
streaming logsumexp alone.

With ``mesh`` (a :class:`qcmrf_tpu_torch.parallel.sharded.Mesh`) every
sweep here shards its block range over the devices
(:mod:`qcmrf_tpu_torch.parallel.sharded`); a model smaller than the mesh,
as evidence often leaves it, runs the single-device sweep, the same
answer (``sharded.fit_mesh``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qcmrf_tpu_torch.models import elimination as _ve
from qcmrf_tpu_torch.models.capability import STREAMING_MAX_N as _MAX_N
from qcmrf_tpu_torch.models.capability import reduce_structure
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.utils import moebius, profiling


def _check_streaming_n(n: int) -> None:
    if n > _MAX_N:
        raise ValueError(
            f"streaming moments cap at n={_MAX_N}, the JAX package's cap "
            "(its int32 block ids), kept so that both packages refuse "
            f"alike; got n={n} — bounded-treewidth models can use "
            "models.elimination.clique_marginals at any n"
        )


def clique_moments_streaming(mrf: MRF, lnZ=None) -> torch.Tensor:
    """Exact model moments ``E_p[phi]`` (the clique-marginal vector in
    theta layout) by one streaming sweep. With no ``lnZ``, the fused lnZ
    + moments sweep (:func:`lnz_and_moments_streaming`) normalises them
    itself; a given ``lnZ`` normalises one sweep of the monomial-moments
    kernel. For bounded-width models :func:`elimination.clique_marginals`
    serves any n; this serves any structure up to ``n = 47``."""
    from qcmrf_tpu_torch.ops import kernels

    _check_streaming_n(mrf.n)
    if lnZ is None:
        return lnz_and_moments_streaming(mrf)[1]
    lnz = torch.as_tensor(lnZ, dtype=torch.float32,
                          device=mrf.device).reshape(1)
    masks = moebius.device_masks(mrf.cliques, mrf.n, mrf.device)
    coef = kernels.moebius_coefficients(mrf)[None]
    mono = kernels.monomial_moments(mrf.cliques, mrf.n, coef, mrf.beta, lnz,
                                    masks)[0]
    return moebius.masks_from_monomials(mono, mrf.cliques).to(
        mrf.theta.dtype)


def lnz_and_moments_streaming(mrf: MRF):
    """``(lnZ, E_p[phi])`` in ONE streaming sweep, for any structure:
    :func:`qcmrf_tpu_torch.ops.kernels.lnz_and_moments`, the fused kernel
    (a running max per block of states) over the deduplicated monomial
    basis, its blocks merged in float64, the monomial moments mapped onto
    the theta layout by the inverse-Moebius doubling. Both come in
    ``theta``'s dtype. The JAX package fuses only structures its Gram
    lanes hold and sweeps twice otherwise (cliques of 5+ variables, n <
    10); the port's kernel takes any masks, so that two-sweep fallback has
    no counterpart here. Half the sweeps of the two-sweep form for an
    exact-MLE step, whose NLL needs lnZ and whose gradient needs the
    moments."""
    from qcmrf_tpu_torch.ops import kernels

    _check_streaming_n(mrf.n)
    return kernels.lnz_and_moments(mrf.cliques, mrf.n, mrf.theta, mrf.beta)


class _ShardedLogPartition(torch.autograd.Function):
    """ln Z of ``theta`` sharded over a mesh, whose backward is ``beta *
    E_p[phi] * g`` from the forward's sharded fused sweep
    (``sharded.sharded_lnz_and_moments``), as JAX's
    ``_lnZ_streaming_sharded`` custom VJP."""

    @staticmethod
    def forward(ctx, theta, cliques, n, beta, mesh):
        from qcmrf_tpu_torch.parallel import sharded

        m = MRF(theta=theta.detach(), beta=beta, cliques=cliques, n=n)
        lnz, mu = sharded.sharded_lnz_and_moments(m, mesh)
        ctx.save_for_backward(mu)
        ctx.beta = beta
        return lnz

    @staticmethod
    def backward(ctx, g):
        (mu,) = ctx.saved_tensors
        return ctx.beta * mu * g, None, None, None, None


def log_partition_streaming(mrf: MRF, mesh=None) -> torch.Tensor:
    """``ln Z`` for any structure, differentiable in ``mrf.theta`` with the
    gradient ``beta * E_p[phi]`` from the fused sweep instead of autograd
    through a ``2**n`` table: :func:`qcmrf_tpu_torch.ops.kernels.
    log_partition`, which picks its sweep before any runs (one fused
    sweep under differentiation, else one streaming logsumexp, as JAX's
    primal). ``beta`` is a constant. With ``mesh`` both sweeps shard over
    it (the sharded lnZ, or under differentiation the sharded fused
    sweep)."""
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.parallel import sharded

    mesh = sharded.fit_mesh(mesh, mrf.n)
    if mesh is None:
        return kernels.log_partition(mrf)
    if torch.is_grad_enabled() and mrf.theta.requires_grad:
        return _ShardedLogPartition.apply(mrf.theta, mrf.cliques, mrf.n,
                                          float(mrf.beta), mesh)
    return sharded.sharded_log_partition(mrf, mesh)


# --------------------------------------------------------------------------
# Conditional inference for any structure: clamp evidence by exact
# clique-table reduction, then any lnZ backend covers the free variables.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _clamp_tables(cliques: tuple, n: int):
    """Host tables of the evidence clamp for a structure, one row a theta
    entry: ``(evar, ebit, eclq, cvar)``. ``evar[e]`` is entry e's clique's
    variables padded to ``cmax`` with ``n``, ``ebit[e]`` the clique-state
    bits of its slots (``y[0]`` slowest, padded 0), ``eclq[e]`` its clique
    and ``cvar`` the padded variables a clique. Each build (a miss of its
    cache) is counted as ``clamp_table_build``."""
    profiling.count("clamp_table_build")
    cmax = max(len(C) for C in cliques)
    cvar = np.full((len(cliques), cmax), n, np.int64)
    for k, C in enumerate(cliques):
        cvar[k, :len(C)] = C
    sizes = np.asarray([len(C) for C in cliques], np.int64)
    eclq = np.repeat(np.arange(len(cliques)), 1 << sizes)
    starts = np.cumsum(1 << sizes) - (1 << sizes)
    y = np.arange(len(eclq)) - starts[eclq]
    shift = sizes[eclq, None] - 1 - np.arange(cmax)
    ebit = np.where(shift >= 0, (y[:, None] >> np.maximum(shift, 0)) & 1, 0)
    return cvar[eclq], ebit.astype(np.int8), eclq, cvar


def _clamp_index(cliques: tuple, n: int, ev: dict):
    """``(keep, const)``: the theta entries consistent with the evidence
    ``ev`` (every observed slot's bit equal to its value), split into
    those of cliques with a free slot, which in ascending order are the
    reduced model's theta layout, and those of fully observed cliques,
    one entry each."""
    evar, ebit, eclq, cvar = _clamp_tables(cliques, n)
    e = np.full((n + 1,), -1, np.int8)
    e[list(ev)] = list(ev.values())
    e[n] = 0  # a padded slot reads as observed at its bit 0
    obs = e[evar]
    consistent = ((obs < 0) | (obs == ebit)).all(axis=1)
    free = (e[cvar] < 0).any(axis=1)[eclq]
    return (np.flatnonzero(consistent & free),
            np.flatnonzero(consistent & ~free))


def _sum_in_order(vals: torch.Tensor) -> torch.Tensor:
    """``vals``' sum added left to right from 0 in their dtype, bit for bit
    the per-clique loop's constant (the JAX package's): on the host, one
    read of the few entries, back as a fill (no upload). Under autograd
    it is one differentiable sum instead, equal within its rounding."""
    if vals.requires_grad:
        return vals.sum()
    if not vals.numel():
        return torch.zeros((), dtype=vals.dtype, device=vals.device)
    with profiling.span("qcmrf.wait"):
        host = vals.cpu().numpy()
    return torch.full((), float(np.add.accumulate(host)[-1]),
                      dtype=vals.dtype, device=vals.device)


@profiling.spanned("qcmrf.moments.reduce")
def reduce_evidence(mrf: MRF, evidence: dict):
    """(reduced MRF over the free variables, clamped log-potential
    constant): exact evidence clamping by clique-table slicing.

    Each clique slot carrying an evidence variable is sliced to its
    observed value, cliques fully determined by the evidence fold into the
    constant, and the surviving scopes relabel onto the free variables in
    ascending order (``free[i]`` becomes variable ``i``). Identity: ``ln
    sum_{x ~ e} e^{beta theta^T phi(x)} = beta * const + lnZ(reduced)``.
    The slicing is one gather of theta at :func:`_clamp_index`'s entries;
    no evidence returns ``mrf`` itself. The reduced model lives on
    ``mrf``'s device; it is ``None`` when every variable is observed."""
    _ve._validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    if not ev:
        return mrf, torch.zeros((), dtype=mrf.theta.dtype, device=mrf.device)
    _, structure = reduce_structure(mrf.cliques, mrf.n, ev)
    keep, const = _clamp_index(mrf.cliques, mrf.n, ev)
    with profiling.span("qcmrf.wait"):
        index = torch.from_numpy(np.concatenate([keep, const])).to(
            mrf.device)
    picked = mrf.theta.index_select(0, index)
    const_sum = _sum_in_order(picked[keep.size:])
    if structure is None:
        return None, const_sum
    new_cliques, nf = structure
    # every clique folded into the constant, but free variables remain:
    # they are in no clique, so the one zero-potential clique holds them
    theta = (picked[:keep.size] if keep.size else
             torch.zeros((2,), dtype=mrf.theta.dtype, device=mrf.device))
    # n=nf explicitly: a free variable in no reduced clique still counts
    return MRF(theta=theta, beta=mrf.beta, cliques=new_cliques,
               n=nf), const_sum


def log_partition_clamped_streaming(mrf: MRF, evidence: dict,
                                    mesh=None) -> torch.Tensor:
    """Unnormalised log-mass of the evidence for any structure: ``ln
    sum_{x ~ e} e^{beta theta^T phi(x)}`` by :func:`reduce_evidence` and a
    streaming ln Z sweep of the free-variable model (sharded over
    ``mesh`` when given)."""
    red, const = reduce_evidence(mrf, evidence)
    if red is None:
        return mrf.beta * const
    return mrf.beta * const + log_partition_streaming(red, mesh)


def conditional_prob_streaming(mrf: MRF, v: int, value: int,
                               evidence: dict = None,
                               mesh=None) -> torch.Tensor:
    """Exact ``P(x_v = value | evidence)`` for any structure by two clamped
    streaming sweeps (sharded over ``mesh`` when given); evidence on
    ``v`` itself gives 0 or 1."""
    evidence = dict(evidence or {})
    _ve._validate_evidence(mrf.n, {**evidence, v: value})
    if int(v) in {int(u) for u in evidence}:
        agree = int(evidence[[u for u in evidence
                              if int(u) == int(v)][0]]) == int(value)
        return torch.tensor(1.0 if agree else 0.0, dtype=mrf.theta.dtype,
                            device=mrf.device)
    num = log_partition_clamped_streaming(mrf, {**evidence, v: value}, mesh)
    den = (log_partition_clamped_streaming(mrf, evidence, mesh) if evidence
           else log_partition_streaming(mrf, mesh))
    return torch.exp(num - den)


def clique_marginals_clamped_streaming(mrf: MRF, evidence: dict = None,
                                       mesh=None) -> torch.Tensor:
    """Conditional clique marginals ``E_p[phi | evidence]`` in the original
    theta layout, for any structure: the reduced model's moment sweep,
    re-embedded at the evidence-consistent rows (other rows exactly 0,
    fully determined cliques one-hot at the observed row). With no
    evidence this is the unconditioned moment sweep. With ``mesh`` the
    sweep is ``sharded.sharded_clique_moments`` (lnZ sharded too), unless
    the (reduced) model is smaller than the mesh."""
    from qcmrf_tpu_torch.parallel import sharded

    evidence = dict(evidence or {})
    if evidence:
        _ve._validate_evidence(mrf.n, evidence)
        red, _ = reduce_evidence(mrf, evidence)
    else:
        red = mrf
    if red is None:
        rmom = torch.zeros((0,), dtype=torch.float64)
    elif sharded.fit_mesh(mesh, red.n) is not None:
        rmom = sharded.sharded_clique_moments(red, mesh)
    else:
        rmom = clique_moments_streaming(red)
    return embed_clamped_marginals(mrf, evidence, rmom) if evidence else rmom


def marginal_map_streaming(mrf: MRF, max_vars, evidence: dict = None,
                           mesh=None):
    """Marginal MAP for any structure: ``(assignment, value)`` with
    ``value = max_{x_M} ln sum_{x_S} e^{beta theta^T phi(x)}`` under the
    evidence, by enumerating the ``2^|M|`` max-variable assignments, each
    scored by one clamped streaming sweep (sharded over ``mesh`` when
    given). Ties keep the first assignment in counting order; observed
    max variables are pinned."""
    evidence = dict(evidence or {})
    _ve._validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    req = _ve._validate_max_vars(mrf.n, max_vars)
    M = [v for v in req if v not in ev]
    m = len(M)
    best_val, best_bits = -float("inf"), 0
    for a in range(1 << m):
        bits = {M[j]: (a >> (m - 1 - j)) & 1 for j in range(m)}
        val = float(log_partition_clamped_streaming(mrf, {**ev, **bits},
                                                    mesh))
        if val > best_val:
            best_val, best_bits = val, a
    assignment = {
        v: (ev[v] if v in ev
            else (best_bits >> (m - 1 - M.index(v))) & 1)
        for v in req
    }
    return assignment, best_val


def embed_clamped_marginals(mrf: MRF, evidence: dict,
                            red_moments) -> torch.Tensor:
    """Re-embed the evidence-reduced model's moment vector (theta layout of
    :func:`reduce_evidence`'s model, any backend) into the original theta
    layout: reduced rows land at their evidence-consistent indices, other
    rows are zero, fully determined cliques are one-hot at the observed
    row. Computed on the host in float64; returned in theta's dtype on
    ``mrf``'s device."""
    ev = {int(v): int(b) for v, b in evidence.items()}
    keep, const = _clamp_index(mrf.cliques, mrf.n, ev)
    with profiling.span("qcmrf.wait"):
        rmom = torch.as_tensor(red_moments).detach().cpu()
    out = np.zeros((mrf.dimension,), np.float64)
    out[keep] = rmom.double().numpy()[:keep.size]
    out[const] = 1.0
    with profiling.span("qcmrf.wait"):
        return torch.as_tensor(out, dtype=mrf.theta.dtype,
                               device=mrf.device)
