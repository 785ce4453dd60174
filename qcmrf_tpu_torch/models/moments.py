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
streaming logsumexp alone. ``mesh`` sharding comes with slice 6 of
ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from qcmrf_tpu_torch.models import elimination as _ve
from qcmrf_tpu_torch.models.capability import STREAMING_MAX_N as _MAX_N
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.utils import moebius


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharding the streaming sweeps over a device mesh comes to the "
            "port with slice 6 (the multi-device layer) of ROADMAP.md")


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


def log_partition_streaming(mrf: MRF, mesh=None) -> torch.Tensor:
    """``ln Z`` for any structure, differentiable in ``mrf.theta`` with the
    gradient ``beta * E_p[phi]`` from the fused sweep instead of autograd
    through a ``2**n`` table: :func:`qcmrf_tpu_torch.ops.kernels.
    log_partition`, which picks its sweep before any runs (one fused
    sweep under differentiation, else one streaming logsumexp, as JAX's
    primal). ``beta`` is a constant."""
    from qcmrf_tpu_torch.ops import kernels

    _no_mesh(mesh)
    return kernels.log_partition(mrf)


# --------------------------------------------------------------------------
# Conditional inference for any structure: clamp evidence by exact
# clique-table reduction, then any lnZ backend covers the free variables.
# --------------------------------------------------------------------------


def reduce_evidence(mrf: MRF, evidence: dict):
    """(reduced MRF over the free variables, clamped log-potential
    constant): exact evidence clamping by clique-table slicing.

    Each clique slot carrying an evidence variable is sliced to its
    observed value, cliques fully determined by the evidence fold into the
    constant, and the surviving scopes relabel onto the free variables in
    ascending order (``free[i]`` becomes variable ``i``). Identity: ``ln
    sum_{x ~ e} e^{beta theta^T phi(x)} = beta * const + lnZ(reduced)``.
    The reduced model lives on ``mrf``'s device; it is ``None`` when every
    variable is observed."""
    _ve._validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    free = [v for v in range(mrf.n) if v not in ev]
    rank = {v: i for i, v in enumerate(free)}
    const = torch.zeros((), dtype=mrf.theta.dtype, device=mrf.device)
    new_cliques, new_thetas = [], []
    off = 0
    for C in mrf.cliques:
        c = len(C)
        tab = mrf.theta[off: off + (1 << c)].reshape((2,) * c)
        tab = tab[tuple(ev[v] if v in ev else slice(None) for v in C)]
        scope = [rank[v] for v in C if v not in ev]
        if scope:
            new_cliques.append(scope)
            new_thetas.append(tab.reshape(-1))
        else:
            const = const + tab.reshape(())
        off += 1 << c
    nf = len(free)
    if not new_cliques:
        if nf == 0:
            return None, const
        # every clique folded into the constant, but free variables remain:
        # they are in no clique, so keep them with one zero-potential clique
        new_cliques = [[0]]
        new_thetas = [torch.zeros((2,), dtype=mrf.theta.dtype,
                                  device=mrf.device)]
    # n=nf explicitly: a free variable in no reduced clique still counts
    red = MRF.create(new_cliques, theta=torch.cat(new_thetas),
                     beta=mrf.beta, n=nf, device=mrf.device)
    return red, const


def log_partition_clamped_streaming(mrf: MRF, evidence: dict,
                                    mesh=None) -> torch.Tensor:
    """Unnormalised log-mass of the evidence for any structure: ``ln
    sum_{x ~ e} e^{beta theta^T phi(x)}`` by :func:`reduce_evidence` and a
    streaming ln Z sweep of the free-variable model."""
    _no_mesh(mesh)
    red, const = reduce_evidence(mrf, evidence)
    if red is None:
        return mrf.beta * const
    return mrf.beta * const + log_partition_streaming(red)


def conditional_prob_streaming(mrf: MRF, v: int, value: int,
                               evidence: dict = None,
                               mesh=None) -> torch.Tensor:
    """Exact ``P(x_v = value | evidence)`` for any structure by two clamped
    streaming sweeps; evidence on ``v`` itself gives 0 or 1."""
    _no_mesh(mesh)
    evidence = dict(evidence or {})
    _ve._validate_evidence(mrf.n, {**evidence, v: value})
    if int(v) in {int(u) for u in evidence}:
        agree = int(evidence[[u for u in evidence
                              if int(u) == int(v)][0]]) == int(value)
        return torch.tensor(1.0 if agree else 0.0, dtype=mrf.theta.dtype,
                            device=mrf.device)
    num = log_partition_clamped_streaming(mrf, {**evidence, v: value})
    den = (log_partition_clamped_streaming(mrf, evidence) if evidence
           else log_partition_streaming(mrf))
    return torch.exp(num - den)


def clique_marginals_clamped_streaming(mrf: MRF, evidence: dict = None,
                                       mesh=None) -> torch.Tensor:
    """Conditional clique marginals ``E_p[phi | evidence]`` in the original
    theta layout, for any structure: the reduced model's moment sweep,
    re-embedded at the evidence-consistent rows (other rows exactly 0,
    fully determined cliques one-hot at the observed row). With no
    evidence this is the unconditioned moment sweep."""
    _no_mesh(mesh)
    evidence = dict(evidence or {})
    if not evidence:
        return clique_moments_streaming(mrf)
    _ve._validate_evidence(mrf.n, evidence)
    red, _ = reduce_evidence(mrf, evidence)
    rmom = (torch.zeros((0,), dtype=torch.float64) if red is None
            else clique_moments_streaming(red))
    return embed_clamped_marginals(mrf, evidence, rmom)


def marginal_map_streaming(mrf: MRF, max_vars, evidence: dict = None,
                           mesh=None):
    """Marginal MAP for any structure: ``(assignment, value)`` with
    ``value = max_{x_M} ln sum_{x_S} e^{beta theta^T phi(x)}`` under the
    evidence, by enumerating the ``2^|M|`` max-variable assignments, each
    scored by one clamped streaming sweep. Ties keep the first
    assignment in counting order; observed max variables are pinned."""
    _no_mesh(mesh)
    evidence = dict(evidence or {})
    _ve._validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    req = _ve._validate_max_vars(mrf.n, max_vars)
    M = [v for v in req if v not in ev]
    m = len(M)
    best_val, best_bits = -float("inf"), 0
    for a in range(1 << m):
        bits = {M[j]: (a >> (m - 1 - j)) & 1 for j in range(m)}
        val = float(log_partition_clamped_streaming(mrf, {**ev, **bits}))
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
    rmom = torch.as_tensor(red_moments).detach().cpu().double().numpy()
    out = np.zeros((mrf.dimension,), np.float64)
    off = roff = 0
    for C in mrf.cliques:
        c = len(C)
        surv = [s for s, v in enumerate(C) if int(v) not in ev]
        base = 0
        for s, v in enumerate(C):
            if int(v) in ev:
                base |= ev[int(v)] << (c - 1 - s)
        if not surv:
            out[off + base] = 1.0
        else:
            m = len(surv)
            for j in range(1 << m):
                idx = base
                for t, s in enumerate(surv):
                    idx |= ((j >> (m - 1 - t)) & 1) << (c - 1 - s)
                out[off + idx] = rmom[roff + j]
            roff += 1 << m
        off += 1 << c
    return torch.as_tensor(out, dtype=mrf.theta.dtype, device=mrf.device)
