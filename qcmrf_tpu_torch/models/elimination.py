"""Exact inference by variable elimination (port of
:mod:`qcmrf_tpu.models.elimination`).

The clique structure is static, so the whole elimination schedule (which
factors combine, every intermediate factor's scope and shape) is planned
on the host once per structure; the engine then runs that schedule as
torch ops on log-domain factor tables, on the device that holds
``mrf.theta``:

* cost scales with the induced width, not ``2**n``: a 4 x C grid is
  exact at any length;
* it is plain torch, so ``torch.autograd.grad`` of ln Z gives the exact
  clique marginals ``E_p[phi]``.

A factor is a dense tensor over its scope, the scope's variables in
ascending order, one axis of size 2 per variable. This module has no
kernel: it is the serving route for every bounded-width model, and on the
card the independent oracle of the streaming kernels.

Planner: :func:`min_degree_order`, :func:`induced_width`,
:func:`plan_table_floats`, :func:`mmap_width`. Engine:
:func:`log_partition`, :func:`log_partition_clamped`,
:func:`conditional_prob`, :func:`clique_marginals`,
:func:`map_state_bits` (max-product with traceback) and
:func:`marginal_map`. Samplers: :func:`sample_exact_elim` (forward
filtering, backward sampling) and :func:`sample_pam` (perturb-and-MAP by
max-product batched over the samples), torch ops on batched tensors as
the JAX package's are jnp code.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.models.capability import (MMAP_WIDTH_CAP,
                                               SAMPLER_TABLE_FLOATS_CAP)
from qcmrf_tpu_torch.models.mrf import MRF


def min_degree_order(cliques: Sequence[Sequence[int]], n: int,
                     defer: Sequence[int] = ()) -> List[int]:
    """Min-degree elimination order (the heuristic of native/kiopto.cpp).

    Variables in ``defer`` are eliminated only after every other variable
    (min-degree within each phase): the constrained order a marginal-MAP
    pass needs, where the max variables must come last."""
    adj = [set() for _ in range(n)]
    for C in cliques:
        for a in C:
            for b in C:
                if a != b:
                    adj[a].add(b)
    deferred = set(int(v) for v in defer)
    done = [False] * n
    order = []
    for _ in range(n):
        best, best_key = -1, None
        for v in range(n):
            if done[v]:
                continue
            deg = sum(1 for u in adj[v] if not done[u])
            key = (v in deferred, deg)
            if best_key is None or key < best_key:
                best, best_key = v, key
        order.append(best)
        done[best] = True
        nb = [u for u in adj[best] if not done[u]]
        for a in nb:
            for b in nb:
                if a != b:
                    adj[a].add(b)
    return order


class _Step:
    """One elimination step: which pool factors combine, the combined
    scope, and the axis summed (or maximised) out."""

    __slots__ = ("factor_ids", "scope", "out_scope", "axis")

    def __init__(self, factor_ids, scope, out_scope, axis):
        self.factor_ids = factor_ids
        self.scope = scope
        self.out_scope = out_scope
        self.axis = axis


def _plan(cliques: Sequence[Tuple[int, ...]], n: int,
          order: Sequence[int] = None):
    """Static elimination schedule: ``(steps, isolated_count)``. A step's
    factor ids are ``('clique', k)`` for an input factor or ``('step',
    i)`` for the result of step ``i``."""
    if order is None:
        order = min_degree_order(cliques, n)
    pool = [(tuple(sorted(C)), ("clique", k)) for k, C in enumerate(cliques)]
    steps: List[_Step] = []
    isolated = 0
    for v in order:
        touching = [(s, src) for s, src in pool if v in s]
        rest = [(s, src) for s, src in pool if v not in s]
        if not touching:
            isolated += 1
            pool = rest
            continue
        scope = tuple(sorted(set().union(*[set(s) for s, _ in touching])))
        out_scope = tuple(u for u in scope if u != v)
        steps.append(_Step([src for _, src in touching], scope, out_scope,
                           scope.index(v)))
        pool = rest
        if out_scope:
            pool.append((out_scope, ("step", len(steps) - 1)))
    return steps, isolated


@functools.lru_cache(maxsize=256)
def _structure_plan(cliques: Tuple[Tuple[int, ...], ...], n: int):
    return _plan(cliques, n)


@functools.lru_cache(maxsize=1024)
def _plan_stats(cliques: Tuple[Tuple[int, ...], ...], n: int):
    """(width, total table floats) of the min-degree plan."""
    steps, _ = _structure_plan(cliques, n)
    width = max((len(st.scope) for st in steps), default=0)
    return width, sum(1 << len(st.scope) for st in steps)


def induced_width(cliques, n: int) -> int:
    """Largest combined factor scope size of the min-degree plan: the
    exponent of the per-step table cost (2^width). The scope includes the
    eliminated variable, so this is the textbook induced width plus one
    (K_n gives n, a chain 2); ``capability.ELIM_WIDTH_CAP`` is in the
    same unit."""
    return _plan_stats(tuple(tuple(sorted(C)) for C in cliques), n)[0]


def plan_table_floats(cliques, n: int) -> int:
    """Total floats of all step tables of the min-degree plan, ``sum_steps
    2^|scope|``: the live-memory unit of the passes that keep every step's
    table."""
    return _plan_stats(tuple(tuple(sorted(C)) for C in cliques), n)[1]


def _clique_log_factor(theta: torch.Tensor, beta: float, cliques,
                       k: int) -> torch.Tensor:
    """Clique k's ``beta * theta`` table as a log-factor over its sorted
    scope (theta layout: clique order, first variable slowest). A batch of
    thetas ``(B, d)`` gives a batch of factors ``(B, 2, ..., 2)``."""
    C = cliques[k]
    m = len(C)
    off = sum(1 << len(c) for c in cliques[:k])
    lead = theta.shape[:-1]
    tab = (beta * theta[..., off: off + (1 << m)]).reshape(
        *lead, *(2,) * m)
    # target axis j holds sorted(C)[j]; its source axis is argsort(C)[j]
    b = len(lead)
    return tab.permute(*range(b), *[b + int(a) for a in np.argsort(C)])


def _expand(f: torch.Tensor, scope: Tuple[int, ...],
            target: Tuple[int, ...]) -> torch.Tensor:
    """Broadcast a log-factor over ``scope`` to the superset ``target``
    (leading batch axes kept)."""
    lead = f.shape[:f.dim() - len(scope)]
    return f.reshape(*lead, *[2 if u in scope else 1 for u in target])


def _combine_step(st: _Step, clique_scopes, clique_factors, step_results,
                  steps, like: torch.Tensor) -> torch.Tensor:
    """Log-domain product of every factor touching the step's variable,
    broadcast to the combined scope (shared by every pass)."""
    acc = torch.zeros((2,) * len(st.scope), dtype=like.dtype,
                      device=like.device)
    for kind, idx in st.factor_ids:
        f = clique_factors[idx] if kind == "clique" else step_results[idx]
        src_scope = (clique_scopes[idx] if kind == "clique"
                     else steps[idx].out_scope)
        acc = acc + _expand(f, src_scope, st.scope)
    return acc


def _log2(count: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(count * math.log(2.0), dtype=like.dtype,
                        device=like.device)


def _lnz(cliques, n: int, theta: torch.Tensor, beta: float) -> torch.Tensor:
    steps, isolated = _structure_plan(cliques, n)
    factors = [_clique_log_factor(theta, beta, cliques, k)
               for k in range(len(cliques))]
    scopes = [tuple(sorted(C)) for C in cliques]
    results: List[torch.Tensor] = []
    const = _log2(isolated, theta)
    for st in steps:
        acc = _combine_step(st, scopes, factors, results, steps, theta)
        reduced = torch.logsumexp(acc, dim=st.axis)
        results.append(reduced)
        if not st.out_scope:
            const = const + reduced
    return const


def log_partition(mrf: MRF) -> torch.Tensor:
    """``ln Z`` by variable elimination: exact at any n for bounded width,
    differentiable in ``mrf.theta``."""
    return _lnz(mrf.cliques, mrf.n, mrf.theta, mrf.beta)


# --------------------------------------------------------------------------
# Conditional inference: clamp evidence variables, eliminate the rest.
# --------------------------------------------------------------------------


def _reduce_factors(theta, beta, cliques, ev: dict, red_scopes):
    """Slice the evidence axes out of every clique log-factor. Returns
    ``(reduced_factors, const, covered)``: the factors with a nonempty
    reduced scope, the folded sum of fully observed cliques, and the free
    variables that appear in some reduced factor."""
    reduced_factors = []
    const = torch.zeros((), dtype=theta.dtype, device=theta.device)
    for k, C in enumerate(cliques):
        f = _clique_log_factor(theta, beta, cliques, k)
        scope = tuple(sorted(C))
        for ax in range(len(scope) - 1, -1, -1):
            if scope[ax] in ev:
                f = f.select(ax, ev[scope[ax]])
        if red_scopes[k]:
            reduced_factors.append(f)
        else:
            const = const + f  # fully observed clique: scalar
    covered = set().union(*[set(s) for s in red_scopes if s]) \
        if any(red_scopes) else set()
    return reduced_factors, const, covered


@functools.lru_cache(maxsize=256)
def _clamped_plan(cliques: Tuple[Tuple[int, ...], ...], n: int,
                  evidence: Tuple[Tuple[int, int], ...]):
    ev = dict(evidence)
    red_scopes = [tuple(v for v in sorted(C) if v not in ev)
                  for C in cliques]
    # free variables in no reduced factor are counted explicitly (the
    # plan's isolated count would also count the clamped variables)
    steps, _ = _plan([s for s in red_scopes if s], n)
    return red_scopes, steps


def _validate_evidence(n: int, evidence: dict) -> None:
    for v, b in evidence.items():
        if not 0 <= int(v) < n:
            raise ValueError(f"evidence variable {v} out of range [0, {n})")
        if int(b) not in (0, 1):
            raise ValueError(f"evidence value {b} for variable {v} is not "
                             "a binary state")


def log_partition_clamped(mrf: MRF, evidence: dict) -> torch.Tensor:
    """Unnormalised log-mass of the evidence: ``ln sum_{x ~ e} e^{beta
    theta^T phi(x)}``; ``ln P(e) = log_partition_clamped -
    log_partition``."""
    _validate_evidence(mrf.n, evidence)
    evt = tuple(sorted((int(v), int(b)) for v, b in evidence.items()))
    ev = dict(evt)
    red_scopes, steps = _clamped_plan(mrf.cliques, mrf.n, evt)
    factors, const, covered = _reduce_factors(mrf.theta, mrf.beta,
                                              mrf.cliques, ev, red_scopes)
    free = set(range(mrf.n)) - set(ev) - covered
    const = const + _log2(len(free), mrf.theta)
    nonempty = [s for s in red_scopes if s]
    results: List[torch.Tensor] = []
    for st in steps:
        acc = _combine_step(st, nonempty, factors, results, steps,
                            mrf.theta)
        reduced = torch.logsumexp(acc, dim=st.axis)
        results.append(reduced)
        if not st.out_scope:
            const = const + reduced
    return const


def conditional_prob(mrf: MRF, v: int, value: int,
                     evidence: dict = None) -> torch.Tensor:
    """Exact ``P(x_v = value | evidence)`` by two clamped eliminations;
    evidence on ``v`` itself gives 0 or 1."""
    evidence = dict(evidence or {})
    _validate_evidence(mrf.n, {**evidence, v: value})
    if int(v) in {int(u) for u in evidence}:
        agree = int(evidence[[u for u in evidence
                              if int(u) == int(v)][0]]) == int(value)
        return torch.tensor(1.0 if agree else 0.0, dtype=mrf.theta.dtype,
                            device=mrf.device)
    num = log_partition_clamped(mrf, {**evidence, v: value})
    den = (log_partition_clamped(mrf, evidence) if evidence
           else log_partition(mrf))
    return torch.exp(num - den)


def clique_marginals(mrf: MRF) -> torch.Tensor:
    """Exact ``E_p[phi]`` (d,) as the gradient of ln Z (by
    ``torch.autograd.grad``) over beta."""
    theta = mrf.theta.detach().requires_grad_(True)
    with torch.enable_grad():
        lnz = _lnz(mrf.cliques, mrf.n, theta, mrf.beta)
        (grad,) = torch.autograd.grad(lnz, theta)
    return grad / mrf.beta


# --------------------------------------------------------------------------
# Max-product elimination with traceback: exact MAP at any n for bounded
# width.
# --------------------------------------------------------------------------


def _gather_bits(table: torch.Tensor, scope: Tuple[int, ...],
                 bits: torch.Tensor) -> torch.Tensor:
    """``table[bits[scope[0]], bits[scope[1]], ...]`` on the device; with
    a batch (``bits`` (B, n), ``table`` (B, 2, ..., 2) or one table for
    all rows), one entry a row."""
    m = len(scope)
    idx = torch.zeros(bits.shape[:-1], dtype=torch.int64, device=bits.device)
    for i, u in enumerate(scope):
        idx = idx + (bits[..., u] << (m - 1 - i))
    if bits.dim() == 1:
        return table.reshape(-1)[idx]
    flat = table.reshape(-1, 1 << m).expand(bits.shape[0], -1)
    return flat.gather(1, idx[:, None])[:, 0]


def map_state_bits(mrf: MRF) -> torch.Tensor:
    """Exact MAP assignment as per-variable bits (n,) int64, by
    max-product elimination with traceback (ties: bit 0, as argmax takes
    the first maximum)."""
    cliques, n, theta = mrf.cliques, mrf.n, mrf.theta
    steps, _ = _structure_plan(cliques, n)
    factors = [_clique_log_factor(theta, mrf.beta, cliques, k)
               for k in range(len(cliques))]
    scopes = [tuple(sorted(C)) for C in cliques]
    results: List[torch.Tensor] = []
    argmaxes: List[torch.Tensor] = []
    for st in steps:
        acc = _combine_step(st, scopes, factors, results, steps, theta)
        results.append(acc.amax(dim=st.axis))
        argmaxes.append(acc.argmax(dim=st.axis))
    # backtrack in reverse elimination order: every variable of a step's
    # out_scope is decided by a later step
    bits = torch.zeros((n,), dtype=torch.int64, device=theta.device)
    for st, am in zip(reversed(steps), reversed(argmaxes)):
        bits[st.scope[st.axis]] = _gather_bits(am, st.out_scope, bits)
    return bits


# --------------------------------------------------------------------------
# Marginal MAP: max over a chosen variable set of the summed mass over the
# rest, by constrained (sum-first, max-last) elimination.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _mmap_plan(cliques: Tuple[Tuple[int, ...], ...], n: int,
               max_set: Tuple[int, ...],
               evidence: Tuple[Tuple[int, int], ...]):
    """Constrained elimination plan over the evidence-reduced scopes:
    ``(red_scopes, free, steps)``."""
    ev = dict(evidence)
    red_scopes = [tuple(v for v in sorted(C) if v not in ev)
                  for C in cliques]
    free = [v for v in range(n) if v not in ev]
    order = [v for v in min_degree_order(
        [s for s in red_scopes if s], n, defer=max_set) if v in set(free)]
    steps, _ = _plan([s for s in red_scopes if s], n, order=order)
    return red_scopes, free, steps


def mmap_width(cliques, n: int, max_vars, evidence: dict = None) -> int:
    """Largest combined scope of the constrained plan that
    :func:`marginal_map` runs (the unit of :func:`induced_width`; it can be
    much larger, e.g. |leaves| + 1 on a star whose leaves are maximised)."""
    ev = {int(v): int(b) for v, b in (evidence or {}).items()}
    M = tuple(v for v in sorted({int(u) for u in max_vars}) if v not in ev)
    _, _, steps = _mmap_plan(tuple(tuple(sorted(C)) for C in cliques), n, M,
                             tuple(sorted(ev.items())))
    return max((len(st.scope) for st in steps), default=0)


def _validate_max_vars(n: int, max_vars) -> list:
    """Dedup, sort and range-check a marginal-MAP max-variable set."""
    req = sorted({int(v) for v in max_vars})
    for v in req:
        if not 0 <= v < n:
            raise ValueError(f"max variable {v} out of range [0, {n})")
    return req


def marginal_map(mrf: MRF, max_vars, evidence: dict = None,
                 width_cap: int = MMAP_WIDTH_CAP):
    """Exact marginal MAP: ``(assignment, value)`` with ``value =
    max_{x_M} ln sum_{x_S} e^{beta theta^T phi(x)}`` under the evidence,
    ``M = max_vars`` (observed ones pinned), ``S`` the other free
    variables; ``assignment`` maps every requested max variable to its
    bit. Constrained widths past ``width_cap`` raise (``None`` forces the
    pass)."""
    evidence = dict(evidence or {})
    _validate_evidence(mrf.n, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    req = _validate_max_vars(mrf.n, max_vars)
    M = tuple(v for v in req if v not in ev)
    if width_cap is not None:
        w = mmap_width(mrf.cliques, mrf.n, M, ev)
        if w > width_cap:
            raise ValueError(
                f"marginal_map's constrained elimination width is {w} "
                f"(a 2^{w}-entry message table), over width_cap="
                f"{width_cap}; use moments.marginal_map_streaming for "
                f"few max variables over wide structures, or pass "
                f"width_cap=None to force it")
    theta, n = mrf.theta, mrf.n
    mx = set(M)
    red_scopes, free, steps = _mmap_plan(mrf.cliques, n, M,
                                         tuple(sorted(ev.items())))
    factors, const, covered = _reduce_factors(theta, mrf.beta, mrf.cliques,
                                              ev, red_scopes)
    # free variables in no factor: a sum variable adds ln 2, a max
    # variable nothing (its argmax ties at bit 0)
    const = const + _log2(sum(1 for v in free
                              if v not in covered and v not in mx), theta)
    nonempty = [s for s in red_scopes if s]
    results: List[torch.Tensor] = []
    argmaxes = []  # None for sum steps
    for st in steps:
        acc = _combine_step(st, nonempty, factors, results, steps, theta)
        if st.scope[st.axis] in mx:
            results.append(acc.amax(dim=st.axis))
            argmaxes.append(acc.argmax(dim=st.axis))
        else:
            results.append(torch.logsumexp(acc, dim=st.axis))
            argmaxes.append(None)
        if not st.out_scope:
            const = const + results[-1]
    # traceback over the max-phase steps: by the constrained order their
    # out_scope bits are decided already
    bits = torch.zeros((n,), dtype=torch.int64, device=theta.device)
    for st, am in zip(reversed(steps), reversed(argmaxes)):
        if am is not None:
            bits[st.scope[st.axis]] = _gather_bits(am, st.out_scope, bits)
    bits = bits.cpu().numpy()
    assignment = {v: (ev[v] if v in ev else int(bits[v])) for v in req}
    return assignment, float(const)


# --------------------------------------------------------------------------
# Samplers: forward filtering and backward sampling, and perturb-and-MAP by
# batched max-product elimination.
# --------------------------------------------------------------------------


def sample_exact_elim(generator, mrf: MRF, num_samples: int,
                      table_floats_cap: int = SAMPLER_TABLE_FLOATS_CAP
                      ) -> torch.Tensor:
    """IID exact samples from the Gibbs distribution as int32 bit rows
    ``(num_samples, n)`` for bounded induced width, at any n: one forward
    sum-product pass that keeps each step's combined factor before its sum,
    then backward draws, all samples at once, in reverse elimination order:
    every variable of a step's out-scope is drawn already, so the step's
    variable is a Bernoulli of the two entries of its stored factor at
    those bits. A variable in no factor is a uniform bit. The stored
    factors take :func:`plan_table_floats` floats; past
    ``table_floats_cap`` this raises (``None`` forces it). ``generator``:
    a ``torch.Generator`` on the model's device or an integer seed."""
    from qcmrf_tpu_torch.models.sample import _generator

    if table_floats_cap is not None:
        tf = plan_table_floats(mrf.cliques, mrf.n)
        if tf > table_floats_cap:
            raise ValueError(
                f"ancestral sampling stores every elimination step's "
                f"factor: {tf:.3g} floats here (width "
                f"{induced_width(mrf.cliques, mrf.n)} x ~{mrf.n} steps)"
                f" > cap {table_floats_cap:.3g}; add evidence to shrink "
                f"the model or pass table_floats_cap=None to force it")
    cliques, n = mrf.cliques, mrf.n
    dev = mrf.device
    gen = _generator(generator, dev)
    steps, _ = _structure_plan(cliques, n)
    theta = mrf.theta.detach()
    factors = [_clique_log_factor(theta, mrf.beta, cliques, k)
               for k in range(len(cliques))]
    scopes = [tuple(sorted(C)) for C in cliques]
    accs: List[torch.Tensor] = []
    results: List[torch.Tensor] = []
    with torch.no_grad():
        for st in steps:
            acc = _combine_step(st, scopes, factors, results, steps, theta)
            accs.append(acc)
            results.append(torch.logsumexp(acc, dim=st.axis))
        bits = torch.zeros((num_samples, n), dtype=torch.int64, device=dev)
        for st, acc in zip(reversed(steps), reversed(accs)):
            t = acc.movedim(st.axis, -1)
            l0 = _gather_bits(t[..., 0], st.out_scope, bits)
            l1 = _gather_bits(t[..., 1], st.out_scope, bits)
            u = torch.rand(num_samples, generator=gen, device=dev)
            bits[:, st.scope[st.axis]] = (u < torch.sigmoid(l1 - l0)).long()
        decided = {st.scope[st.axis] for st in steps}
        iso = [v for v in range(n) if v not in decided]
        if iso:
            bits[:, iso] = (torch.rand((num_samples, len(iso)), generator=gen,
                                       device=dev) < 0.5).long()
    return bits.to(torch.int32)


def _map_bits_batched(cliques, n: int, thetas: torch.Tensor) -> torch.Tensor:
    """MAP bits int64 ``(B, n)`` of the models ``thetas`` (B, d) at beta 1,
    by max-product elimination batched over the rows (ties: bit 0)."""
    steps, _ = _structure_plan(cliques, n)
    factors = [_clique_log_factor(thetas, 1.0, cliques, k)
               for k in range(len(cliques))]
    scopes = [tuple(sorted(C)) for C in cliques]
    results: List[torch.Tensor] = []
    argmaxes: List[torch.Tensor] = []
    for st in steps:
        acc = _combine_step(st, scopes, factors, results, steps, thetas)
        acc = acc.expand(thetas.shape[0], *acc.shape[-len(st.scope):])
        dim = st.axis - len(st.scope)
        results.append(acc.amax(dim=dim))
        argmaxes.append(acc.argmax(dim=dim))
    bits = torch.zeros((thetas.shape[0], n), dtype=torch.int64,
                       device=thetas.device)
    for st, am in zip(reversed(steps), reversed(argmaxes)):
        bits[:, st.scope[st.axis]] = _gather_bits(am, st.out_scope, bits)
    return bits


def sample_pam(generator, mrf: MRF, num_samples: int,
               _max_chunk_states: int = 1 << 22) -> torch.Tensor:
    """Low-order perturb-and-MAP samples as int32 bit rows ``(num_samples,
    n)`` for bounded induced width, at any n: IID Gumbel noise on every
    clique-state weight of ``beta * theta``, then the exact MAP of each
    perturbed model by max-product elimination batched over the samples,
    in chunks of samples whose per-step tables stay within
    ``_max_chunk_states`` entries (chunk * 2^width); the noise is drawn for
    all samples first, so the chunking does not change the samples."""
    from qcmrf_tpu_torch.models.sample import _generator, _gumbel

    dev = mrf.device
    gen = _generator(generator, dev)
    with torch.no_grad():
        g = _gumbel(gen, (num_samples, mrf.dimension), dev)
        thetas = g.add_(mrf.beta * mrf.theta.detach())
        width = induced_width(mrf.cliques, mrf.n)
        per = max(1, _max_chunk_states >> width)
        out = torch.empty((num_samples, mrf.n), dtype=torch.int32,
                          device=dev)
        for lo in range(0, num_samples, per):
            out[lo:lo + per] = _map_bits_batched(
                mrf.cliques, mrf.n, thetas[lo:lo + per])
    return out
