"""Systematic-scan Gibbs chains in one launch (the chains of
:func:`qcmrf_tpu.models.sample.sample_gibbs` and ``sample_gibbs_bits``).

:func:`gibbs_chains_multi` runs chains of several clique structures in one
launch, each structure's chains on their own thetas; :func:`gibbs_chains`
is its one-structure call: C independent single-site chains of ``(cliques,
n)``, chain c on the model ``(cliques, n, thetas[c], beta)``. Each sweep
visits the free sites in order, variable 0 first, and draws site v from
``p(x_v = 1 | rest) = sigmoid(beta * delta)``, ``delta`` the difference of
the log-potential with x_v = 1 and with x_v = 0, summed over the cliques
that hold v only (the JAX package's ``bits_site_delta_fn``).

Random words come from Philox4x32-10 keyed on ``(seed, chain id)``: the
uniform of site v in sweep s is ``u = (w >> 8) * 2^-24``, ``w`` word ``v %
4`` of counter ``(s, v // 4, 0, 0)``; the initial bit of a free site is
bit 0 of word ``v % 4`` of counter ``(0, v // 4, 1, 0)``. A chain's draws
depend on its seed and id only, not on the other chains or structures of
its launch. The bit is ``x >= T(u)``, ``x = beta * delta`` in float32 and
``T(u)`` (:func:`thresholds_of`) the least float32 above ``logit(u)``
evaluated in float64: exactly ``u < sigmoid(x)`` for a float32 ``x``,
decided without exp or division. It differs from the float32 test ``u <
1 / (1 + exp(-x))`` only where ``u`` lies within an ulp of that p1. The
JAX package draws from ``jax.random`` keys: the two agree in distribution,
not draw for draw.

On CUDA tensors :func:`gibbs_chains_multi` launches ``gibbs_kernel`` of
``csrc/gibbs_kernels.cu`` on the tables of :func:`chain_pack` (two warps a
chain: one updates the sites, with the state of n <= 64 variables in a
64-bit register word, the other computes the next sweep's thresholds); on
CPU tensors it runs :func:`gibbs_chains_reference` once a structure, the
same chains from theta directly (the sums in :func:`warp_sum`'s order),
independent of the tables. The JAX package has no Pallas kernel here: its
chains are ``lax.scan`` loops.

:func:`ais_chains` is the kernel's AIS mode (the chains of
:mod:`qcmrf_tpu_torch.models.ais`): M chains of one structure, every rung
of every chain in one launch, each rung a weight step at the chain's state
then sweeps at the rung's inverse temperature; :func:`ais_chains_reference`
is its plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.ops.sampler_kernel import philox4x32_10
from qcmrf_tpu_torch.utils import profiling

#: launches of the CUDA kernels (the port's one launch counter: Gibbs
#: mode ``gibbs``, AIS mode ``gibbs_ais``)
LAUNCHES = profiling.LAUNCHES

#: the kernel holds a chain's state as one 64-bit word up to this n
REG_STATE_MAX_N = 64
#: the fast loop's largest n: bit 63 of the word stays 0 for unused slots
FAST_MAX_N = 63
#: other slots an item's record packs (6 bits each) on the word path
_INLINE = 4
_STRUCT_INTS = 12

_MASK32 = 0xFFFFFFFF
_U24 = 2.0 ** -24


class ChainTables(NamedTuple):
    """A structure's site tables (int32 numpy), built from the (clique k,
    slot j) items of each variable in clique order: ``heads`` (n + 1,)
    item offsets of each variable; ``items`` (I, 4) per item the clique's
    theta offset, the bit ``2^(m-1-j)`` of slot j in the clique's slot
    word, and the item's range ``[begin, end)`` in ``others``; ``others``
    (M, 2) per other slot of the clique its variable and its bit."""

    heads: np.ndarray
    items: np.ndarray
    others: np.ndarray


def _theta_offsets(cliques: tuple) -> np.ndarray:
    offs = np.cumsum([0] + [1 << len(C) for C in cliques])
    if offs[-1] > 0x7FFFFFFF:
        raise ValueError(f"theta of {offs[-1]} entries; the chain takes "
                         "int32 offsets")
    return offs


def _site_items(cliques: tuple, n: int):
    """The (clique, slot) items of each variable, in clique order."""
    touch = [[] for _ in range(n)]
    for k, C in enumerate(cliques):
        for j in range(len(C)):
            touch[C[j]].append((k, j))
    return touch


@functools.lru_cache(maxsize=256)
def chain_tables(cliques: tuple, n: int) -> ChainTables:
    """The site tables of ``(cliques, n)``."""
    offs = _theta_offsets(cliques)
    heads, items, others = [0], [], []
    for v, touch in enumerate(_site_items(cliques, n)):
        for k, j in touch:
            C = cliques[k]
            m = len(C)
            begin = len(others)
            others += [(C[jj], 1 << (m - 1 - jj)) for jj in range(m)
                       if jj != j]
            items.append((offs[k], 1 << (m - 1 - j), begin, len(others)))
        heads.append(len(items))
    return ChainTables(np.asarray(heads, np.int32),
                       np.asarray(items, np.int32).reshape(-1, 4),
                       np.asarray(others, np.int32).reshape(-1, 2))


class ChainPack(NamedTuple):
    """The kernel's tables of several structures, concatenated (numpy; the
    layout ``csrc/gibbs_kernels.cu`` documents at ``GibbsArgs``):
    ``structs`` (S, 12) int32 per structure n, free sites, first meta row,
    D entries (the zero entry's index), evidence offset (-1: none), first
    and end record, 1 where an item has 6 or more other slots, the fast
    loop's ``K | C << 4 | 1 << 8`` (0: the general loop) and its first
    lane-table row; ``records`` (R, 4) int32 one an item of a free site;
    ``lanes`` (L, 4) int32 the fast loop's rows, 32 a free site, the free
    sites repeated for the G sweeps of a threshold group; ``meta``
    (F + S, 2) int32 one a free site and one ending each structure;
    ``others`` (M,) int32 the other slots of items that do not pack them;
    ``evidence`` (E,) int8; ``reg_state`` whether every n <=
    :data:`REG_STATE_MAX_N`."""

    structs: np.ndarray
    records: np.ndarray
    lanes: np.ndarray
    meta: np.ndarray
    others: np.ndarray
    evidence: np.ndarray
    reg_state: bool

    def shared_bytes(self, delta_in_shared: bool) -> int:
        """The launch's dynamic shared memory: the largest structure's
        threshold ring (two groups of G = 32 // free sites sweeps, at least
        1), D and the fast loop's lane table where D is in shared memory,
        and the state bytes past the word path."""
        n, free, dl, fast = (self.structs[:, i].astype(np.int64)
                             for i in (0, 1, 3, 8))
        group = _ring_group(free)
        need = 8 * group * free
        if delta_in_shared:
            need = (need + 4 * (dl + 1)
                    + np.where(fast > 0, 512 * group * free, 0))
        return int((need + (0 if self.reg_state else n)).max())


def _ring_group(free):
    """G, the sweeps a group of the kernel's threshold ring holds (and the
    fast loop's lane table repeats): 32 // free sites, at least 1."""
    free = np.asarray(free)
    return np.where((free > 0) & (free < 32), 32 // np.maximum(free, 1), 1)


def _site_levels(items: int) -> int:
    """k: the butterfly's levels for a site of ``items`` items."""
    return 5 if items > 32 else max(0, (items - 1).bit_length())


@functools.lru_cache(maxsize=64)
def chain_pack(structures: tuple) -> ChainPack:
    """The tables of ``structures``, a tuple of ``(cliques, n, evidence)``
    (evidence a tuple of -1, 0, 1 a site, or None)."""
    reg = all(n <= REG_STATE_MAX_N for _, n, _ in structures)
    structs, records, lanes, meta, others, evidence = [], [], [], [], [], []
    for cliques, n, ev in structures:
        if n >= 1 << 24:
            raise ValueError(f"n={n}: the chain takes n < 2^24")
        offs = _theta_offsets(cliques)
        ev_off = -1
        if ev is not None:
            ev_off = len(evidence)
            evidence += ev
        meta0, rec_lo, dl, big = len(meta), len(records), 0, 0
        sites = []   # per free site: v and its items' (D base, others)
        for v, touch in enumerate(_site_items(cliques, n)):
            if ev is not None and ev[v] >= 0:
                continue
            meta.append((len(records), v | _site_levels(len(touch)) << 24))
            sites.append((v, []))
            for k, j in touch:
                C = cliques[k]
                m = len(C)
                c, pos = m - 1, m - 1 - j
                # the other slots by increasing bit in the slot word
                oth = [C[jj] for jj in range(m - 1, -1, -1) if jj != j]
                if reg and c <= _INLINE:
                    w = sum(var << (6 * i) for i, var in enumerate(oth))
                else:
                    w = len(others)
                    others += oth
                records.append((dl & _MASK32, offs[k],
                                c | pos << 8 | (dl >> 32) << 16, w))
                sites[-1][1].append((dl, oth))
                dl += 1 << c
                big |= c >= 6
        if dl >= 1 << 47:
            raise ValueError(f"{dl} difference entries; the chain takes "
                             "fewer than 2^47")
        meta.append((len(records), 0))
        lane0 = len(lanes)
        fast = _lane_table(sites, n, dl, lanes) if reg else 0
        structs.append((n, len(sites), meta0, dl, ev_off, rec_lo,
                        len(records), big, fast, lane0, 0, 0))

    def i32(rows, width):
        return (np.asarray(rows, np.int64).reshape(-1, width)
                .astype(np.uint32).view(np.int32))

    return ChainPack(i32(structs, _STRUCT_INTS), i32(records, 4),
                     i32(lanes, 4), i32(meta, 2),
                     np.asarray(others, np.int32),
                     np.asarray(evidence, np.int8), reg)


def _lane_table(sites, n: int, dl: int, lanes: list) -> int:
    """Append the fast loop's lane table of one structure's free ``sites``
    (v and its items' D bases and other slots), repeated G times
    (:func:`_ring_group`), to ``lanes`` and return ``K | C << 4 | 1 <<
    8``; or 0, appending nothing, where the structure needs the general
    loop (no free site, n > :data:`FAST_MAX_N`, a site of more than 32
    items, an item of more than :data:`_INLINE` other slots)."""
    items = [it for _, its in sites for it in its]
    if (not sites or n > FAST_MAX_N or any(len(its) > 32 for _, its in sites)
            or any(len(oth) > _INLINE for _, oth in items)):
        return 0
    K = max([_site_levels(len(its)) for _, its in sites] + [0])
    C = max([len(oth) for _, oth in items] + [0])
    for v, its in sites * int(_ring_group(len(sites))):
        mask = 1 << v
        for lane in range(32):
            q = lane % (1 << K)
            base, oth = its[q] if q < len(its) else (dl, [])
            packed = sum((oth[i] if i < len(oth) else 63) << (6 * i)
                         for i in range(C))
            lanes.append((base, packed, mask & _MASK32, mask >> 32))
    return K | C << 4 | 1 << 8


def _chain_keys(chain_ids, C: int, device) -> torch.Tensor:
    if chain_ids is None:
        return torch.arange(C, dtype=torch.int64, device=device)
    return torch.as_tensor(chain_ids, dtype=torch.int64,
                           device=device).reshape(C)


def _words(seed: int, keys: torch.Tensor, c0: int, n: int, c2: int):
    """Philox words ``(C, n)``: word ``v % 4`` of counter ``(c0, v // 4,
    c2, 0)`` for each site v, keys ``(seed, keys[c])``."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64,
                          device=keys.device)
    w = philox4x32_10(c0, groups, c2, 0, seed & _MASK32,
                      (keys & _MASK32)[:, None])
    return torch.stack(w, dim=-1).reshape(keys.shape[0], -1)[:, :n]


def site_uniforms(seed: int, keys: torch.Tensor, sweep: int,
                  n: int) -> torch.Tensor:
    """The uniforms ``u`` float32 (C, n) of sweep ``sweep`` of the chains
    keyed ``keys`` (int64 (C,) chain ids)."""
    return (_words(seed, keys, sweep, n, 0) >> 8).to(torch.float32) * _U24


def thresholds_of(k: torch.Tensor) -> torch.Tensor:
    """``T(u)`` float32 for ``u = k * 2^-24`` (``k`` int64, 0 <= k <
    2^24): the least float32 strictly above ``logit(u) = log(k) - log(2^24
    - k)`` in float64, so that ``x >= T(u)`` exactly when ``x >
    logit(u)``; ``T(0)`` is -FLT_MAX. The kernel's ``site_threshold``."""
    L = torch.log(k.double()) - torch.log(((1 << 24) - k).double())
    t = L.float()
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    return torch.where(t.double() <= L, up, t)


def site_thresholds(seed: int, keys: torch.Tensor, sweep: int,
                    n: int) -> torch.Tensor:
    """The thresholds float32 (C, n) of sweep ``sweep``: the bit of site v
    is ``beta * delta >= T``, the draw ``u < sigmoid(beta * delta)`` of
    :func:`site_uniforms`' u."""
    return thresholds_of(_words(seed, keys, sweep, n, 0) >> 8)


def device_thresholds(device) -> torch.Tensor:
    """``T(k * 2^-24)`` of every k < 2^24, float32 on ``device``, from the
    kernel's own ``site_threshold`` (a check of the card: the sampler
    never calls it)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("device_thresholds runs on a CUDA device")
    out = torch.empty(1 << 24, dtype=torch.float32, device=dev)
    _build.launch("qcmrf_gibbs_thresholds", dev, 1 << 24, _build.ptr(out))
    return out


def initial_bits(seed: int, keys: torch.Tensor, n: int,
                 evidence: torch.Tensor = None) -> torch.Tensor:
    """The chains' initial states, int64 (C, n): the clamped bit at a
    clamped site, else bit 0 of the site's initial word."""
    bits = _words(seed, keys, 0, n, 1) & 1
    if evidence is not None:
        ev = evidence.to(device=keys.device, dtype=torch.int64)
        bits = torch.where(ev >= 0, ev, bits)
    return bits


@functools.lru_cache(maxsize=256)
def _site_gathers(cliques: tuple, n: int, device: torch.device):
    """Per site v: ``(others, weights, lo_hi)`` int64 tensors on
    ``device``, one row an item of v: the item's other slots' variables
    (padded with v itself at weight 0) and their bits in the slot word;
    the item's theta entries at slot word 0 with slot j at 0 and at 1, as
    ``(2, items)`` flattened."""
    tab = chain_tables(cliques, n)
    out = []
    for v in range(n):
        items = tab.items[tab.heads[v]:tab.heads[v + 1]]
        width = max((int(e - b) for _, _, b, e in items), default=0) or 1
        others = np.full((len(items), width), v, np.int64)
        weights = np.zeros((len(items), width), np.int64)
        for r, (_, _, b, e) in enumerate(items):
            others[r, :e - b] = tab.others[b:e, 0]
            weights[r, :e - b] = tab.others[b:e, 1]
        lo_hi = np.concatenate([items[:, 0], items[:, 0] + items[:, 1]])
        out.append(tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                         for a in (others, weights, lo_hi)))
    return out


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the rows of ``x`` (C, I) in a warp's order: lane
    l adds entries l, l + 32, ... in turn from 0, then the 32 lane sums are
    added pairwise, halves first (the full shuffle butterfly)."""
    C, items = x.shape
    rounds = max(1, -(-items // 32))
    lanes = torch.zeros((C, rounds * 32), dtype=x.dtype, device=x.device)
    lanes[:, :items] = x
    lanes = lanes.reshape(C, rounds, 32)
    acc = torch.zeros((C, 32), dtype=x.dtype, device=x.device)
    for r in range(rounds):
        acc = acc + lanes[:, r]
    for half in (16, 8, 4, 2, 1):
        acc = acc[:, :half] + acc[:, half:2 * half]
    return acc[:, 0]


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """``gibbs_kernel``'s float32 sum of a site's item differences ``x``
    (C, I): with I <= 2^k <= 32 (k least), lane l takes item l mod 2^k
    (0.0 past I) and k butterfly levels add them, halves first; past 32
    items, lane l adds items l, l + 32, ... in turn, then 5 levels. Equal
    to :func:`warp_sum` (its skipped levels add exact zeros)."""
    C, items = x.shape
    if items == 0:
        return torch.zeros(C, dtype=x.dtype, device=x.device)
    K = _site_levels(items)
    rounds = -(-items // (1 << K))
    lanes = torch.zeros((C, rounds << K), dtype=x.dtype, device=x.device)
    lanes[:, :items] = x
    lanes = lanes.reshape(C, rounds, 1 << K)
    acc = lanes[:, 0]
    for r in range(1, rounds):
        acc = acc + lanes[:, r]
    width = 1 << K
    while width > 1:
        width //= 2
        acc = acc[:, :width] + acc[:, width:2 * width]
    return acc[:, 0]


def site_deltas(cliques: tuple, n: int, thetas: torch.Tensor,
                bits: torch.Tensor, v: int) -> torch.Tensor:
    """``delta`` float32 (C,) at site ``v`` of the states ``bits`` (int64
    (C, n) of 0 and 1), chain c on ``thetas[c]``: the log-potential with
    x_v = 1 less that with x_v = 0, from the cliques that hold v only, each
    item's difference rounded, then summed in the warp's order
    (:func:`warp_sum`)."""
    others, weights, lo_hi = _site_gathers(cliques, n, thetas.device)[v]
    items = len(lo_hi) // 2
    if not items:
        return torch.zeros(thetas.shape[0], dtype=torch.float32,
                           device=thetas.device)
    y = (bits[:, others] * weights).sum(dim=-1)
    lo, hi = thetas.gather(1, y.repeat(1, 2) + lo_hi).split(items, dim=1)
    return warp_sum(hi - lo)


def site_probabilities(cliques: tuple, n: int, thetas: torch.Tensor,
                       beta: float, bits: torch.Tensor,
                       v: int) -> torch.Tensor:
    """``p1 = 1 / (1 + exp(-beta * delta))`` float32 (C,) at site ``v`` of
    the states ``bits``, from :func:`site_deltas` (the law the threshold
    decides, and the criterion :func:`first_decisions` reports)."""
    delta = site_deltas(cliques, n, thetas, bits, v)
    return torch.reciprocal(1 + torch.exp(-(delta * beta)))


def _check(cliques, n, thetas, num_samples, thin, burn):
    K = len(cliques)
    d = sum(1 << len(C) for C in cliques)
    if thetas.dim() != 2 or thetas.shape[1] != d:
        raise ValueError(f"thetas has shape {tuple(thetas.shape)}, expected "
                         f"(C, {d})")
    if thetas.dtype != torch.float32:
        raise ValueError(f"thetas has dtype {thetas.dtype}, expected "
                         "torch.float32")
    if num_samples < 1 or thin < 1 or burn < 0:
        raise ValueError("need num_samples >= 1, thin >= 1 and burn >= 0")
    sweeps = burn + (num_samples - 1) * thin + 1
    if sweeps > 0x7FFFFFFF or K == 0 or n < 1:
        raise ValueError(f"{sweeps} sweeps of n={n} sites: out of range")
    return sweeps


def _evidence(evidence_mask, n: int, device):
    if evidence_mask is None:
        return None
    ev = torch.as_tensor(evidence_mask, dtype=torch.int8,
                         device=device).reshape(n)
    if bool(((ev < -1) | (ev > 1)).any()):
        raise ValueError("evidence_mask holds -1 (free), 0 or 1 per site")
    return ev


def gibbs_chains_reference(seed: int, cliques: tuple, n: int,
                           thetas: torch.Tensor, beta: float,
                           num_samples: int, thin: int, burn: int,
                           evidence_mask=None,
                           chain_ids=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`gibbs_chains`, on any device, from
    theta directly: the same Philox words, the same float32 sums
    (:func:`site_deltas`) and the same thresholds, vectorised over the
    chains, a Python loop over sweeps and sites."""
    sweeps = _check(cliques, n, thetas, num_samples, thin, burn)
    dev = thetas.device
    C = thetas.shape[0]
    keys = _chain_keys(chain_ids, C, dev)
    ev = _evidence(evidence_mask, n, dev)
    free = [v for v in range(n) if ev is None or int(ev[v]) < 0]
    bits = initial_bits(seed, keys, n, ev)
    out = torch.empty((C, num_samples, n), dtype=torch.int8, device=dev)
    for s in range(sweeps):
        t = site_thresholds(seed, keys, s, n)
        for v in free:
            x = site_deltas(cliques, n, thetas, bits, v) * beta
            bits[:, v] = (x >= t[:, v]).to(torch.int64)
        if s >= burn and (s - burn) % thin == 0:
            out[:, (s - burn) // thin] = bits.to(torch.int8)
    return out


class ChainModel(NamedTuple):
    """One structure of a :func:`gibbs_chains_multi` call: its chains run
    on ``thetas`` (float32 (C, d)); ``evidence_mask`` int8 (n,) holds -1 at
    a free site and the clamped bit at a clamped one, or is None."""

    cliques: tuple
    n: int
    thetas: torch.Tensor
    evidence_mask: Optional[object] = None


def _prepare(models, num_samples, thin, burn, chain_ids, keys_on=None):
    """Checked models, the structures' key for :func:`chain_pack`, the
    chain keys (on ``keys_on``, default the thetas' device) and the sweep
    count."""
    models = [ChainModel(*m) for m in models]
    if not models:
        raise ValueError("no structures")
    dev = models[0].thetas.device
    sweeps = None
    structures, evs = [], []
    for m in models:
        _build.refuse_grad(m.thetas, "thetas")
        if m.thetas.device != dev:
            raise ValueError(f"thetas on {m.thetas.device} and {dev}")
        sweeps = _check(m.cliques, m.n, m.thetas, num_samples, thin, burn)
        ev = _evidence(m.evidence_mask, m.n, "cpu")
        evs.append(ev)
        structures.append((m.cliques, m.n, None if ev is None
                           else tuple(int(e) for e in ev.tolist())))
    C = sum(m.thetas.shape[0] for m in models)
    keys = _chain_keys(chain_ids, C, keys_on or dev)
    return models, evs, tuple(structures), keys, sweeps


@functools.lru_cache(maxsize=64)
def _device_pack(structures: tuple, device: torch.device):
    """``chain_pack(structures)``'s tables on ``device`` (one dummy row
    where a table is empty)."""
    pack = chain_pack(structures)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a if len(a) else np.zeros((1,) + a.shape[1:], a.dtype))).to(device)
        for a in (pack.structs, pack.records, pack.lanes, pack.meta,
                  pack.others, pack.evidence))


def gibbs_chains_multi(seed: int, models, beta: float, num_samples: int,
                       thin: int, burn: int, chain_ids=None) -> list:
    """The chains of several structures in one launch: ``models`` a
    sequence of :class:`ChainModel` (or ``(cliques, n, thetas[,
    evidence_mask])`` tuples), structure s's C_s chains on its ``thetas``
    rows, at inverse temperature ``beta``. Returns per structure the states
    after sweeps ``burn + i * thin``, ``i < num_samples``, as int8 bits
    (C_s, num_samples, n_s) on the thetas' device (views of one buffer).
    ``seed`` (uint32) and ``chain_ids`` (one int a chain over all
    structures in order, default 0 .. C-1) key each chain's Philox stream,
    so a chain's rows equal those of a launch of its structure alone with
    the same id. On CPU tensors: :func:`gibbs_chains_reference` a
    structure.

    One launch takes one state layout and one home of D for all its
    structures: where one structure has more than
    :data:`REG_STATE_MAX_N` variables, every structure of the launch keeps
    its state in shared memory, and where the D tables of one do not fit
    in shared memory, every structure's D lives in device memory. The rows
    are the same either way; group such structures into their own call to
    keep the others on the word path and the fast loop."""
    models, evs, structures, keys, sweeps = _prepare(
        models, num_samples, thin, burn, chain_ids, keys_on="cpu")
    dev = models[0].thetas.device
    if dev.type == "cpu":
        outs, c0 = [], 0
        for m, ev in zip(models, evs):
            C = m.thetas.shape[0]
            outs.append(gibbs_chains_reference(
                seed, m.cliques, m.n, m.thetas, beta, num_samples, thin,
                burn, ev, keys[c0:c0 + C]))
            c0 += C
        return outs
    pack = chain_pack(structures)
    delta_in_shared = pack.shared_bytes(True) <= _build.SHARED_BYTES_LIMIT
    smem = pack.shared_bytes(delta_in_shared)
    if smem > _build.SHARED_BYTES_LIMIT:
        raise ValueError(f"the chain needs {smem} bytes of shared memory; a "
                         f"block holds at most {_build.SHARED_BYTES_LIMIT}")
    structs, records, lanes, meta, others, evidence = _device_pack(
        structures, dev)
    Cs = np.array([m.thetas.shape[0] for m in models], np.int64)
    ns = pack.structs[:, 0].astype(np.int64)
    ds = np.array([m.thetas.shape[1] for m in models], np.int64)
    dls = pack.structs[:, 3].astype(np.int64) + 1
    which = np.repeat(np.arange(len(models)), Cs)
    rank = np.arange(Cs.sum()) - np.repeat(np.cumsum(Cs) - Cs, Cs)

    def offsets(per_chain):
        first = np.cumsum(Cs * per_chain) - Cs * per_chain
        return first[which] + rank * per_chain[which]

    chains = np.stack([offsets(ds), offsets(num_samples * ns),
                       offsets(dls) if not delta_in_shared
                       else np.zeros(len(which), np.int64),
                       (keys.numpy() & _MASK32) | which << 32], axis=1)
    # through pinned memory: a pageable copy would wait for the stream
    chains = torch.from_numpy(chains).pin_memory().to(dev, non_blocking=True)
    thetas = (models[0].thetas.contiguous() if len(models) == 1 else
              torch.cat([m.thetas.reshape(-1) for m in models]))
    out = torch.empty(int((Cs * num_samples * ns).sum()), dtype=torch.int8,
                      device=dev)
    delta = (None if delta_in_shared else
             torch.empty(int((Cs * dls).sum()), dtype=torch.float32,
                         device=dev))
    _build.launch("qcmrf_gibbs", dev, _build.ptr(chains), len(which),
                  _build.ptr(structs), _build.ptr(records), _build.ptr(lanes),
                  _build.ptr(meta), _build.ptr(others), _build.ptr(evidence),
                  _build.ptr(thetas),
                  _build.ctypes.c_void_p(0) if delta is None
                  else _build.ptr(delta), _build.ptr(out), float(beta),
                  seed & _MASK32, sweeps, burn, thin, num_samples,
                  int(pack.reg_state), smem)
    profiling.launch("gibbs")
    views = out.split((Cs * num_samples * ns).tolist())
    return [b.view(int(C), num_samples, int(n))
            for b, C, n in zip(views, Cs, ns)]


def gibbs_chains(seed: int, cliques: tuple, n: int, thetas: torch.Tensor,
                 beta: float, num_samples: int, thin: int, burn: int,
                 evidence_mask=None, chain_ids=None) -> torch.Tensor:
    """C systematic-scan chains of the structure ``(cliques, n)``, chain c
    on ``thetas[c]`` (float32 (C, d)) at inverse temperature ``beta``, in
    one launch; returns the states after sweeps ``burn + i * thin``, ``i <
    num_samples``, as int8 bits (C, num_samples, n) on ``thetas``'
    device. ``seed`` (uint32) and ``chain_ids`` (C ints, default 0 .. C-1)
    key each chain's Philox stream. ``evidence_mask``, int8 (n,), holds -1
    at a free site and the clamped bit at a clamped one (never updated).
    The one-structure call of :func:`gibbs_chains_multi`."""
    return gibbs_chains_multi(seed, [(cliques, n, thetas, evidence_mask)],
                              beta, num_samples, thin, burn, chain_ids)[0]


def ais_betas(num_temps: int) -> torch.Tensor:
    """The linear schedule beta_0 .. beta_T, float32 (T + 1,) on the CPU,
    bit-equal to ``jnp.linspace(0, 1, T + 1)``: ``fl(t * fl(1 / T))`` for
    t < T, then 1."""
    if num_temps < 1:
        raise ValueError(f"num_temps={num_temps}: AIS takes at least 1 rung")
    betas = (torch.arange(num_temps + 1, dtype=torch.float32)
             * (torch.tensor(1.0) / num_temps))
    betas[-1] = 1.0
    return betas


def ais_schedule(num_temps: int, beta: float) -> torch.Tensor:
    """The kernel's schedule, float32 (2, T) on the CPU: row 0 each rung's
    sweep scale ``fl(beta_{t+1} * beta)``, row 1 its weight factor
    ``fl(fl(beta_{t+1} - beta_t) * beta)`` (the JAX body's ``(b_cur -
    b_prev) * beta``)."""
    betas = ais_betas(num_temps)
    b = torch.tensor(beta, dtype=torch.float32)
    return torch.stack([betas[1:] * b, (betas[1:] - betas[:-1]) * b])


#: the AIS weight step packs a clique's variables, 6 bits each, into one
#: word up to this size (n <= FAST_MAX_N)
PACKED_CLIQUE = 5


@functools.lru_cache(maxsize=64)
def ais_cliques(cliques: tuple, n: int):
    """The kernel's clique table of a structure (int32 numpy): ``rows`` (K,
    4) a clique's theta offset, its first variable in ``vars``, its size and
    its variables packed 6 bits each, the first lowest (0 where a clique
    does not pack); ``vars`` the cliques' variables in order; ``packed``
    whether every clique packs (n <= :data:`FAST_MAX_N`, cliques of at most
    :data:`PACKED_CLIQUE` variables), so that the word path reads one record
    a clique."""
    offs = _theta_offsets(cliques)
    firsts = np.cumsum([0] + [len(C) for C in cliques])[:-1]
    packed = (n <= FAST_MAX_N
              and all(len(C) <= PACKED_CLIQUE for C in cliques))
    rows = [(offs[k], firsts[k], len(C),
             sum(v << (6 * j) for j, v in enumerate(C)) if packed else 0)
            for k, C in enumerate(cliques)]
    return (np.asarray(rows, np.int32).reshape(-1, 4),
            np.asarray([v for C in cliques for v in C], np.int32), packed)


@functools.lru_cache(maxsize=64)
def _clique_gathers(cliques: tuple, device: torch.device):
    """``(vars, weights, offsets)`` int64 on ``device``: (K, cmax) each
    clique's variables (padded with its first at weight 0), their bits in
    the slot word, and (K,) the cliques' theta offsets."""
    cmax = max(len(C) for C in cliques)
    vars_ = np.asarray([list(C) + [C[0]] * (cmax - len(C)) for C in cliques],
                       np.int64)
    weights = np.asarray([[1 << (len(C) - 1 - j) if j < len(C) else 0
                           for j in range(cmax)] for C in cliques], np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (
        vars_, weights, _theta_offsets(cliques)[:-1].astype(np.int64)))


def ais_shared_bytes(cliques: tuple, n: int):
    """``(bytes, D in shared memory, packed)`` of an AIS launch on ``(cliques,
    n)``: a Gibbs launch's shared memory (:meth:`ChainPack.shared_bytes`)
    and, where the cliques pack on the word path, their records on a
    16-byte boundary."""
    pack = chain_pack(((cliques, n, None),))
    packed = ais_cliques(cliques, n)[2] and pack.reg_state
    in_shared = pack.shared_bytes(True) <= _build.SHARED_BYTES_LIMIT
    return (pack.shared_bytes(in_shared)
            + (16 * len(cliques) + 15 if packed else 0), in_shared, packed)


def clique_indices(cliques: tuple, bits: torch.Tensor) -> torch.Tensor:
    """Flat theta indices int64 (C, K) of each row of ``bits`` (int (C, n)):
    clique k's offset plus its slot word, variable ``C[0]`` the most
    significant bit."""
    vars_, weights, offs = _clique_gathers(cliques, bits.device)
    return (bits.to(torch.int64)[:, vars_] * weights).sum(dim=-1) + offs


def rung_logpots(cliques: tuple, theta: torch.Tensor,
                 bits: torch.Tensor) -> torch.Tensor:
    """``theta^T phi(x)`` float32 (C,) of the rows of ``bits``, summed in a
    warp's order (:func:`warp_sum` over the cliques): the AIS kernel's
    weight step."""
    return warp_sum(theta[clique_indices(cliques, bits)])


def _ais_check(cliques, n, theta, num_chains, num_temps, sweeps_per_temp):
    d = sum(1 << len(C) for C in cliques)
    if theta.dim() != 1 or theta.shape[0] != d:
        raise ValueError(f"theta has shape {tuple(theta.shape)}, expected "
                         f"({d},)")
    if theta.dtype != torch.float32:
        raise ValueError(f"theta has dtype {theta.dtype}, expected "
                         "torch.float32")
    if num_chains < 1 or num_temps < 1 or sweeps_per_temp < 1:
        raise ValueError("need num_chains, num_temps and sweeps_per_temp "
                         ">= 1")
    if num_temps * sweeps_per_temp > 0x7FFFFFFF or not cliques or n < 1:
        raise ValueError(f"{num_temps} x {sweeps_per_temp} sweeps of n={n} "
                         "sites: out of range")


def ais_chains_reference(seed: int, cliques: tuple, n: int,
                         theta: torch.Tensor, beta: float, num_chains: int,
                         num_temps: int, sweeps_per_temp: int,
                         chain_ids=None, near: bool = False):
    """Plain PyTorch version of :func:`ais_chains`, on any device, from
    theta directly: the same Philox words and thresholds as a Gibbs chain
    of T * sweeps_per_temp sweeps, the same float32 sums
    (:func:`site_deltas`, :func:`rung_logpots`) and the same schedule
    (:func:`ais_schedule`), vectorised over the chains, a Python loop over
    rungs, sweeps and sites. With ``near`` it returns a third item: for
    each chain its first decision within 2 float32 ulp of its p1 (where
    the kernel could decide the other way) as ``(sweep, site, u, p1)``, or
    ``(-1, -1, nan, nan)`` where its run had none."""
    _ais_check(cliques, n, theta, num_chains, num_temps, sweeps_per_temp)
    _build.refuse_grad(theta, "theta")
    dev = theta.device
    keys = _chain_keys(chain_ids, num_chains, dev)
    sched = ais_schedule(num_temps, beta).to(dev)
    thetas = theta[None].expand(num_chains, -1)
    bits = initial_bits(seed, keys, n)
    logw = torch.zeros(num_chains, dtype=torch.float32, device=dev)
    hit = torch.full((num_chains, 4), float("nan"), dtype=torch.float64,
                     device=dev)
    hit[:, :2] = -1
    s = 0
    for t in range(num_temps):
        logw = logw + sched[1, t] * rung_logpots(cliques, theta, bits)
        for _ in range(sweeps_per_temp):
            thr = site_thresholds(seed, keys, s, n)
            u = site_uniforms(seed, keys, s, n) if near else None
            for v in range(n):
                x = site_deltas(cliques, n, thetas, bits, v) * sched[0, t]
                if near:
                    p1 = torch.reciprocal(1 + torch.exp(-x))
                    ulp = torch.nextafter(p1, torch.full_like(p1, 2.0)) - p1
                    new = (hit[:, 0] < 0) & (
                        (u[:, v].double() - p1.double()).abs()
                        <= 2 * ulp.double())
                    hit[new] = torch.stack([
                        torch.full_like(p1, s, dtype=torch.float64),
                        torch.full_like(p1, v, dtype=torch.float64),
                        u[:, v].double(), p1.double()], dim=1)[new]
                bits[:, v] = (x >= thr[:, v]).to(torch.int64)
            s += 1
    if not near:
        return logw, bits.to(torch.int8)
    first = [(int(a), int(b), float(c), float(d)) for a, b, c, d in
             hit.tolist()]
    return logw, bits.to(torch.int8), first


def ais_partings(seed: int, cliques: tuple, n: int, theta: torch.Tensor,
                 beta: float, num_temps: int, sweeps_per_temp: int,
                 got: torch.Tensor, want: torch.Tensor, chain_ids=None):
    """Holds ``got``, :func:`ais_chains`' final states, to ``want``, the
    plain version's at the same arguments (int8 (M, n)): for each chain
    whose states differ, the plain version's first decision within 2
    float32 ulp of its p1 (``ais_chains_reference(near=True)``) as
    ``(chain, sweep, site, u, p1)``, ``(chain, -1, -1, nan, nan)`` where
    its run had none (which :func:`within_ulps` refuses). The kernel
    writes no states between rungs, so this names a decision that could
    part the runs, not the one that did. Empty where ``got`` equals
    ``want``."""
    rows = torch.nonzero((got != want).any(dim=1))[:, 0]
    if not len(rows):
        return []
    keys = _chain_keys(chain_ids, got.shape[0], theta.device)
    first = ais_chains_reference(seed, cliques, n, theta, beta, len(rows),
                                 num_temps, sweeps_per_temp,
                                 keys[rows.to(keys.device)], near=True)[2]
    return [(c, *f) for c, f in zip(rows.tolist(), first)]


@functools.lru_cache(maxsize=64)
def _ais_device_tables(cliques: tuple, n: int, num_temps: int, beta: float,
                       device: torch.device):
    """:func:`ais_cliques`' tables and :func:`ais_schedule` on ``device``,
    kept: a pageable copy a call would wait for the stream's work before
    it."""
    rows, vars_, _ = ais_cliques(cliques, n)
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(vars_).to(device),
            ais_schedule(num_temps, beta).to(device))


def ais_chains(seed: int, cliques: tuple, n: int, theta: torch.Tensor,
               beta: float, num_chains: int, num_temps: int,
               sweeps_per_temp: int = 1, chain_ids=None):
    """The chains of annealed importance sampling on the model ``(cliques,
    n, theta, beta)``: ``(logw, bits)``, the log-weights float32 (M,) and
    the final states int8 (M, n) on ``theta``'s device. Each chain starts
    uniform; rung t = 0 .. T-1 adds ``(beta_{t+1} - beta_t) * beta *
    theta^T phi(x)`` to its log-weight, then runs ``sweeps_per_temp``
    sweeps at ``beta_{t+1} * beta`` (:func:`ais_schedule`). ``seed``
    (uint32) and ``chain_ids`` (M ints, default 0 .. M-1) key each chain's
    Philox stream; sweep ``t * sweeps_per_temp + j`` draws as sweep of that
    number of a Gibbs chain. On a CUDA tensor one launch of the chain
    kernel's AIS mode for every rung of every chain; on a CPU tensor
    :func:`ais_chains_reference`."""
    _ais_check(cliques, n, theta, num_chains, num_temps, sweeps_per_temp)
    _build.refuse_grad(theta, "theta")
    dev = theta.device
    if dev.type == "cpu":
        return ais_chains_reference(seed, cliques, n, theta, beta,
                                    num_chains, num_temps, sweeps_per_temp,
                                    chain_ids)
    structures = ((cliques, n, None),)
    pack = chain_pack(structures)
    smem, delta_in_shared, packed = ais_shared_bytes(cliques, n)
    if smem > _build.SHARED_BYTES_LIMIT:
        raise ValueError(f"the chain needs {smem} bytes of shared memory; a "
                         f"block holds at most {_build.SHARED_BYTES_LIMIT}")
    structs, records, lanes, meta, others, _ = _device_pack(structures, dev)
    rows, vars_, sched = _ais_device_tables(cliques, n, num_temps,
                                            float(beta), dev)
    keys = _chain_keys(chain_ids, num_chains, "cpu").numpy()
    M = num_chains
    dl = int(pack.structs[0, 3]) + 1
    chains = np.stack([np.zeros(M, np.int64), np.arange(M) * n,
                       np.zeros(M, np.int64) if delta_in_shared
                       else np.arange(M) * dl, keys & _MASK32], axis=1)
    chains = torch.from_numpy(chains).pin_memory().to(dev, non_blocking=True)
    theta = theta.contiguous()
    out = torch.empty((M, n), dtype=torch.int8, device=dev)
    logw = torch.empty(M, dtype=torch.float32, device=dev)
    delta = (None if delta_in_shared else
             torch.empty(M * dl, dtype=torch.float32, device=dev))
    _build.launch("qcmrf_gibbs_ais", dev, _build.ptr(chains), M,
                  _build.ptr(structs), _build.ptr(records), _build.ptr(lanes),
                  _build.ptr(meta), _build.ptr(others), _build.ptr(theta),
                  _build.ctypes.c_void_p(0) if delta is None
                  else _build.ptr(delta), _build.ptr(out), _build.ptr(sched),
                  _build.ptr(rows), _build.ptr(vars_), len(cliques),
                  int(packed), num_temps,
                  sweeps_per_temp, _build.ptr(logw),
                  seed & _MASK32, int(pack.reg_state), smem)
    profiling.launch("gibbs_ais")
    return logw, out


def ais_resident_blocks(cliques: tuple, n: int, device) -> int:
    """Blocks of an :func:`ais_chains` launch on ``(cliques, n)`` that one SM
    of ``device`` holds at once: the CUDA runtime's occupancy of the
    instantiation that launch runs, at its shared-memory size
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"occupancy is the card's; got device {device}")
    pack = chain_pack(((cliques, n, None),))
    smem, delta_in_shared, _ = ais_shared_bytes(cliques, n)
    blocks = _build.ctypes.c_int(0)
    _build.launch("qcmrf_gibbs_ais_occupancy", device, int(pack.reg_state),
                  int(delta_in_shared), smem,
                  _build.ctypes.c_void_p(_build.ctypes.addressof(blocks)))
    return blocks.value


#: the steps that ``gibbs_latency_kernel`` times, in its order
LATENCY_STEPS = ("shared_load", "ldg_l1", "shuffle_add", "p1_tail",
                 "bit_round_trip", "fadd", "decide_slot_word",
                 "philox_threshold")


def latency_cycles(device, steps: int = 4096) -> dict:
    """Clock cycles of each dependent step of a site update
    (:data:`LATENCY_STEPS`), each the mean of ``steps`` repeats by one warp
    of ``gibbs_latency_kernel``, and ``sm_ghz``, the SM clock while it
    ran. A probe of the card: the sampler never calls it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the latency probe runs on a CUDA device")
    chase = torch.roll(torch.arange(256, dtype=torch.int32), -1).to(dev)
    k = len(LATENCY_STEPS)
    out = torch.zeros(k + 2, dtype=torch.int64, device=dev)
    sink = torch.empty(32, dtype=torch.int32, device=dev)
    _build.launch("qcmrf_gibbs_latency", dev, _build.ptr(chase), steps, 1.0,
                  _build.ptr(out), _build.ptr(sink))
    o = out.cpu().tolist()
    cycles = {name: o[i] / steps for i, name in enumerate(LATENCY_STEPS)}
    return dict(cycles, sm_ghz=o[k] / o[k + 1])


def ids_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int64 state ids (variable 0 the most significant bit) of int bit
    rows ``(..., n)``, n <= 62."""
    n = bits.shape[-1]
    shifts = torch.arange(n - 1, -1, -1, dtype=torch.int64,
                          device=bits.device)
    return (bits.to(torch.int64) << shifts).sum(dim=-1)


def first_decisions(seed: int, cliques: tuple, n: int, thetas: torch.Tensor,
                    beta: float, got: torch.Tensor, want: torch.Tensor,
                    evidence_mask=None, chain_ids=None):
    """Where two runs of every sweep (``thin`` 1, ``burn`` 0; int8 (C,
    sweeps, n)) of the same chains part: for each chain that does, its
    first differing site update as ``(chain, sweep, site, u, p1)``, ``u``
    and ``p1`` the plain version's at the state both runs held before it.
    A decision can fall either way only where ``u`` lies within rounding
    of ``p1``."""
    keys = _chain_keys(chain_ids, thetas.shape[0], thetas.device)
    ev = _evidence(evidence_mask, n, thetas.device)
    out = []
    for c in torch.nonzero((got != want).flatten(1).any(dim=1))[:, 0]:
        c = int(c)
        s = int(torch.nonzero((got[c] != want[c]).any(dim=1))[0, 0])
        v = int(torch.nonzero(got[c, s] != want[c, s])[0, 0])
        prev = (initial_bits(seed, keys[c:c + 1], n, ev)[0] if s == 0
                else want[c, s - 1].long())
        state = torch.cat([want[c, s, :v].long(), prev[v:]])[None]
        p1 = site_probabilities(cliques, n, thetas[c:c + 1], beta, state, v)
        u = site_uniforms(seed, keys[c:c + 1], s, n)[0, v]
        out.append((c, s, v, float(u), float(p1[0])))
    return out


def partings(seed: int, cliques: tuple, n: int, thetas: torch.Tensor,
             beta: float, num_samples: int, thin: int, burn: int,
             got: torch.Tensor, want: torch.Tensor, evidence_mask=None,
             chain_ids=None):
    """Holds ``got``, :func:`gibbs_chains`' samples at ``(num_samples,
    thin, burn)``, to ``want``, the plain version's at the same arguments.
    Both run again at every sweep: ``got`` must be the kernel's states
    after sweeps ``burn + i * thin`` (and ``want`` the plain version's,
    where the two differ), else AssertionError. Returns
    :func:`first_decisions` of the every-sweep runs: empty where ``got``
    equals ``want``."""
    sweeps = burn + (num_samples - 1) * thin + 1
    args = (seed, cliques, n, thetas, beta, sweeps, 1, 0, evidence_mask,
            chain_ids)
    every = gibbs_chains(*args)
    if not torch.equal(got, every[:, burn::thin]):
        raise AssertionError(f"the samples are not the chains' states after "
                             f"sweeps {burn} + i * {thin}")
    if torch.equal(got, want):
        return []
    want_every = gibbs_chains_reference(*args)
    if not torch.equal(want, want_every[:, burn::thin]):
        raise AssertionError(f"the plain version's samples are not its "
                             f"states after sweeps {burn} + i * {thin}")
    return first_decisions(seed, cliques, n, thetas, beta, every,
                           want_every, evidence_mask, chain_ids)


def within_ulps(u: float, p1: float, ulps: int = 2) -> bool:
    """``|u - p1|`` within ``ulps`` float32 ulps of ``p1``."""
    p = torch.tensor(p1, dtype=torch.float32)
    ulp = float(torch.nextafter(p, torch.tensor(2.0)) - p)
    return abs(u - p1) <= ulps * ulp
