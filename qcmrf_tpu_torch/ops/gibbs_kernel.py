"""Systematic-scan Gibbs chains in one launch (the chains of
:func:`qcmrf_tpu.models.sample.sample_gibbs` and ``sample_gibbs_bits``).

:func:`gibbs_chains` runs C independent single-site chains of one clique
structure, chain c on the model ``(cliques, n, thetas[c], beta)``: each
sweep visits the sites in order, variable 0 first, and draws site v from
``p(x_v = 1 | rest) = sigmoid(beta * delta)``, ``delta`` the difference of
the log-potential with x_v = 1 and with x_v = 0, summed over the cliques
that hold v only (:func:`chain_tables`: a host-built list of (clique,
slot) items per variable, the JAX package's ``bits_site_delta_fn``).

Random words come from Philox4x32-10 keyed on ``(seed, chain id)``: the
bit of site v in sweep s is ``u < p1``, ``u = (w >> 8) * 2^-24`` and ``w``
word ``v % 4`` of counter ``(s, v // 4, 0, 0)``; the initial bit of a free
site is bit 0 of word ``v % 4`` of counter ``(0, v // 4, 1, 0)``. A chain's
draws depend on its seed and id only, not on the other chains of its
launch. The JAX package draws from ``jax.random`` keys: the two agree in
distribution, not draw for draw.

On a CUDA tensor :func:`gibbs_chains` launches ``gibbs_kernel`` of
``csrc/gibbs_kernels.cu`` (one warp a chain, the structure tables in
shared memory, a site's items over the warp's lanes); on a CPU tensor it
runs :func:`gibbs_chains_reference`, the same Philox words and the same
float32 sums in the same order (:func:`warp_sum`) in plain PyTorch,
vectorised over the chains. The JAX package has no Pallas
kernel here: its chains are ``lax.scan`` loops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from qcmrf_tpu_torch.ops import _build
from qcmrf_tpu_torch.ops.sampler_kernel import philox4x32_10

#: launches of the CUDA kernel, bumped where it is launched
LAUNCHES = {"gibbs": 0}

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

    @property
    def shared_bytes(self) -> int:
        """The kernel's shared memory: the tables, then a float32 uniform,
        the evidence and the state a site."""
        n = len(self.heads) - 1
        return (16 * len(self.items) + 8 * len(self.others) + 4 * (n + 1)
                + 6 * n)


@functools.lru_cache(maxsize=256)
def chain_tables(cliques: tuple, n: int) -> ChainTables:
    """The site tables of ``(cliques, n)``."""
    offs = np.cumsum([0] + [1 << len(C) for C in cliques])
    if offs[-1] > 0x7FFFFFFF:
        raise ValueError(f"theta of {offs[-1]} entries; the chain takes "
                         "int32 offsets")
    touch = [[] for _ in range(n)]
    for k, C in enumerate(cliques):
        for j in range(len(C)):
            touch[C[j]].append((k, j))
    heads, items, others = [0], [], []
    for v in range(n):
        for k, j in touch[v]:
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
    """``gibbs_kernel``'s float32 sum of the rows of ``x`` (C, I): lane l
    of a warp adds entries l, l + 32, ... in turn from 0, then the 32 lane
    sums are added pairwise, halves first (the shuffle butterfly)."""
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
    the states ``bits``: the kernel's float32 arithmetic on
    :func:`site_deltas`."""
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
    """Plain PyTorch version of :func:`gibbs_chains`, on any device: the
    same Philox words and the same float32 arithmetic in the same order,
    vectorised over the chains, a Python loop over sweeps and sites."""
    sweeps = _check(cliques, n, thetas, num_samples, thin, burn)
    dev = thetas.device
    C = thetas.shape[0]
    keys = _chain_keys(chain_ids, C, dev)
    ev = _evidence(evidence_mask, n, dev)
    free = [v for v in range(n) if ev is None or int(ev[v]) < 0]
    bits = initial_bits(seed, keys, n, ev)
    out = torch.empty((C, num_samples, n), dtype=torch.int8, device=dev)
    for s in range(sweeps):
        u = site_uniforms(seed, keys, s, n)
        for v in free:
            p1 = site_probabilities(cliques, n, thetas, beta, bits, v)
            bits[:, v] = (u[:, v] < p1).to(torch.int64)
        if s >= burn and (s - burn) % thin == 0:
            out[:, (s - burn) // thin] = bits.to(torch.int8)
    return out


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
    On a CPU tensor: :func:`gibbs_chains_reference`."""
    _build.refuse_grad(thetas, "thetas")
    if thetas.device.type == "cpu":
        return gibbs_chains_reference(seed, cliques, n, thetas, beta,
                                      num_samples, thin, burn,
                                      evidence_mask, chain_ids)
    sweeps = _check(cliques, n, thetas, num_samples, thin, burn)
    dev = thetas.device
    C = thetas.shape[0]
    _build.check(thetas, "thetas", torch.float32, thetas.shape, dev)
    tab = chain_tables(cliques, n)
    smem = tab.shared_bytes
    if smem > _build.SHARED_BYTES_LIMIT:
        raise ValueError(f"the chain's tables need {smem} bytes of shared "
                         f"memory; a block holds at most "
                         f"{_build.SHARED_BYTES_LIMIT}")
    heads, items, others = _device_tables(cliques, n, dev)
    keys = _chain_keys(chain_ids, C, dev).to(torch.int32).contiguous()
    ev = _evidence(evidence_mask, n, dev)
    out = torch.empty((C, num_samples, n), dtype=torch.int8, device=dev)
    _build.launch("qcmrf_gibbs", dev, seed & _MASK32, _build.ptr(keys),
                  _build.ptr(thetas), thetas.shape[1], float(beta), n,
                  _build.ptr(heads), _build.ptr(items), len(tab.items),
                  _build.ptr(others), len(tab.others),
                  _build.ptr(ev) if ev is not None
                  else _build.ctypes.c_void_p(0), C, sweeps, burn, thin,
                  num_samples, _build.ptr(out), smem)
    LAUNCHES["gibbs"] += 1
    return out


@functools.lru_cache(maxsize=256)
def _device_tables(cliques: tuple, n: int, device: torch.device):
    """``(heads, items, others)`` on ``device`` (one dummy row where a
    table is empty)."""
    tab = chain_tables(cliques, n)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a if len(a) else np.zeros((1,) + a.shape[1:], np.int32))).to(device)
        for a in tab)


#: the steps that ``gibbs_latency_kernel`` times, in its order
LATENCY_STEPS = ("shared_load", "ldg_l1", "shuffle_add", "p1_tail",
                 "bit_round_trip", "fadd")


def latency_cycles(device, steps: int = 4096) -> dict:
    """Clock cycles of each dependent step of a site update
    (:data:`LATENCY_STEPS`), each the mean of ``steps`` repeats by one warp
    of ``gibbs_latency_kernel``, and ``sm_ghz``, the SM clock while it
    ran. A probe of the card: the sampler never calls it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the latency probe runs on a CUDA device")
    chase = torch.roll(torch.arange(256, dtype=torch.int32), -1).to(dev)
    out = torch.zeros(8, dtype=torch.int64, device=dev)
    sink = torch.empty(32, dtype=torch.int32, device=dev)
    _build.launch("qcmrf_gibbs_latency", dev, _build.ptr(chase), steps, 1.0,
                  _build.ptr(out), _build.ptr(sink))
    o = out.cpu().tolist()
    cycles = {k: o[i] / steps for i, k in enumerate(LATENCY_STEPS)}
    return dict(cycles, sm_ghz=o[6] / o[7])


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
