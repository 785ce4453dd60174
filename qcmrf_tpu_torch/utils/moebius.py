"""Shared multilinear (Moebius) machinery (port of
:mod:`qcmrf_tpu.utils.moebius`).

* :func:`transform` — fast Moebius (finite-difference) transform of padded
  per-clique tables, turning value tables into multilinear coefficients;
* :func:`eval_multilinear` — incremental bit-monomial chain evaluating
  ``sum_s coef(s) * prod_{i in s} bits[i]``, each subset monomial built
  from its lowest-bit predecessor;
* the deduplicated bit-monomial basis of a clique structure
  (:func:`monomial_layout`, :func:`monomial_masks`, :func:`device_masks`),
  the input of the moment sweeps, and :func:`masks_from_monomials`, the
  inverse-Moebius doubling from monomial moments to clique marginals (the
  layout part of :mod:`qcmrf_tpu.models.moments`).

The CUDA kernels evaluate the same chain in the same order
(``csrc/qcmrf_kernels.cu::moebius_chain``), so their plain versions, which
call :func:`eval_multilinear`, reproduce the kernels' float32 rounding.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, List

import numpy as np
import torch

from qcmrf_tpu_torch.utils import profiling


def transform(tab: torch.Tensor, cmax: int) -> torch.Tensor:
    """Fast Moebius transform along the slot bits of the last axis.

    ``tab``: (..., 2**cmax) padded per-clique tables, slot-encoded (bit i of
    the index <-> clique slot i). Returns the multilinear coefficients in
    the same layout; aliased padding slots produce zero coefficients.
    """
    lead = tab.shape[:-1]
    for i in range(cmax):
        t = tab.reshape(*lead, 1 << (cmax - 1 - i), 2, 1 << i)
        tab = torch.cat([t[..., :1, :], t[..., 1:, :] - t[..., :1, :]],
                        dim=-2).reshape(*lead, 1 << cmax)
    return tab


def extract_bit_planes(x: torch.Tensor, variables, n: int):
    """0/1 float32 bit-plane per variable of state ids ``x`` (variable 0 =
    MSB). Returns {var: plane}, one plane per *unique* variable."""
    return {
        v: ((x >> (n - 1 - v)) & 1).to(torch.float32)
        for v in sorted(set(variables))
    }


def eval_multilinear(bits: List, m: int, coef: Callable[[int], object],
                     acc):
    """``acc + sum_{s=0}^{2^m-1} coef(s) * prod_{i in s} bits[i]``.

    ``bits[i]`` are 0/1-valued tensors (any broadcastable shape), ``coef(s)``
    returns the coefficient for slot-subset ``s``. Each step is one product
    and one sum, rounded separately, in increasing ``s``.
    """
    prods = {0: None}
    acc = acc + coef(0)
    for s in range(1, 1 << m):
        low = s & (-s)
        rest = s ^ low
        b = bits[low.bit_length() - 1]
        p = b if prods[rest] is None else prods[rest] * b
        prods[s] = p
        acc = acc + coef(s) * p
    return acc


class MonomialLayout(
        collections.namedtuple("MonomialLayout", "cmaps m subsets")):
    """Host-side layout of the deduplicated bit-monomial basis shared by
    every clique: the union of all subsets of all cliques.

    * ``subsets[g]``: sorted variable tuple of monomial ``g`` (index 0 is
      the empty set).
    * ``cmaps[k][s]``: global monomial index of clique ``k``'s slot subset
      ``s`` (bit ``i`` of ``s`` <-> slot ``i``, i.e. ``C[i]``).
    """


@functools.lru_cache(maxsize=128)
def monomial_layout(cliques: tuple) -> MonomialLayout:
    index = {(): 0}
    cmaps = []
    for C in cliques:
        local = []
        for s in range(1 << len(C)):
            S = tuple(sorted(C[i] for i in range(len(C)) if (s >> i) & 1))
            local.append(index.setdefault(S, len(index)))
        cmaps.append(tuple(local))
    return MonomialLayout(cmaps=tuple(cmaps), m=len(index),
                          subsets=tuple(index))


@functools.lru_cache(maxsize=128)
def monomial_masks(cliques: tuple, n: int) -> np.ndarray:
    """(m,) int64: each monomial as the state-id bits of its variables
    (variable 0 is the most significant bit; a repeated variable is one
    bit, as ``b^2 = b``). ``masks[0]`` is 0, the empty monomial."""
    return np.asarray([sum(1 << (n - 1 - v) for v in set(S))
                       for S in monomial_layout(cliques).subsets], np.int64)


@functools.lru_cache(maxsize=128)
def device_masks(cliques: tuple, n: int, device: torch.device):
    """:func:`monomial_masks` on ``device``, uploaded once per structure
    (a training run sweeps one structure every step)."""
    masks = torch.from_numpy(monomial_masks(cliques, n))
    with profiling.span("qcmrf.wait"):
        return masks.to(device)


@functools.lru_cache(maxsize=128)
def _inverse_moebius_plan(cliques: tuple):
    """Per clique size c: (monomial index of every slot subset, (K_c,
    2^c); theta position each doubled entry lands at, (K_c, 2^c))."""
    layout = monomial_layout(cliques)
    groups = {}
    off = 0
    for k, C in enumerate(cliques):
        c = len(C)
        # slot-bitmask order -> theta's y index (y[0] slowest) is the
        # c-bit reversal, its own inverse
        rev = [int(format(s, f"0{c}b")[::-1], 2) for s in range(1 << c)]
        gidx, pos = groups.setdefault(c, ([], []))
        gidx.append(layout.cmaps[k])
        pos.append([off + r for r in rev])
        off += 1 << c
    return {c: (np.asarray(g, np.int64), np.asarray(p, np.int64))
            for c, (g, p) in groups.items()}


def masks_from_monomials(mono: torch.Tensor, cliques: tuple):
    """theta-layout moments ``E_p[phi]`` from monomial moments ``E_p[prod
    b]`` by the inverse-Moebius doubling per clique: per slot ``(without,
    with) -> (without - with, with)``, pairwise differences of
    probabilities (no signed 2^|C|-term sums), all cliques of one size at
    once."""
    out = torch.empty(sum(1 << len(C) for C in cliques), dtype=mono.dtype,
                      device=mono.device)
    for c, (gidx, pos) in _inverse_moebius_plan(cliques).items():
        with profiling.span("qcmrf.wait"):
            gidx_d = torch.from_numpy(gidx).to(mono.device)
            pos_d = torch.from_numpy(pos).to(mono.device)
        tab = mono[gidx_d]
        for i in range(c):
            t = tab.reshape(len(gidx), 1 << (c - 1 - i), 2, 1 << i)
            tab = torch.cat([t[:, :, :1] - t[:, :, 1:], t[:, :, 1:]], dim=2)
        out[pos_d] = tab.reshape(len(gidx), -1)
    return out
