"""Shared multilinear (Moebius) machinery (port of
:mod:`qcmrf_tpu.utils.moebius`).

* :func:`transform` — fast Moebius (finite-difference) transform of padded
  per-clique tables, turning value tables into multilinear coefficients;
* :func:`eval_multilinear` — incremental bit-monomial chain evaluating
  ``sum_s coef(s) * prod_{i in s} bits[i]``, each subset monomial built
  from its lowest-bit predecessor.

The CUDA kernels evaluate the same chain in the same order
(``csrc/qcmrf_kernels.cu::moebius_chain``), so their plain versions, which
call :func:`eval_multilinear`, reproduce the kernels' float32 rounding.
"""

from __future__ import annotations

from typing import Callable, List

import torch


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
