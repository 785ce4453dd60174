"""What a kernel's work needs, as functions of the shapes, and the card's
published peaks: the yardstick of the benchmark's roofline shares.

The counts follow the port's own bound arithmetic (the sampler's Philox
words and lookups a shot, the block-invariant split sweep's operations, a
plane pass's bytes), kept here so that a change to the program cannot move
them. A share is the least time these counts allow at the peaks, over the
time the device took.
"""

from __future__ import annotations

import math
from typing import Sequence

#: NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def bound_seconds(nbytes: float = 0.0, ops: float = 0.0) -> float:
    """The least time: the larger of the bytes over the memory rate and the
    float32 operations over the float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)


# ---- the sampler -----------------------------------------------------------


def philox_ops(K: int) -> int:
    """Integer operations of Philox4x32-10 a shot: 1 + K // 4 calls, each
    10 rounds of two 32x32 -> 64-bit products (4 operations) and four XORs,
    and the key additions of rounds 1-9 (2 each)."""
    return (1 + K // 4) * (10 * (4 + 4) + 9 * 2)


def lookup_ops(cliques: Sequence[Sequence[int]]) -> int:
    """The keep-probability lookup a shot: x's mask, then per clique the
    slot word (a shift, a mask and a merge a slot), the uniform's shift,
    the compare with the table's entry and the ancilla bit."""
    return 1 + sum(3 * len(C) + 3 for C in cliques)


def sampler_ops(cliques: Sequence[Sequence[int]]) -> int:
    """Operations a shot needs: its Philox words and its lookups."""
    return philox_ops(len(cliques)) + lookup_ops(cliques)


# ---- the split sweeps ------------------------------------------------------

MAX_PARTS = 4096
MIN_BLOCK_STATES = 1024
SUB_BLOCK_BITS = 12


def split_bits(n: int) -> int:
    """Low state-id bits of a sub-block: 12, or log2 of a block's states
    when a block of the sweep over 2**n states holds fewer."""
    states = 1 << n
    parts = min(MAX_PARTS, -(-states // MIN_BLOCK_STATES))
    per_part = -(-states // parts)
    return min(SUB_BLOCK_BITS, per_part.bit_length() - 1)


def monomials(cliques: Sequence[Sequence[int]]) -> int:
    """Distinct variable sets of the cliques' subsets, the empty one
    included."""
    sets = {frozenset()}
    for C in cliques:
        for s in range(1, 1 << len(C)):
            sets.add(frozenset(v for i, v in enumerate(C) if s >> i & 1))
    return len(sets)


def split_ops(cliques: Sequence[Sequence[int]], n: int, masks: int = 0,
              per_state: int = None) -> int:
    """Float operations of one split sweep over 2**n states: the monomial
    coefficients once (an add a coefficient entry); per sub-block of 2**L
    states two a monomial and the subset-sum transform (L 2**(L-1) adds,
    twice with ``masks`` for the superset sums, and then two a mask); per
    state ``per_state``: 5 for ln Z (beta, max, difference, exp, sum), 4
    with moments, 3 for the MAP (beta, max, compare)."""
    L = split_bits(n)
    per_sub = (2 * monomials(cliques) + (L << (L - 1)) * (2 if masks else 1)
               + 2 * masks)
    if per_state is None:
        per_state = 4 if masks else 5
    coef = sum(1 << len(C) for C in cliques)
    return coef + (per_sub << (n - L)) + (per_state << n)


def reduced_pairwise(cliques: Sequence[Sequence[int]], n: int,
                     evidence: Sequence[int]):
    """(cliques, n) of the model that evidence on the variables
    ``evidence`` leaves: the pairs among the free variables, renumbered,
    and a unary clique on each free variable a pair joined to an observed
    one."""
    seen = set(int(v) for v in evidence)
    free = [v for v in range(n) if v not in seen]
    new = {v: i for i, v in enumerate(free)}
    pairs, unary = [], set()
    for C in cliques:
        kept = [v for v in C if v not in seen]
        if len(kept) == len(C):
            pairs.append(tuple(new[v] for v in C))
        elif kept:
            unary.add(new[kept[0]])
    return pairs + [(v,) for v in sorted(unary)], len(free)


# ---- plane passes ----------------------------------------------------------


def pass_bytes(width: int, read: bool = True) -> int:
    """Bytes of one pass over a state of ``width`` qubits held as two
    float32 planes: written, and also read unless it makes the state."""
    return (16 if read else 8) << width


def outcome_bytes(width: int) -> int:
    """The float32 outcome probabilities of ``width`` qubits, written once:
    all a circuit's probabilities need, however many passes make them."""
    return 4 << width


def roofline_percent(least_s: float, device_s: float):
    """The least time as a share of the device time, in %; ``None`` where
    the device time is not positive."""
    if not device_s > 0 or not math.isfinite(least_s):
        return None
    return 100.0 * least_s / device_s
