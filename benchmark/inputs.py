"""The benchmark's inputs, made from ``--seed``: a configuration's
structure and parameters, and seeded generators for each purpose."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

#: one stream of random numbers per purpose, so that adding a draw to one
#: leaves the others as they were
PURPOSES = ("theta", "data", "order", "sample", "start", "warm")


def cliques(config: dict) -> List[Tuple[int, ...]]:
    """The configuration's cliques over ``n`` variables.

    Where ``cliques`` is a list (of variable lists), it is the structure,
    in its order; each clique holds distinct variables below ``n``. (A
    number there is only the count, for the reader.) Otherwise ``graph``
    gives it: ``chain`` (edges (i, i+1)), ``complete`` (every pair i < j,
    in order) or ``grid`` (``rows`` x ``cols``, variable ``r * cols + c``;
    for each cell row-major its right neighbour, then the one below: the
    order of the program's ``grid_cliques``)."""
    n = int(config["n"])
    stated = config.get("cliques")
    if isinstance(stated, (list, tuple)):
        out = []
        for C in stated:
            if (not isinstance(C, (list, tuple)) or not C
                    or len(set(C)) != len(C)
                    or not all(type(v) is int and 0 <= v < n for v in C)):
                raise ValueError(f"clique {C!r}: distinct variables "
                                 f"below n = {n} expected")
            out.append(tuple(C))
        return out
    graph = config["graph"]
    if graph == "chain":
        return [(i, i + 1) for i in range(n - 1)]
    if graph == "complete":
        return [(i, j) for i in range(n) for j in range(i + 1, n)]
    if graph == "grid":
        rows, cols = int(config["rows"]), int(config["cols"])
        if rows * cols != n:
            raise ValueError(f"a {rows}x{cols} grid has {rows * cols} "
                             f"variables, not n = {n}")
        out = []
        for v in range(n):
            if (v + 1) % cols:
                out.append((v, v + 1))
            if v + cols < n:
                out.append((v, v + cols))
        return out
    raise ValueError(f"unknown graph {graph!r}")


def dimension(cl) -> int:
    return sum(1 << len(C) for C in cl)


def seed_words(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed (any size)."""
    words = np.random.SeedSequence(
        [int(seed) % (1 << 64), PURPOSES.index(purpose)])
    return int(words.generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A torch generator on ``device`` for ``purpose``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed_words(seed, purpose))
    return g


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy generator on the host for ``purpose``."""
    return np.random.default_rng(seed_words(seed, purpose))


def neg_half_normal(d: int, scale: float, g: torch.Generator,
                    device) -> torch.Tensor:
    """``-|N(0, 1)| * scale``, float32, drawn on ``device``."""
    z = torch.randn(d, generator=g, device=device, dtype=torch.float32)
    return -z.abs() * float(scale)
