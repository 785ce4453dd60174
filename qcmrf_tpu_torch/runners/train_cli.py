"""Graph specs of the command-line tools (the ported part of
:mod:`qcmrf_tpu.runners.train_cli`; the ``train`` command itself comes
with slice 4 of ROADMAP.md)."""

from __future__ import annotations

import json

from qcmrf_tpu_torch.models.mrf import grid_cliques


def parse_graph(spec: str):
    """'chain:N' | 'grid:RxC' | path to a JSON [[...], ...] clique list.
    Host-side only: no model and no device is touched."""
    if spec.startswith("chain:"):
        n = int(spec.split(":")[1])
        return [[i, i + 1] for i in range(n - 1)]
    if spec.startswith("grid:"):
        r, c = spec.split(":")[1].split("x")
        return grid_cliques(int(r), int(c))
    with open(spec) as f:
        return json.load(f)
