"""The experiment model suite: 7 graphs x 10 reps x prior scale (port of
:mod:`qcmrf_tpu.models.suite`).

:func:`generate_suite` seeds numpy's *global* legacy RNG with 1984 and
draws ``-halfnorm.rvs(scale)`` per (graph, rep), exactly as the JAX package
does, so both give the same thetas bit for bit; :meth:`ModelSuite.save`
writes the same bytes. Thetas stay host-side Python floats until a model is
built on a device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from qcmrf_tpu_torch.models.mrf import MRF

# The fixed 7-graph suite.
GRAPHS: List[List[List[int]]] = [
    [[0]],
    [[0, 1]],
    [[0, 1], [1, 2], [2, 3]],
    [[0, 1], [1, 2], [2, 3], [3, 4]],
    [[0, 1, 2]],
    [[0, 1, 2], [2, 3, 4]],
    [[0, 1, 2, 3]],
]

REPS = 10
SHOTS = 10_000
SCALES = (0.1, 0.25, 0.5)
SEED = 1984


def _dim(cliques: Sequence[Sequence[int]]) -> int:
    return sum(1 << len(C) for C in cliques)


@dataclass(frozen=True)
class ModelSuite:
    """A full suite: per-graph lists of theta draws."""

    graphs: List[List[List[int]]]
    thetas: Dict[int, List[List[float]]]  # graph index -> reps x d
    scale: float

    @property
    def num_circuits(self) -> int:
        return sum(len(v) for v in self.thetas.values())

    def mrfs(self, device=None) -> List[MRF]:
        """All (graph, rep) models in suite order (graph-major), on
        ``device`` (the current CUDA device unless one is named)."""
        out = []
        for j, C in enumerate(self.graphs):
            for theta in self.thetas[j]:
                out.append(MRF.create(C, theta=theta, device=device))
        return out

    def to_json_dict(self) -> dict:
        """Same schema as the stored ``models_{scale}.json`` files."""
        return {
            "GRAPHS": self.graphs,
            "THETAS": {str(k): v for k, v in self.thetas.items()},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(self.to_json_dict(), indent=4))


def generate_suite(
    scale: float, reps: int = REPS, seed: Optional[int] = SEED
) -> ModelSuite:
    """Regenerate the suite: seeds the *global* legacy numpy RNG and draws
    ``-halfnorm.rvs(scale, size=d)`` per (graph, rep), graph-major."""
    from scipy.stats import halfnorm

    if seed is not None:
        np.random.seed(seed)
    thetas: Dict[int, List[List[float]]] = {}
    for j, C in enumerate(GRAPHS):
        d = _dim(C)
        for _ in range(reps):
            theta = -halfnorm.rvs(loc=0, scale=float(scale), size=d)
            thetas.setdefault(j, []).append(theta.tolist())
    return ModelSuite(graphs=[list(map(list, g)) for g in GRAPHS],
                      thetas=thetas, scale=float(scale))


def load_suite(path: str, scale: Optional[float] = None) -> ModelSuite:
    """Load a stored ``models_{scale}.json``."""
    with open(path) as f:
        R = json.load(f)
    thetas = {int(k): v for k, v in R["THETAS"].items()}
    if scale is None:
        base = os.path.basename(path)
        try:
            scale = float(base.replace("models_", "").replace(".json", ""))
        except ValueError:
            scale = float("nan")
    return ModelSuite(graphs=R["GRAPHS"], thetas=thetas, scale=scale)


def reference_models_path(scale: float, root: str) -> str:
    """``<root>/res_{scale}/models_{scale}.json``, or the plain
    ``models.json`` name that the scale-0.5 folder uses."""
    p = os.path.join(root, f"res_{scale:g}", f"models_{scale:g}.json")
    if os.path.isfile(p):
        return p
    return os.path.join(root, f"res_{scale:g}", "models.json")


def reference_results_path(scale: float, backend: str, root: str) -> str:
    """``<root>/res_{scale}/result_{backend}.json``."""
    return os.path.join(root, f"res_{scale:g}", f"result_{backend}.json")
