"""Evaluation harness: fidelity / success-rate tables over a result suite
(port of :mod:`qcmrf_tpu.evaluation.harness`, ``mode="file"``).

Same result-format sniffing (a dict with ``quasi_dists`` -> hardware with
norm 1; a bare list -> raw counts with norm 10 000), same post-selection
(keys with ``int(k, 2) < 2**n``), same aggregation (mean/std/best fidelity,
success rate ``Z/norm``, fidelity clamped to [0, 1]).

Per graph, the exact Gibbs distributions of all reps come from one
log-potential launch and their ``ln Z`` from one streaming-logsumexp launch
on ``device``, both on one coefficient table. The exact success rate
``Z / 2**n`` of each rep is kept beside the measured one in
:attr:`GraphResult.exact_deltas`, for callers that hold the sampler to
the exact law; the printed table keeps the JAX package's columns.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from qcmrf_tpu_torch.evaluation import metrics
from qcmrf_tpu_torch.models.suite import ModelSuite, SHOTS
from qcmrf_tpu_torch.sim import batch as sbatch
from qcmrf_tpu_torch.utils.table import format_table

@dataclasses.dataclass
class GraphResult:
    graph: List[List[int]]
    fidelities: List[float]
    successes: List[float]
    kls: List[float]
    #: exact success rates Z / 2**n of the reps, from the streaming lnZ;
    #: ``successes[i]`` is the measured rate (delta-hat) it is held against
    exact_deltas: List[float] = dataclasses.field(default_factory=list)

    @property
    def mean_f(self) -> float:
        return float(np.mean(self.fidelities))

    @property
    def std_f(self) -> float:
        return float(np.std(self.fidelities))

    @property
    def best_f(self) -> float:
        return float(np.max(self.fidelities))

    @property
    def mean_delta(self) -> float:
        return float(np.mean(self.successes))

    @property
    def std_delta(self) -> float:
        return float(np.std(self.successes))

    @property
    def mean_kl(self) -> float:
        return float(np.mean(self.kls))


def load_result_dists(path: str):
    """Load a result file; returns (dists, norm) with the reference's
    format sniffing."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        results_file = json.load(f)
    if isinstance(results_file, dict) and "quasi_dists" in results_file:
        return results_file["quasi_dists"], 1
    return results_file, SHOTS


def evaluate_suite(
    suite: ModelSuite,
    dists: Optional[Sequence[Dict[str, float]]] = None,
    norm: float = SHOTS,
    mode: str = "file",
    native: bool = False,
    device="cpu",
) -> List[GraphResult]:
    """Evaluate every (graph, rep) model against measured distributions
    ``dists`` (one per circuit, suite order); returns per-graph aggregates.

    Only ``mode='file'`` is ported; ``'gibbs'``/``'pam'`` and ``native``
    raise :class:`NotImplementedError`.
    """
    if native:
        raise NotImplementedError(
            "--native binds the C++ engine, which the port brings with "
            "slice 3b (sampling) of ROADMAP.md")
    if mode in ("gibbs", "pam"):
        raise NotImplementedError(
            f"mode {mode!r} needs the classical samplers, which the port "
            "brings with slice 3b (sampling) of ROADMAP.md")
    if mode != "file":
        raise ValueError(f"unknown mode {mode!r}")
    if dists is None:
        raise ValueError("mode='file' requires result distributions")

    out: List[GraphResult] = []
    idx = 0
    for j, C in enumerate(suite.graphs):
        gr = GraphResult(graph=C, fidelities=[], successes=[], kls=[])
        thetas = suite.thetas[j]
        p_all, lnz = sbatch.batched_gibbs_log_partition(C, thetas,
                                                        device=device)
        p_all = p_all.cpu().numpy().astype(np.float64)
        n = max(v for c in C for v in c) + 1
        N = 1 << n
        deltas = np.exp(lnz.cpu().numpy().astype(np.float64)
                        - n * math.log(2.0))
        for i in range(len(thetas)):
            p = p_all[i]
            q = np.zeros(N)
            Z = 0.0
            for k, v in dists[idx].items():
                kid = int(k, 2)
                if kid < N:
                    q[kid] = v
                    Z += v
            q = q / Z if Z != 0 else q
            mF = float(metrics.fidelity(p, q))
            gr.fidelities.append(max(min(mF, 1.0), 0.0))
            gr.successes.append(float(Z / norm))
            gr.kls.append(float(metrics.kl(p, q)))
            gr.exact_deltas.append(float(deltas[i]))
            idx += 1
        out.append(gr)
    return out


def results_table(results: List[GraphResult], with_kl: bool = False) -> str:
    """Render the eval table (the reference's columns, optionally +KL)."""
    header = ["graph", "fidelity", "max fidelity", "success rate"]
    if with_kl:
        header.append("KL")
    rows = []
    for r in results:
        row = [
            str(r.graph),
            "{:.3f} ±{:.3f}".format(r.mean_f, r.std_f),
            "{:.3f}".format(r.best_f),
            "{:.3f} ±{:.3f}".format(r.mean_delta, r.std_delta),
        ]
        if with_kl:
            row.append("{:.4f}".format(r.mean_kl))
        rows.append(row)
    return format_table(header, rows)
