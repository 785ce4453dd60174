"""Evaluation harness: fidelity / success-rate tables over a result suite
(port of :mod:`qcmrf_tpu.evaluation.harness`).

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

The ``gibbs`` and ``pam`` modes histogram the classical samplers in place
of a result file: every rep's Gibbs chain of the suite runs in one launch
of the chain kernel (thin 10, burn 10, each chain keyed by its suite
index), and each rep's perturb-and-MAP samples as rows of one map-kernel
launch. Both keep the reference's fixed norm: delta-hat is the histogram's
count over 10 000, whatever ``num_samples`` is. With ``native=True`` both
modes sample through the C++ engine instead (:mod:`qcmrf_tpu_torch.native.
kiopto`, on the host): rep i's Gibbs chain of ``num_samples * 10 + 10``
sweeps thinned ``[::10][1:]``, or its perturb-and-MAP draws, seeded
``seed + i`` (``i`` the rep's suite index).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from qcmrf_tpu_torch.evaluation import metrics
from qcmrf_tpu_torch.models.suite import ModelSuite, SHOTS
from qcmrf_tpu_torch.sim import batch as sbatch
from qcmrf_tpu_torch.utils.config import resolve_device
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


def _histograms(ids: torch.Tensor, n: int):
    """Counts ``(reps, 2**n)`` float64 of the reps' sample ids."""
    counts = torch.zeros((ids.shape[0], 1 << n), dtype=torch.float64,
                         device=ids.device)
    counts.scatter_add_(1, ids, torch.ones(ids.shape, dtype=torch.float64,
                                           device=ids.device))
    return counts.cpu().numpy()


def _gibbs_counts(suite: ModelSuite, num_samples: int, seed: int, device):
    """Per graph, the counts of its reps' Gibbs chains (thin 10, burn 10),
    every chain of the suite in one launch, each keyed by its suite
    index."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    models = []
    for j, C in enumerate(suite.graphs):
        cl = tuple(tuple(int(v) for v in c) for c in C)
        n = max(v for c in cl for v in c) + 1
        models.append((cl, n, torch.tensor(
            np.asarray(suite.thetas[j], np.float32), device=device)))
    chains = sum(m[2].shape[0] for m in models)
    rows = gibbs_kernel.gibbs_chains_multi(seed, models, 1.0, num_samples,
                                           thin=10, burn=10,
                                           chain_ids=range(chains))
    return [_histograms(gibbs_kernel.ids_from_bits(b), m[1])
            for b, m in zip(rows, models)]


def _native_counts(cliques, n: int, thetas, num_samples: int, pam: bool,
                   seed: int):
    """Counts ``(reps, 2**n)`` float64 of ``num_samples`` draws a rep from
    the C++ engine, rep r seeded ``seed + r``: perturb-and-MAP directly,
    or the reference's Gibbs flow, a chain of ``num * 10 + 10`` sweeps
    thinned ``[::10][1:]``."""
    from qcmrf_tpu_torch.native import kiopto as px

    counts = []
    for r, theta in enumerate(thetas):
        b = px.backend(cliques, np.array([2] * n))
        px.weights(b)[:] = np.asarray(theta, np.float32).astype(np.float64)
        if pam:
            S = px.sample(b, pam=True, num=num_samples, seed=seed + r)
        else:
            S = px.sample(b, num=num_samples * 10 + 10,
                          seed=seed + r)[::10][1:][:num_samples]
        ids = (S * (1 << np.arange(n - 1, -1, -1))).sum(axis=1)
        counts.append(np.bincount(ids, minlength=1 << n).astype(np.float64))
    return np.stack(counts)


def _pam_counts(cliques, n: int, thetas, num_samples: int, gen, device):
    """Counts ``(reps, 2**n)`` float64 of each rep's perturb-and-MAP
    draws."""
    from qcmrf_tpu_torch.models import sample as msample
    from qcmrf_tpu_torch.models.mrf import MRF

    ids = torch.stack([msample.sample_pam(
        gen, MRF.create(cliques, theta=th, device=device), num_samples)
        for th in thetas]).long()
    return _histograms(ids, n)


def evaluate_suite(
    suite: ModelSuite,
    dists: Optional[Sequence[Dict[str, float]]] = None,
    norm: float = SHOTS,
    mode: str = "file",
    native: bool = False,
    device=None,
    num_samples: int = SHOTS,
    seed: int = 0,
) -> List[GraphResult]:
    """Evaluate every (graph, rep) model; returns per-graph aggregates.

    ``mode='file'`` compares against measured distributions ``dists`` (one
    per circuit, suite order); ``'gibbs'``/``'pam'`` histogram
    ``num_samples`` draws of the classical samplers instead, ``seed``
    keying the chains and seeding the PAM generator, success rate over the
    fixed norm 10 000; ``native`` draws them from the C++ engine on the
    host, rep i seeded ``seed + i``. The exact distributions, and the
    samplers unless ``native``, run on ``device`` or else the current CUDA
    device (raising where there is none).
    """
    if mode not in ("file", "gibbs", "pam"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "file" and dists is None:
        raise ValueError("mode='file' requires result distributions")
    device = resolve_device(device)
    native = native and mode != "file"
    gen = None
    if mode == "pam" and not native:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    if mode == "gibbs" and not native:
        gibbs_counts = _gibbs_counts(suite, num_samples, seed, device)

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
        if native:
            sampled = _native_counts(C, n, thetas, num_samples,
                                     mode == "pam", seed + idx)
        elif mode == "gibbs":
            sampled = gibbs_counts[j]
        elif mode == "pam":
            sampled = _pam_counts(C, n, thetas, num_samples, gen, device)
        for i in range(len(thetas)):
            p = p_all[i]
            if mode == "file":
                q = np.zeros(N)
                Z = 0.0
                for k, v in dists[idx].items():
                    kid = int(k, 2)
                    if kid < N:
                        q[kid] = v
                        Z += v
                this_norm = norm
            else:
                q = sampled[i]
                Z = q.sum()
                # the reference's fixed norm: the histogram's count over
                # 10 000, not over num_samples
                this_norm = SHOTS
            q = q / Z if Z != 0 else q
            mF = float(metrics.fidelity(p, q))
            gr.fidelities.append(max(min(mF, 1.0), 0.0))
            gr.successes.append(float(Z / this_norm))
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
