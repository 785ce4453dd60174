"""Calibrate the noise emulation against stored hardware results (port of
:mod:`qcmrf_tpu.noise.fit`).

:func:`fit_depolarizing_rate` fits the per-2q-gate depolarizing rate of
the preset emulator so its expected per-graph **success rates** match the
measured ones: a global depolarizing channel leaks mass uniformly, which
leaves the post-selected fidelity near 1 at scale 0.1 but drives the
acceptance rate down strongly and monotonically. The expected statistics
have closed forms per rep, so a golden-section search suffices.

:func:`fit_calibrated` fits the per-graph calibrated emulator
(:class:`CalibratedNoiseModel`) that reproduces the stored per-graph
(F-bar, delta-hat) tables: ``var_bias`` (asymmetric flips on the variable
register) moves only the fidelity, ``anc_drop`` / ``anc_boost`` (ancilla
flips, or a mitigation that inverts a confusion never applied) only the
acceptance, so each knob solves alone: delta in closed form, F-bar by
bisection on the exact expected distributions (host numpy; width <= 10).
It is the ``calibrated:`` engine's fit when target data are given.

The models, exact laws and evaluations run on ``device``, the current CUDA
device unless the caller names one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
from qcmrf_tpu_torch.circuits.lower import basis_gate_counts
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.noise.backends import NoiseModel
from qcmrf_tpu_torch.noise.channels import ReadoutError
from qcmrf_tpu_torch.utils.config import resolve_device


def _suite_constants(suite, device=None):
    """Per-rep (ncx, noiseless delta, accepted-key fraction): everything
    the expected-success formula needs that is independent of p_dep."""
    device = resolve_device(device)
    consts = []
    for j, C in enumerate(suite.graphs):
        reps = []
        for theta in suite.thetas[j]:
            mrf = MRF.create(C, theta=theta, device=device)
            width = mrf.n + mrf.num_cliques + 1
            ncx = basis_gate_counts(compile_qcmrf(mrf)).get("cx", 0)
            reps.append((ncx, float(mrf.success_rate()),
                         (1 << mrf.n) / (1 << width)))
        consts.append(reps)
    return consts


def _expected_success_from_constants(consts, p_dep: float) -> List[float]:
    out = []
    for reps in consts:
        deltas = [
            (1.0 - p_dep) ** ncx * delta
            + (1.0 - (1.0 - p_dep) ** ncx) * frac
            for ncx, delta, frac in reps
        ]
        out.append(float(np.mean(deltas)))
    return out


def expected_graph_success(suite, p_dep: float, device=None) -> List[float]:
    """Per-graph mean success rate of the depolarized emulator (exact)."""
    return _expected_success_from_constants(
        _suite_constants(suite, device), p_dep)


def measured_graph_success(suite, dists, norm: float,
                           device=None) -> List[float]:
    from qcmrf_tpu_torch.evaluation.harness import evaluate_suite

    return [r.mean_delta for r in
            evaluate_suite(suite, dists=dists, norm=norm, device=device)]


def fit_depolarizing_rate(
    suite, dists, norm: float = 1.0,
    lo: float = 1e-5, hi: float = 0.05, iters: int = 40,
    target: List[float] = None, device=None,
) -> Tuple[float, float]:
    """Golden-section fit of p_dep to the measured per-graph success rates.

    Returns (p_dep, rms residual over the graphs).
    """
    device = resolve_device(device)
    if target is None:
        target = measured_graph_success(suite, dists, norm, device)
    target = np.asarray(target)
    consts = _suite_constants(suite, device)  # circuit stats once

    def loss(p):
        got = np.asarray(_expected_success_from_constants(consts, p))
        return float(np.mean((got - target) ** 2))

    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = loss(c), loss(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = loss(d)
    p = (a + b) / 2.0
    return p, math.sqrt(loss(p))


def fit_noise_model(
    name: str, suite, dists, norm: float = 1.0,
    readout: ReadoutError = ReadoutError(0.012, 0.028), device=None,
) -> Tuple[NoiseModel, float]:
    """Fit a full NoiseModel to a stored mitigated result file."""
    p, rms = fit_depolarizing_rate(suite, dists, norm, device=device)
    return NoiseModel(name=name, p_dep_2q=p, readout=readout,
                      mitigated=True), rms


@dataclasses.dataclass(frozen=True)
class GraphCalibration:
    var_bias: float   # e01 flip rate on variable bits (e10 = 0)
    anc_drop: float   # true unmitigated e01 on ancilla bits (delta down)
    anc_boost: float  # assumed-but-never-applied e01 inverted by
    #                   mitigation on ancilla bits (delta up)


@dataclasses.dataclass(frozen=True)
class CalibratedNoiseModel:
    """Per-graph calibration + a small symmetric true readout error that
    the mitigation inverts exactly (cancels in expectation but puts the
    finite-shot negative quasi-probabilities of the stored hardware files
    into the output)."""

    name: str
    readout_sym: float
    graphs: Tuple[GraphCalibration, ...]


def _bias_image(p: np.ndarray, b: float) -> np.ndarray:
    """Image of an n-bit pmf under per-bit confusion [[1-b, 0], [b, 1]]
    (host numpy: the bisection calls it hundreds of times a graph on
    pmfs of at most 2^5 entries)."""
    n = int(math.log2(p.size))
    q = p.astype(np.float64)
    M = np.array([[1.0 - b, 0.0], [b, 1.0]])
    for bit in range(n):
        lo, hi = 1 << bit, 1 << (n - 1 - bit)
        q = np.einsum("mt,htl->hml", M, q.reshape(hi, 2, lo)).reshape(-1)
    return q


def _fit_graph(ps, K: int, delta0: float, target_f: float,
               target_delta: float, bias_hi: float,
               iters: int) -> GraphCalibration:
    """Fit one graph's calibration from its exact per-rep Gibbs pmfs
    ``ps``, clique count ``K`` and mean noiseless acceptance ``delta0``."""
    from qcmrf_tpu_torch.evaluation.metrics import fidelity

    # --- delta knob: closed form ---------------------------------------
    c = max(target_delta, 1e-9) / delta0
    if c <= 1.0:
        anc_drop, anc_boost = 1.0 - c ** (1.0 / K), 0.0
    else:
        anc_drop, anc_boost = 0.0, 1.0 - c ** (-1.0 / K)

    # --- F-bar knob: monotone bisection on the exact expectation --------
    target_f = min(target_f, 1.0)

    def mean_f(b):
        return float(np.mean([float(fidelity(p, _bias_image(p, b)))
                              for p in ps]))

    lo, hi = 0.0, bias_hi
    if mean_f(hi) > target_f:
        b = hi  # saturated: target below the family's floor
    else:
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            if mean_f(mid) > target_f:
                lo = mid
            else:
                hi = mid
        b = 0.5 * (lo + hi)
    return GraphCalibration(var_bias=b, anc_drop=anc_drop,
                            anc_boost=anc_boost)


def fit_calibrated(
    name: str, suite, dists, norm: float = 1.0,
    readout_sym: float = 0.01, bias_hi: float = 0.75, iters: int = 50,
    refine: int = 1, shots: int = 10_000, device=None,
) -> CalibratedNoiseModel:
    """Fit per-graph (var_bias, anc_drop/boost) to a result file so the
    emulator reproduces its per-graph mean fidelity and success rate
    (targets through the same evaluation harness).

    ``refine`` extra passes correct for the finite-shot bias of the
    Bhattacharyya estimator: each re-fits against a target shifted by the
    measured gap on a fixed-seed emulator run (seed 0).
    """
    from qcmrf_tpu_torch.evaluation.harness import evaluate_suite
    from qcmrf_tpu_torch.noise.backends import run_calibrated_suite
    from qcmrf_tpu_torch.sim import batch as sbatch

    device = resolve_device(device)
    targets = evaluate_suite(suite, dists=dists, norm=norm, device=device)
    goal_f = [t.mean_f for t in targets]
    goal_d = [t.mean_delta for t in targets]
    eff_f = list(goal_f)
    eff_d = list(goal_d)

    # exact per-rep Gibbs pmfs and noiseless acceptance, once: refine
    # passes only change the targets, not the models
    graph_consts = []
    for j, C in enumerate(suite.graphs):
        p, lnz = sbatch.batched_gibbs_log_partition(C, suite.thetas[j],
                                                    device=device)
        n = max(v for c in C for v in c) + 1
        graph_consts.append((
            list(p.cpu().numpy().astype(np.float64)),
            len(C),
            float(np.mean(np.exp(lnz.cpu().numpy().astype(np.float64)
                                 - n * math.log(2.0)))),
        ))

    def fit_pass():
        cals = [
            _fit_graph(ps, K, delta0, eff_f[j], eff_d[j], bias_hi, iters)
            for j, (ps, K, delta0) in enumerate(graph_consts)
        ]
        return CalibratedNoiseModel(name=name, readout_sym=readout_sym,
                                    graphs=tuple(cals))

    model = fit_pass()
    for _ in range(refine):
        out = run_calibrated_suite(0, suite, model, shots=shots,
                                   device=device)
        got = evaluate_suite(suite, dists=out["quasi_dists"], norm=1,
                             device=device)
        for j in range(len(suite.graphs)):
            eff_f[j] += goal_f[j] - got[j].mean_f
            eff_d[j] *= goal_d[j] / max(got[j].mean_delta, 1e-9)
        model = fit_pass()
    return model
