"""Physical per-gate noise model calibrated to the stored hardware tables
(port of :mod:`qcmrf_tpu.noise.physical`).

Noise enters as channels where it enters on the reference's IBM backends
(resilience level 1):

1. **Gate-level depolarizing** after every lowered 1q/2q gate, inside the
   exact density-matrix engine (:mod:`qcmrf_tpu_torch.noise.density`, on
   the device), so the acceptance collapse and the post-selected fidelity
   falloff emerge from the channel.
2. **Readout confusion** at measurement: symmetric rate ``readout_sym`` on
   every measured bit, plus per-register calibration drift.
3. **Tensored readout mitigation** that inverts the backend's *assumed*
   confusion, not the true one; mitigating an ancilla confusion larger
   than the applied one pushes small-graph delta-hat above its noiseless
   value, as in the stored tables.

Per-backend parameters (the predictive fit, :func:`fit_physical_predictive`,
which made the stored calibrations):

* ``readout_sym``: true = assumed symmetric readout rate (cancels in
  expectation; gives the finite-shot negative quasi-probabilities).
* ``p2q``: one per-cx depolarizing rate; each graph's budget is
  ``lam_g = clip(p2q * ncx_g)``.
* ``var_e01``: one asymmetric readout excess on variable bits that the
  mitigation does not track.
* per graph, two mean-statistic residuals, ``var_drift`` (around
  ``var_e01``) and ``anc_drift`` (assumed-minus-true ancilla e01), and a
  temporal-jitter sigma (``jitter``), mean-one lognormal, which shapes only
  the rep-to-rep std.

Each graph's reps evolve as one batch on the device
(:func:`gate_noisy_probs_batch`); circuit ``i`` of a suite draws its shots
seeded ``circuit_seed(seed, i)`` (the JAX package splits a PRNG key per
circuit). :class:`_GraphSurrogate` evolves every rep at every anchor
budget in one batch on the device and interpolates on the host (scipy
PCHIP).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
from qcmrf_tpu_torch.circuits.lower import lower
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.noise.backends import measured_bits
from qcmrf_tpu_torch.noise.channels import ReadoutError
from qcmrf_tpu_torch.noise.density import (
    confuse_bits,
    noisy_clbit_probs_batch,
)
from qcmrf_tpu_torch.noise.mitigation import build_result_file, mitigate_counts
from qcmrf_tpu_torch.sim import sampler
from qcmrf_tpu_torch.sim.sampler import circuit_seed
from qcmrf_tpu_torch.utils.config import resolve_device

CALIBRATION_DIR = os.path.join(os.path.dirname(__file__), "calibrations")

# fraction of the per-cx depolarizing rate attached to 1q pulses (sx/x);
# IBM 1q pulse error is roughly an order of magnitude below cx error
P1Q_FRAC = 0.1


@dataclasses.dataclass(frozen=True)
class PhysicalNoiseModel:
    name: str
    scale: float
    readout_sym: float
    lam: Tuple[float, ...]        # per-graph gate-depolarizing budget
    var_drift: Tuple[float, ...]  # per-graph residual e01 around var_e01
    anc_drift: Tuple[float, ...]  # per-graph assumed-minus-true anc e01
    # per-graph temporal drift: lognormal sigma of the whole noise
    # strength from one circuit execution to the next
    jitter: Tuple[float, ...] = ()
    # the one per-backend per-cx rate of the predictive fit (lam_g =
    # clip(p2q * ncx_g)); None for per-graph fits
    p2q: Optional[float] = None
    # one per-backend unmitigated e01 excess on variable bits (true var
    # e01 = readout_sym + mult * (var_e01 + var_drift[g]))
    var_e01: float = 0.0

    def __post_init__(self):
        if not self.jitter:
            object.__setattr__(self, "jitter", (0.0,) * len(self.lam))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "PhysicalNoiseModel":
        p2q = d.get("p2q")
        return cls(
            name=d["name"], scale=float(d["scale"]),
            readout_sym=float(d["readout_sym"]),
            lam=tuple(float(x) for x in d["lam"]),
            var_drift=tuple(float(x) for x in d["var_drift"]),
            anc_drift=tuple(float(x) for x in d["anc_drift"]),
            jitter=tuple(float(x) for x in d.get("jitter", ())),
            p2q=None if p2q is None else float(p2q),
            var_e01=float(d.get("var_e01", 0.0)),
        )


def rep_multipliers(model: PhysicalNoiseModel, g: int,
                    reps: int) -> np.ndarray:
    """Deterministic per-rep noise-strength multipliers for graph ``g``:
    mean-1 lognormal draws with the graph's jitter sigma, the same draws
    in the fit and the forward emulation."""
    sigma = model.jitter[g]
    xi = np.random.RandomState(0xC0FFE + g).standard_normal(reps)
    return np.exp(sigma * xi - 0.5 * sigma * sigma)


def calibration_path(name: str, scale: float,
                     root: Optional[str] = None) -> str:
    return os.path.join(root or CALIBRATION_DIR,
                        f"{name}_{scale}.json")


def load_physical(name: str, scale: float,
                  root: Optional[str] = None) -> PhysicalNoiseModel:
    path = calibration_path(name, scale, root)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no stored physical calibration {path}; fit one with "
            "qcmrf_tpu_torch.noise.physical.fit_physical_predictive and "
            "save_physical"
        )
    with open(path) as f:
        return PhysicalNoiseModel.from_json(json.load(f))


def save_physical(model: PhysicalNoiseModel,
                  root: Optional[str] = None) -> str:
    root = root or CALIBRATION_DIR
    os.makedirs(root, exist_ok=True)
    path = calibration_path(model.name, model.scale, root)
    with open(path, "w") as f:
        json.dump(model.to_json(), f, indent=1)
    return path


# --------------------------------------------------------------------------
# Forward emulation
# --------------------------------------------------------------------------


def _register_bits(mrf: MRF) -> Tuple[List[int], List[int]]:
    """(variable clbits, ancilla clbits); workspace bit n excluded."""
    width = mrf.n + mrf.num_cliques + 1
    return list(range(mrf.n)), list(range(mrf.n + 1, width))


_E01_CAP = 0.45  # a flip rate beyond ~0.5 is unphysical (relabel) and
#                  makes the tensored mitigation inversion blow up


def true_errors(mrf: MRF, model: PhysicalNoiseModel, g: int,
                mult: float = 1.0) -> List[ReadoutError]:
    """Per-measured-bit confusion truly applied by the device emulation
    (``mult`` is the rep's temporal noise-strength multiplier)."""
    r = model.readout_sym
    vbits, abits = _register_bits(mrf)
    anc_e01 = min(r + mult * max(-model.anc_drift[g], 0.0), _E01_CAP)
    var_e01 = float(np.clip(
        r + mult * (model.var_e01 + model.var_drift[g]), 0.0, _E01_CAP))
    return ([ReadoutError(var_e01, r)] * len(vbits)
            + [ReadoutError(anc_e01, r)] * len(abits))


def assumed_errors(mrf: MRF, model: PhysicalNoiseModel, g: int,
                   mult: float = 1.0) -> List[ReadoutError]:
    """Per-measured-bit confusion the mitigation believes in (its
    calibration) and therefore inverts; the assumed ancilla gap scales
    with ``mult`` like the true one."""
    r = model.readout_sym
    vbits, abits = _register_bits(mrf)
    anc_e01 = min(r + mult * max(model.anc_drift[g], 0.0), _E01_CAP)
    return ([ReadoutError(r, r)] * len(vbits)
            + [ReadoutError(anc_e01, r)] * len(abits))


def lowered_for_noise(mrf: MRF):
    """The transpiled circuit the emulator attaches channels to: the
    fused-diagonal basis circuit (``lower(optimize=1)``), the analog of
    the reference's optimization level 1."""
    return lower(compile_qcmrf(mrf), optimize=1)


def _ncx(lc) -> int:
    return sum(1 for g in lc.gates if g.name == "cx")


def gate_noisy_probs_batch(mrfs: Sequence[MRF], lams,
                           lowered=None, device=None) -> torch.Tensor:
    """Pre-readout outcome distributions ``(B, 2^width)`` float64 of B
    gate-depolarized circuits, one density batch on ``device`` (the
    models' device unless one is named). ``lams[b]`` is circuit b's total
    budget: its per-cx rate is ``lam / ncx`` (and ``P1Q_FRAC`` of that on
    sx/x pulses)."""
    mrfs = list(mrfs)
    device = mrfs[0].device if device is None else torch.device(device)
    lcs = (list(lowered) if lowered is not None
           else [lowered_for_noise(m) for m in mrfs])
    lams = np.broadcast_to(np.asarray(lams, dtype=np.float64), (len(mrfs),))
    p2 = np.array([min(lam / max(_ncx(lc), 1), 0.75)
                   for lam, lc in zip(lams, lcs)])
    return noisy_clbit_probs_batch(lcs, p1q=P1Q_FRAC * p2, p2q=p2,
                                   device=device)


def gate_noisy_probs(mrf: MRF, lam: float, lowered=None,
                     device=None) -> torch.Tensor:
    """Pre-readout outcome distribution of the gate-depolarized circuit,
    float64 on ``device`` (the model's unless one is named).

    ``lam`` is the total depolarizing budget; the per-cx rate is
    ``lam / ncx`` (and ``P1Q_FRAC`` of that on sx/x pulses)."""
    return gate_noisy_probs_batch(
        [mrf], [lam], None if lowered is None else [lowered], device)[0]


def _confuse_reps(probs: torch.Tensor, errors: Sequence[Sequence[ReadoutError]],
                  bits: Sequence[int], width: int,
                  invert: bool = False) -> torch.Tensor:
    """Per-rep readout confusion on a ``(B, 2^width)`` batch, rep b with
    its own error list ``errors[b]``."""
    e01 = np.array([[e.e01 for e in errs] for errs in errors])
    e10 = np.array([[e.e10 for e in errs] for errs in errors])
    return confuse_bits(probs, e01, e10, bits, width, invert=invert)


def _expected_quasi_reps(mrfs: Sequence[MRF], model: PhysicalNoiseModel,
                         g: int, gate_probs: torch.Tensor,
                         mults) -> torch.Tensor:
    """:func:`expected_quasi` of a graph's reps, ``(B, 2^width)``."""
    mrf = mrfs[0]
    width = mrf.n + mrf.num_cliques + 1
    bits = measured_bits(mrf)
    q = _confuse_reps(gate_probs,
                      [true_errors(m, model, g, u)
                       for m, u in zip(mrfs, mults)], bits, width)
    return _confuse_reps(q, [assumed_errors(m, model, g, u)
                             for m, u in zip(mrfs, mults)], bits, width,
                         invert=True)


def expected_quasi(mrf: MRF, model: PhysicalNoiseModel, g: int,
                   gate_probs, mult: float = 1.0) -> torch.Tensor:
    """Infinite-shot mitigated quasi-distribution, float64: true confusion
    applied, assumed confusion inverted (mitigation is linear, so the
    expectation of the mitigated empirical dist is the mitigated expected
    dist). On the probabilities' device (a host array: the model's)."""
    if not isinstance(gate_probs, torch.Tensor):
        gate_probs = torch.as_tensor(np.asarray(gate_probs),
                                     device=mrf.device)
    return _expected_quasi_reps([mrf], model, g, gate_probs[None],
                                [mult])[0]


def _emulate_graph(seed: int, C, thetas, model: PhysicalNoiseModel, g: int,
                   mults, shots: int, gate_probs=None, stream0: int = 0,
                   device=None):
    """Forward-emulate one graph's reps: their noisy density evolution in
    one batch on ``device`` (or the precomputed ``gate_probs``), true
    readout confusion, ``shots`` sampled counts (rep r seeded
    ``circuit_seed(seed, stream0 + r)``), mitigation with the assumed
    confusion. Returns (quasi_dists, metadata, next stream)."""
    device = resolve_device(device)
    mrfs = [MRF.create(C, theta=t, device=device) for t in thetas]
    mrf = mrfs[0]
    width = mrf.n + mrf.num_cliques + 1
    bits = measured_bits(mrf)
    if gate_probs is None:
        probs = gate_noisy_probs_batch(
            mrfs, [model.lam[g] * u for u in mults], device=device)
    elif isinstance(gate_probs, torch.Tensor):
        probs = gate_probs.to(device)
    else:
        probs = torch.stack([torch.as_tensor(p, device=device)
                             for p in gate_probs])
    probs = _confuse_reps(probs, [true_errors(m, model, g, u)
                                  for m, u in zip(mrfs, mults)], bits, width)
    quasi: List[Dict[str, float]] = []
    meta: List[dict] = []
    for r, m in enumerate(mrfs):
        counts = sampler.sample_counts(circuit_seed(seed, stream0 + r),
                                       probs[r], shots, width)
        q, md = mitigate_counts(
            counts, assumed_errors(m, model, g, mults[r]),
            width, measured_bits=bits)
        quasi.append(q)
        meta.append(md)
    return quasi, meta, stream0 + len(mrfs)


def run_physical_suite(seed: int, suite, model: PhysicalNoiseModel,
                       shots: int = 10_000, device=None) -> dict:
    """Hardware-style result file from the physical emulator: per rep,
    evolve the noisy density matrix, apply true readout confusion, draw
    ``shots`` counts, and mitigate with the assumed confusion. Runs on
    ``device``, the current CUDA device unless one is named."""
    device = resolve_device(device)
    quasi: List[Dict[str, float]] = []
    meta: List[dict] = []
    stream = 0
    for j, C in enumerate(suite.graphs):
        mults = rep_multipliers(model, j, len(suite.thetas[j]))
        q, m, stream = _emulate_graph(seed, C, suite.thetas[j], model, j,
                                      mults, shots, stream0=stream,
                                      device=device)
        quasi.extend(q)
        meta.extend(m)
    return build_result_file(quasi, meta)


# --------------------------------------------------------------------------
# Fitting
# --------------------------------------------------------------------------

# the last anchor bounds the surrogate's budget domain: jittered budgets
# lam*mult evaluate clipped to it, so it must sit deep in the fully-mixed
# plateau (e^-12) where further clipping is physically negligible
ANCHORS = (0.0, 0.5, 1.5, 4.0, 12.0)


class _GraphSurrogate:
    """Per-rep pre-readout distributions as a smooth function of the
    depolarizing budget: exact density-matrix anchors (every rep at every
    anchor, one batch on the device) + monotone cubic (PCHIP)
    interpolation entrywise on the host. Also keeps each rep's exact Gibbs
    law (host float64)."""

    def __init__(self, mrf_list: List[MRF],
                 anchors: Sequence[float] = ANCHORS):
        from scipy.interpolate import PchipInterpolator

        self.anchors = np.asarray(anchors)
        self.mrfs = mrf_list
        self.device = mrf_list[0].device
        A = len(self.anchors)
        lcs = [lowered_for_noise(m) for m in mrf_list]
        rows = gate_noisy_probs_batch(
            [m for m in mrf_list for _ in range(A)],
            [lam for _ in mrf_list for lam in self.anchors],
            lowered=[lc for lc in lcs for _ in range(A)])
        self.tables = list(rows.reshape(len(mrf_list), A, -1).cpu().numpy())
        self._interp = [PchipInterpolator(self.anchors, t, axis=0)
                        for t in self.tables]
        self.gibbs = [np.asarray(m.gibbs_probs().cpu().numpy(), np.float64)
                      for m in mrf_list]

    def probs(self, lam: float) -> List[np.ndarray]:
        return [self.probs_one(r, lam) for r in range(len(self.mrfs))]

    def probs_one(self, r: int, lam: float) -> np.ndarray:
        lam = float(np.clip(lam, self.anchors[0], self.anchors[-1]))
        return np.clip(self._interp[r](lam), 0.0, None)


def _expected_stats(surr: _GraphSurrogate, model: PhysicalNoiseModel,
                    g: int, lam: float) -> Tuple[float, float, float]:
    """(mean fidelity, mean accepted mass, std of fidelity) over the
    graph's reps at budget ``lam`` under the model's readout/mitigation
    pipeline, with the model's per-rep temporal-jitter multipliers."""
    from qcmrf_tpu_torch.evaluation.metrics import fidelity

    mults = rep_multipliers(model, g, len(surr.mrfs))
    probs = torch.as_tensor(np.stack([
        surr.probs_one(r, lam * mults[r]) for r in range(len(surr.mrfs))]),
        device=surr.device)
    qs = _expected_quasi_reps(surr.mrfs, model, g, probs,
                              mults).cpu().numpy()
    fs, ds = [], []
    for r, mrf in enumerate(surr.mrfs):
        q = qs[r]
        acc = q[: 1 << mrf.n]
        Z = acc.sum()
        ds.append(float(Z / q.sum()))
        pos = np.clip(acc, 0, None)
        fs.append(float(fidelity(surr.gibbs[r],
                                 pos / max(float(pos.sum()), 1e-12))))
    return float(np.mean(fs)), float(np.mean(ds)), float(np.std(fs))


def _bisect(fn, lo: float, hi: float, iters: int = 40) -> float:
    """Root of monotone-decreasing ``fn`` on [lo, hi] (fn(lo)>0>fn(hi);
    clamps to an endpoint when the sign condition fails)."""
    flo, fhi = fn(lo), fn(hi)
    if flo <= 0:
        return lo
    if fhi >= 0:
        return hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if fn(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _surrogates(suite, device) -> List[_GraphSurrogate]:
    return [_GraphSurrogate([MRF.create(C, theta=t, device=device)
                             for t in suite.thetas[j]])
            for j, C in enumerate(suite.graphs)]


def fit_physical(
    name: str, suite, dists, norm: float = 1.0,
    readout_sym: float = 0.01, refine: int = 1, shots: int = 10_000,
    verbose: bool = False, device=None,
) -> PhysicalNoiseModel:
    """Fit the physical model to a stored hardware result file (per-graph
    budgets; the legacy unconstrained fit).

    Per graph, the gate-depolarizing budget is raised until it explains
    the measured acceptance rate or the measured mean fidelity, whichever
    binds first; per-graph readout-calibration drift then absorbs only the
    residuals. A ``refine`` pass corrects the finite-shot estimator bias
    like :func:`qcmrf_tpu_torch.noise.fit.fit_calibrated`. Runs on
    ``device``, the current CUDA device unless one is named.
    """
    from qcmrf_tpu_torch.evaluation.harness import evaluate_suite

    device = resolve_device(device)
    targets = evaluate_suite(suite, dists=dists, norm=norm, device=device)
    goal_f = [min(t.mean_f, 1.0) for t in targets]
    goal_d = [t.mean_delta for t in targets]
    eff_f, eff_d = list(goal_f), list(goal_d)

    G = len(suite.graphs)
    surrs = _surrogates(suite, device)
    if verbose:
        print(f"  {G} surrogates built")

    sigma = [0.0] * G

    def fit_pass(prev: Optional[PhysicalNoiseModel]) -> PhysicalNoiseModel:
        lam = list(prev.lam) if prev else [0.0] * G
        var_d, anc_d = [0.0] * G, [0.0] * G
        base = PhysicalNoiseModel(name, suite.scale, readout_sym,
                                  tuple([0.0] * G), tuple(var_d),
                                  tuple(anc_d), tuple(sigma))
        for j in range(G):
            surr = surrs[j]
            if prev is None:
                # budget: stop at whichever measured statistic binds first
                lam_d = _bisect(
                    lambda L: _expected_stats(surr, base, j, L)[1]
                    - eff_d[j], 0.0, ANCHORS[-1])
                lam_f = _bisect(
                    lambda L: _expected_stats(surr, base, j, L)[0]
                    - eff_f[j], 0.0, ANCHORS[-1])
                lam[j] = min(lam_d, lam_f)

            # residual fidelity: true-but-unmitigated variable e01 bias
            def f_at(v):
                m = PhysicalNoiseModel(name, suite.scale, readout_sym,
                                       tuple(lam), _one(var_d, j, v),
                                       tuple(anc_d), tuple(sigma))
                return _expected_stats(surr, m, j, lam[j])[0] - eff_f[j]
            var_d[j] = _bisect(f_at, 0.0, 0.75)

            # residual acceptance: signed ancilla calibration drift
            def d_at(d):
                m = PhysicalNoiseModel(name, suite.scale, readout_sym,
                                       tuple(lam), tuple(var_d),
                                       _one(anc_d, j, d), tuple(sigma))
                return -(_expected_stats(surr, m, j, lam[j])[1]
                         - eff_d[j])
            anc_d[j] = _bisect(d_at, -0.6, 0.6)
            if verbose:
                print(f"  graph {j}: lam={lam[j]:.4f} "
                      f"var_drift={var_d[j]:.4f} anc_drift={anc_d[j]:.4f} "
                      f"jitter={sigma[j]:.3f}")
        return PhysicalNoiseModel(name, suite.scale, readout_sym,
                                  tuple(lam), tuple(var_d), tuple(anc_d),
                                  tuple(sigma))

    model = fit_pass(None)
    for _ in range(refine):
        out = run_physical_suite(0, suite, model, shots=shots, device=device)
        got = evaluate_suite(suite, dists=out["quasi_dists"], norm=1,
                             device=device)
        # temporal jitter supplies the rep-to-rep fidelity variance the
        # current emulation is missing: the new expected jitter-std covers
        # the current expected contribution plus the measured shortfall
        for j in range(G):
            jstd_prev = _expected_stats(surrs[j], model, j,
                                        model.lam[j])[2]
            want = np.sqrt(max(
                jstd_prev ** 2 + targets[j].std_f ** 2
                - got[j].std_f ** 2, 0.0))
            if want <= 1e-5:
                sigma[j] = 0.0
                continue

            def s_at(sg, j=j, want=want):
                m = PhysicalNoiseModel(
                    name, suite.scale, readout_sym, model.lam,
                    model.var_drift, model.anc_drift, _one(sigma, j, sg))
                return want - _expected_stats(
                    surrs[j], m, j, model.lam[j])[2]
            sigma[j] = _bisect(s_at, 0.0, 1.0)
        for j in range(G):
            eff_f[j] = min(eff_f[j] + goal_f[j] - got[j].mean_f, 1.0)
            eff_d[j] *= goal_d[j] / max(got[j].mean_delta, 1e-9)
        model = fit_pass(model)
    return model


def fit_physical_predictive(
    name: str, suite, dists, norm: float = 1.0,
    readout_sym: float = 0.01, shots: int = 10_000,
    polish_rounds: int = 3, verbose: bool = False, device=None,
) -> PhysicalNoiseModel:
    """Per-backend-rate fit: the model predicts rather than describes.

    One per-cx rate ``p2q`` (every graph's budget ``lam_g = clip(p2q *
    ncx_g)``); per graph the two readout-drift residuals that touch mean
    statistics and a temporal-jitter sigma for the std column only.

    Stages: (1) probe each graph's unconstrained acceptance/fidelity
    budget and take the median per-cx rate over the interior probes; (2)
    derive budgets; (3) fit the drift residuals on the expected pipeline,
    then split the variable-bit excess into one ``var_e01`` and residuals;
    (4) bisect one seed sigma on the aggregate measured rep-to-rep
    fidelity std; (5) polish drift residuals and per-graph sigma against
    measured harness statistics with lam fixed
    (:func:`polish_physical`). Runs on ``device``, the current CUDA device
    unless one is named.
    """
    from qcmrf_tpu_torch.evaluation.harness import evaluate_suite

    device = resolve_device(device)
    targets = evaluate_suite(suite, dists=dists, norm=norm, device=device)
    goal_f = [min(t.mean_f, 1.0) for t in targets]
    goal_d = [t.mean_delta for t in targets]
    G = len(suite.graphs)
    surrs = _surrogates(suite, device)
    ncx = [_ncx(lowered_for_noise(s.mrfs[0])) for s in surrs]

    # --- stage 1: unconstrained budget probe -> robust per-cx rate ------
    base = PhysicalNoiseModel(name, suite.scale, readout_sym,
                              (0.0,) * G, (0.0,) * G, (0.0,) * G,
                              (0.0,) * G)
    rates = []
    for j in range(G):
        if ncx[j] == 0:
            continue
        lam_d = _bisect(lambda L: _expected_stats(surrs[j], base, j, L)[1]
                        - goal_d[j], 0.0, ANCHORS[-1])
        lam_f = _bisect(lambda L: _expected_stats(surrs[j], base, j, L)[0]
                        - goal_f[j], 0.0, ANCHORS[-1])
        lam_star = min(lam_d, lam_f)
        if 1e-6 < lam_star < ANCHORS[-1] - 1e-6:  # interior probes only
            rates.append(lam_star / ncx[j])
        if verbose:
            print(f"  probe g{j}: ncx={ncx[j]} lam*={lam_star:.3f}")
    if not rates:
        raise ValueError("no interior budget probe; cannot identify p2q")
    p2q = float(np.median(rates))
    lam = tuple(float(np.clip(p2q * c, 0.0, ANCHORS[-1])) for c in ncx)
    if verbose:
        print(f"  p2q={p2q:.5f}  lam={[round(v, 3) for v in lam]}")

    # --- stage 3: drift residuals on the expected pipeline --------------
    var_d, anc_d = [0.0] * G, [0.0] * G
    sigma = [0.0] * G
    var_e01 = [0.0]  # per-backend split applied after the probes

    def build():
        return PhysicalNoiseModel(name, suite.scale, readout_sym, lam,
                                  tuple(var_d), tuple(anc_d),
                                  tuple(sigma), p2q=p2q,
                                  var_e01=var_e01[0])

    for j in range(G):
        def f_at(v, j=j):
            var_d[j] = v
            return _expected_stats(surrs[j], build(), j, lam[j])[0] \
                - goal_f[j]
        var_d[j] = _bisect(f_at, 0.0, 0.75)

        def d_at(d, j=j):
            anc_d[j] = d
            return -(_expected_stats(surrs[j], build(), j, lam[j])[1]
                     - goal_d[j])
        anc_d[j] = _bisect(d_at, -0.6, 0.6)

    # the bulk of the variable-bit excess is a backend property: one
    # var_e01 with signed per-graph residuals around it (the sum, hence
    # the emulation, is unchanged)
    var_e01[0] = float(np.median(var_d))
    var_d[:] = [v - var_e01[0] for v in var_d]
    if verbose:
        print(f"  var_e01={var_e01[0]:.4f}  residuals="
              f"{[round(v, 3) for v in var_d]}")

    # --- stage 4: one temporal-jitter sigma on aggregate measured std ---
    tgt_std = float(np.mean([t.std_f for t in targets]))

    def agg_std(sg):
        sigma[:] = [sg] * G
        m = build()
        stds = [
            _measured_graph_stats(suite, m, j, shots, device=device).std_f
            for j in range(G)
        ]
        return float(np.mean(stds))

    sigma_g = _bisect(lambda sg: -(agg_std(sg) - tgt_std), 0.0, 1.0,
                      iters=6)
    sigma[:] = [sigma_g] * G
    if verbose:
        print(f"  seed jitter sigma={sigma_g:.3f}")

    # --- stage 5: measured-statistic polish ------------------------------
    return polish_physical(suite, dists, norm, build(), targets=targets,
                           shots=shots, rounds=polish_rounds,
                           verbose=verbose, fit_jitter=True, device=device)


def _measured_graph_stats(suite, model: PhysicalNoiseModel, j: int,
                          shots: int = 10_000, seed: int = 0,
                          gate_probs=None, device=None):
    """Finite-shot emulation of one graph through the harness: returns its
    GraphResult. What the expected pipeline cannot see (the Bhattacharyya
    skip rule on negative quasi-entries, the estimator's shot bias) is
    present here. ``gate_probs`` optionally supplies the per-rep
    pre-readout distributions (they depend only on lam and jitter)."""
    from qcmrf_tpu_torch.evaluation.harness import evaluate_suite
    from qcmrf_tpu_torch.models.suite import ModelSuite

    device = resolve_device(device)
    sub = ModelSuite(graphs=[suite.graphs[j]],
                     thetas={0: suite.thetas[j]}, scale=suite.scale)
    mults = rep_multipliers(model, j, len(suite.thetas[j]))
    quasi, _, _ = _emulate_graph(seed, suite.graphs[j], suite.thetas[j],
                                 model, j, mults, shots,
                                 gate_probs=gate_probs, device=device)
    return evaluate_suite(sub, dists=quasi, norm=1, device=device)[0]


def polish_physical(
    suite, dists, norm, model: PhysicalNoiseModel, targets=None,
    shots: int = 10_000, rounds: int = 3, f_tol: float = 0.008,
    d_tol: float = 0.02, verbose: bool = False, fit_jitter: bool = True,
    device=None,
) -> PhysicalNoiseModel:
    """Per-graph knob refinement against measured harness statistics:
    bisect var_drift on measured mean F, jitter on measured std F, and
    anc_drift on measured delta-hat, each against a fixed-seed finite-shot
    emulation of that single graph. Runs on ``device``, the current CUDA
    device unless one is named."""
    from qcmrf_tpu_torch.evaluation.harness import evaluate_suite

    device = resolve_device(device)
    if targets is None:
        targets = evaluate_suite(suite, dists=dists, norm=norm,
                                 device=device)
    G = len(suite.graphs)
    lam = list(model.lam)
    var_d, anc_d = list(model.var_drift), list(model.anc_drift)
    sig = list(model.jitter)

    def build():
        return PhysicalNoiseModel(model.name, model.scale,
                                  model.readout_sym, tuple(lam),
                                  tuple(var_d), tuple(anc_d), tuple(sig),
                                  p2q=model.p2q, var_e01=model.var_e01)

    probs_cache: dict = {}

    def graph_probs(j):
        """Per-rep pre-readout dists: they depend only on (lam_j,
        sigma_j), so the drift bisections reuse them."""
        key = (j, lam[j], sig[j])
        if key not in probs_cache:
            mults = rep_multipliers(build(), j, len(suite.thetas[j]))
            probs_cache.clear()  # only the current point is ever needed
            probs_cache[key] = gate_noisy_probs_batch(
                [MRF.create(suite.graphs[j], theta=t, device=device)
                 for t in suite.thetas[j]],
                [lam[j] * u for u in mults])
        return probs_cache[key]

    def measured(j):
        return _measured_graph_stats(suite, build(), j, shots,
                                     gate_probs=graph_probs(j),
                                     device=device)

    for j in range(G):
        tgt_f, tgt_sf = min(targets[j].mean_f, 1.0), targets[j].std_f
        tgt_d = targets[j].mean_delta
        for it in range(rounds):
            got = measured(j)
            err_f = abs(got.mean_f - tgt_f)
            err_sf = abs(got.std_f - tgt_sf)
            err_d = abs(got.mean_delta - tgt_d)
            if verbose:
                print(f"  polish g{j} r{it}: F {got.mean_f:.4f}/{tgt_f:.4f}"
                      f" stdF {got.std_f:.4f}/{tgt_sf:.4f}"
                      f" d {got.mean_delta:.3f}/{tgt_d:.3f}")
            ok_f = err_f <= f_tol
            # with fit_jitter=False std is not a per-graph knob; the 0.3
            # band sits well inside the stored-table pin's 0.6 relative
            # tolerance
            ok_sf = (not fit_jitter) or err_sf <= max(0.3 * tgt_sf, 0.004)
            ok_d = err_d <= d_tol
            if ok_f and ok_sf and ok_d:
                break
            if fit_jitter and not ok_sf:
                def sf_at(sg, j=j):
                    sig[j] = sg  # invalidates graph_probs' cache key
                    return measured(j).std_f - tgt_sf
                # measured std increases with sigma -> negate for _bisect
                sig[j] = _bisect(lambda sg: -sf_at(sg), 0.0, 1.0, iters=6)
            if not ok_f or not ok_sf:
                def f_at(v, j=j):
                    var_d[j] = v  # readout knob: density cache reused
                    return measured(j).mean_f - tgt_f
                # residual range: down to cancelling var_e01 entirely
                var_d[j] = _bisect(f_at, -model.var_e01, 0.75, iters=7)
            got2 = measured(j)
            if abs(got2.mean_delta - tgt_d) > d_tol:
                def d_at(d, j=j):
                    anc_d[j] = d  # readout knob: density cache reused
                    return -(measured(j).mean_delta - tgt_d)
                # wide range: _E01_CAP bounds the per-rep rate, and reps
                # with sub-1 jitter multipliers need drift headroom
                anc_d[j] = _bisect(d_at, -2.0, 2.0, iters=9)
    return build()


def _one(xs: List[float], j: int, v: float) -> Tuple[float, ...]:
    out = list(xs)
    out[j] = v
    return tuple(out)


def effective_cx_rates(suite, model: PhysicalNoiseModel,
                       device=None) -> List[float]:
    """Per-graph effective per-cx depolarizing rate (reporting aid)."""
    rates = []
    for j, C in enumerate(suite.graphs):
        mrf = MRF.create(C, theta=suite.thetas[j][0], device=device)
        rates.append(model.lam[j] / max(_ncx(lowered_for_noise(mrf)), 1))
    return rates
