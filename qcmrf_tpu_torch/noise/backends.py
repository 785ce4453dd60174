"""Noisy-backend presets emulating the reference's IBM hardware runs (port
of :mod:`qcmrf_tpu.noise.backends`).

Each preset fixes a per-2q-gate depolarizing rate and per-qubit readout
errors chosen to land the emulated fidelity / success-rate statistics in
the range of the stored hardware results. These are emulators that
exercise the evaluation pipeline, not device calibrations.

The outcome laws are torch ops on the model's device. Circuit ``i`` of a
suite draws its shots with :func:`qcmrf_tpu_torch.sim.sampler.sample_counts`
seeded ``circuit_seed(seed, i)``, as the statevector engine does (the JAX
package splits a PRNG key per circuit instead, so the counts differ from
its counts while following the same law).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
from qcmrf_tpu_torch.circuits.lower import basis_gate_counts
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.noise.channels import (
    ReadoutError,
    apply_readout_confusion,
    depolarize,
)
from qcmrf_tpu_torch.noise.mitigation import build_result_file, mitigate_counts
from qcmrf_tpu_torch.sim import analytic, sampler
from qcmrf_tpu_torch.sim.sampler import circuit_seed
from qcmrf_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    name: str
    p_dep_2q: float           # depolarizing rate per 2q (cx) gate
    readout: ReadoutError     # applied to every measured bit
    mitigated: bool = False   # emit quasi-dists via inverse confusion

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "NoiseModel":
        r = d["readout"]
        return cls(name=d["name"], p_dep_2q=float(d["p_dep_2q"]),
                   readout=ReadoutError(float(r["e01"]), float(r["e10"])),
                   mitigated=bool(d.get("mitigated", False)))


_PRESETS: Dict[str, NoiseModel] = {
    "torino": NoiseModel("torino", p_dep_2q=0.002,
                         readout=ReadoutError(0.012, 0.028), mitigated=True),
    "sherbrooke": NoiseModel("sherbrooke", p_dep_2q=0.0012,
                             readout=ReadoutError(0.008, 0.02),
                             mitigated=True),
    "ehningen": NoiseModel("ehningen", p_dep_2q=0.0025,
                           readout=ReadoutError(0.012, 0.03),
                           mitigated=True),
    "depolarizing": NoiseModel("depolarizing", p_dep_2q=0.002,
                               readout=ReadoutError(0.0, 0.0)),
    "readout-only": NoiseModel("readout-only", p_dep_2q=0.0,
                               readout=ReadoutError(0.015, 0.035),
                               mitigated=True),
}


def preset(name: str) -> NoiseModel:
    if name not in _PRESETS:
        raise ValueError(
            f"unknown noise preset {name!r}; have {sorted(_PRESETS)}"
        )
    return _PRESETS[name]


def measured_bits(mrf: MRF) -> List[int]:
    """Index-bit positions of the measured clbits: variables (bits 0..n-1)
    and per-clique ancillas (bits n+1..n+K). Bit ``n`` is the AND-workspace
    qubit, which the reference never measures: its clbit is always '0' in
    stored keys, so readout noise must not touch it."""
    width = mrf.n + mrf.num_cliques + 1
    return list(range(mrf.n)) + list(range(mrf.n + 1, width))


def noisy_outcome_probs(mrf: MRF, model: NoiseModel) -> torch.Tensor:
    """Ideal joint distribution pushed through depolarizing + readout, on
    the model's device."""
    width = mrf.n + mrf.num_cliques + 1
    probs = analytic.joint_outcome_probs(mrf)
    ncx = basis_gate_counts(compile_qcmrf(mrf)).get("cx", 0)
    probs = depolarize(probs, model.p_dep_2q, ncx)
    if model.readout.e01 or model.readout.e10:
        bits = measured_bits(mrf)
        probs = apply_readout_confusion(
            probs, [model.readout] * len(bits), width, measured_bits=bits
        )
    return probs


def sample_noisy_counts(seed: int, mrf: MRF, model: NoiseModel,
                        shots: int) -> Dict[str, int]:
    width = mrf.n + mrf.num_cliques + 1
    probs = noisy_outcome_probs(mrf, model)
    return sampler.sample_counts(seed, probs, shots, width)


def calibrated_outcome_probs(mrf: MRF, cal,
                             readout_sym: float) -> torch.Tensor:
    """Expected pre-mitigation outcome distribution of the calibrated
    emulator (:class:`qcmrf_tpu_torch.noise.fit.CalibratedNoiseModel`):
    variable-register flip bias (a gate-error proxy), true unmitigated
    ancilla drops, and a small symmetric true readout error on every
    measured bit."""
    n = mrf.n
    width = n + mrf.num_cliques + 1
    probs = analytic.joint_outcome_probs(mrf)
    if cal.var_bias:
        vbits = list(range(n))
        probs = apply_readout_confusion(
            probs, [ReadoutError(cal.var_bias, 0.0)] * n, width,
            measured_bits=vbits,
        )
    if cal.anc_drop:
        abits = list(range(n + 1, width))
        probs = apply_readout_confusion(
            probs, [ReadoutError(cal.anc_drop, 0.0)] * len(abits), width,
            measured_bits=abits,
        )
    if readout_sym:
        bits = measured_bits(mrf)
        probs = apply_readout_confusion(
            probs, [ReadoutError(readout_sym, readout_sym)] * len(bits),
            width, measured_bits=bits,
        )
    return probs


def _calibrated_mitigation_errors(
    mrf: MRF, cal, readout_sym: float
) -> List[ReadoutError]:
    """Assumed per-measured-bit errors the mitigation inverts: the exact
    symmetric readout on every bit, composed on ancilla bits with the
    never-applied ``anc_boost`` confusion (the deliberate mismatch whose
    inverse scales accepted mass by (1-boost)^-K: mitigation leakage)."""
    r, b = readout_sym, cal.anc_boost
    # confusion(r, r) @ confusion(b, 0) == confusion(r + b - 2rb, r)
    anc = ReadoutError(r + b - 2.0 * r * b, r)
    return [ReadoutError(r, r)] * mrf.n + [anc] * mrf.num_cliques


def run_calibrated_suite(seed: int, suite, model, shots: int = 10_000,
                         device=None) -> dict:
    """Hardware-style result file from a per-graph calibrated model
    (:class:`qcmrf_tpu_torch.noise.fit.CalibratedNoiseModel`): quasi_dists
    + measured metadata. Runs on ``device``, the current CUDA device unless
    one is named."""
    device = resolve_device(device)
    quasi: List[Dict[str, float]] = []
    meta: List[dict] = []
    for j, C in enumerate(suite.graphs):
        cal = model.graphs[j]
        for theta in suite.thetas[j]:
            mrf = MRF.create(C, theta=theta, device=device)
            width = mrf.n + mrf.num_cliques + 1
            probs = calibrated_outcome_probs(mrf, cal, model.readout_sym)
            counts = sampler.sample_counts(circuit_seed(seed, len(quasi)),
                                           probs, shots, width)
            q, m = mitigate_counts(
                counts,
                _calibrated_mitigation_errors(mrf, cal, model.readout_sym),
                width, measured_bits=measured_bits(mrf),
            )
            quasi.append(q)
            meta.append(m)
    return build_result_file(quasi, meta)


def run_noisy_suite(seed: int, suite, model: NoiseModel,
                    shots: int = 10_000, device=None):
    """Full hardware-style result file: quasi_dists + metadata if the model
    is mitigated, else a plain counts list (the reference file schemas).
    Runs on ``device``, the current CUDA device unless one is named."""
    device = resolve_device(device)
    quasi: List[Dict[str, float]] = []
    meta: List[dict] = []
    counts_list: List[Dict[str, int]] = []
    i = 0
    for j, C in enumerate(suite.graphs):
        for theta in suite.thetas[j]:
            mrf = MRF.create(C, theta=theta, device=device)
            width = mrf.n + mrf.num_cliques + 1
            counts = sample_noisy_counts(circuit_seed(seed, i), mrf, model,
                                         shots)
            i += 1
            if model.mitigated:
                bits = measured_bits(mrf)
                q, m = mitigate_counts(
                    counts, [model.readout] * len(bits), width,
                    measured_bits=bits,
                )
                quasi.append(q)
                meta.append(m)
            else:
                counts_list.append(counts)
    if model.mitigated:
        return build_result_file(quasi, meta)
    return counts_list
