"""Tensored readout-error mitigation producing quasi-probability dists
(port of :mod:`qcmrf_tpu.noise.mitigation`; host numpy, as there).

Applying the *inverse* readout confusion to an empirical counts
distribution gives a quasi-probability distribution that can hold
negative entries, the statistical signature of a hardware run at
resilience level 1, plus per-circuit metadata with the mitigation
overhead, in the stored hardware files' schema.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from qcmrf_tpu_torch.noise.channels import ReadoutError, mitigation_overhead
from qcmrf_tpu_torch.utils.bits import key_string

WARNING = "Emulated backend (qcmrf_tpu_torch noise model), not hardware"


def mitigate_counts(
    counts: Dict[str, int],
    errors: Sequence[ReadoutError],
    width: int,
    measured_bits: Optional[Sequence[int]] = None,
) -> Tuple[Dict[str, float], dict]:
    """Invert per-bit confusion over a counts dict.

    Returns ``(quasi_dist, metadata)`` in the stored hardware schema:
    quasi-probabilities summing to 1 (possibly negative entries) and
    metadata with ``shots``, ``readout_mitigation_overhead`` and
    ``readout_mitigation_time``, the host's wall seconds of the inversion.
    ``measured_bits`` restricts the inversion to the bits that carry a
    real measurement (the AND-workspace bit never does).
    """
    t0 = time.perf_counter()
    if measured_bits is None:
        measured_bits = range(width)
    shots = sum(counts.values())
    dense = np.zeros(1 << width, dtype=np.float64)
    for k, v in counts.items():
        dense[int(k, 2)] += v / shots

    # tensored inverse confusion, bit by bit (bit b = key char width-1-b)
    for bit, err in zip(measured_bits, errors):
        lo = 1 << bit
        hi = 1 << (width - 1 - bit)
        dense = np.einsum(
            "mt,htl->hml", err.inverse, dense.reshape(hi, 2, lo)
        ).reshape(-1)

    quasi = {
        key_string(i, width): float(p)
        for i, p in enumerate(dense)
        if p != 0.0
    }
    # the keys of the stored hardware rows: shots, circuit_metadata (an
    # empty dict in every stored row), the two mitigation stats and the
    # runtime's warning string, which here names the emulation
    meta = {
        "shots": shots,
        "circuit_metadata": {},
        "readout_mitigation_overhead": mitigation_overhead(
            errors[: len(list(measured_bits))]
        ),
        "readout_mitigation_time": time.perf_counter() - t0,
        "warning": WARNING,
    }
    return quasi, meta


def build_result_file(
    quasi_dists: List[Dict[str, float]], metadata: List[dict]
) -> dict:
    """Hardware result-file schema (``res_*/result_torino.json``)."""
    return {"quasi_dists": quasi_dists, "metadata": metadata}
