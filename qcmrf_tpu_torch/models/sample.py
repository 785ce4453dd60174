"""MAP states (the ported part of :mod:`qcmrf_tpu.models.sample`).

* :func:`map_state`: the argmax of the log-potential table;
* :func:`map_state_clamped`: the evidence-constrained MAP (MPE) for any
  clique structure, by exact clique-table reduction
  (:func:`qcmrf_tpu_torch.models.moments.reduce_evidence`) and the
  streaming argmax kernel on the free-variable model.

The samplers (exact table, bit-array Gibbs, perturb-and-MAP, and the
conditional sampler that routes among them) come with slice 3b of
ROADMAP.md; they raise :class:`NotImplementedError` until then.
"""

from __future__ import annotations

import torch

from qcmrf_tpu_torch.models.mrf import MRF


def map_state(mrf: MRF) -> torch.Tensor:
    """Exact MAP state id (argmax of the Gibbs distribution; the first
    maximum on ties), from the log-potential table."""
    return torch.argmax(mrf.all_log_potentials())


def map_state_clamped(mrf: MRF, evidence: dict, mesh=None):
    """Exact evidence-constrained MAP for any clique structure:
    ``(state_id, beta * theta^T phi(x))`` as host numbers. The evidence
    clamps by exact clique-table reduction, the free-variable model runs
    the streaming argmax (:func:`kernels.map_state_streaming`), and the
    winner's bits re-embed around the evidence."""
    from qcmrf_tpu_torch.models import moments
    from qcmrf_tpu_torch.ops import kernels

    moments._no_mesh(mesh)
    red, const = moments.reduce_evidence(mrf, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    n = mrf.n
    base = 0
    for v, b in ev.items():
        base |= b << (n - 1 - v)
    offset = float(mrf.beta) * float(const)
    if red is None:
        return base, offset
    rid, val = kernels.map_state_streaming(red)
    free = [v for v in range(n) if v not in ev]
    nf = len(free)
    for j, v in enumerate(free):
        base |= ((rid >> (nf - 1 - j)) & 1) << (n - 1 - v)
    return base, val + offset


def _sampler(name: str):
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"{name} comes to the port with slice 3b (sampling) of "
            "ROADMAP.md")

    unported.__name__ = name
    unported.__doc__ = f"``{name}`` of the JAX package: slice 3b."
    return unported


sample_exact = _sampler("sample_exact")
sample_gibbs = _sampler("sample_gibbs")
sample_gibbs_bits = _sampler("sample_gibbs_bits")
sample_pam = _sampler("sample_pam")
sample_pam_streaming = _sampler("sample_pam_streaming")
sample_conditional = _sampler("sample_conditional")
