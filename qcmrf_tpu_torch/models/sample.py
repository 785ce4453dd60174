"""MAP states and the exact sampler (the ported part of
:mod:`qcmrf_tpu.models.sample`).

* :func:`sample_exact`: IID draws from the Gibbs distribution by the
  ``2**n`` logits of the log-potential kernel;
* :func:`map_state`: the argmax of the log-potential table (on the card
  the streaming argmax kernel, :func:`kernels.map_state_streaming`);
* :func:`map_state_clamped`: the evidence-constrained MAP (MPE) for any
  clique structure, by exact clique-table reduction
  (:func:`qcmrf_tpu_torch.models.moments.reduce_evidence`) and the
  streaming argmax kernel on the free-variable model.

The other samplers (bit-array Gibbs, perturb-and-MAP, and the conditional
sampler that routes among them) come with slice 3b of ROADMAP.md; they
raise :class:`NotImplementedError` until then.
"""

from __future__ import annotations

import torch

from qcmrf_tpu_torch.models.mrf import MRF

#: sample_exact: most ``num_samples * num_states`` for the single-stage
#: draw (its Gumbel matrix holds that many floats); bigger draws split
#: into the exact two-stage block categorical
_CATEGORICAL_BUDGET = 1 << 28


def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [0, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u))


def sample_exact(generator, mrf: MRF, num_samples: int) -> torch.Tensor:
    """IID exact samples (int32 state ids, on ``mrf``'s device) from the
    Gibbs distribution, by the Gumbel-max categorical over the ``2**n``
    logits ``beta * theta^T phi(x)`` of the log-potential kernel.
    ``generator`` is a ``torch.Generator`` on ``mrf``'s device, or an
    integer seed for one. Past ``_CATEGORICAL_BUDGET`` (``num_samples *
    2**n`` Gumbel values) the draw splits, as the JAX package's does, into
    the exact two-stage categorical: a block of ``2**(n // 2)`` states by
    the blocks' logsumexp masses, then a state within it, so both stages'
    noise stays at ``num_samples * 2**((n + 1) // 2)`` values. JAX's keys
    give other numbers than a ``torch.Generator``: the two agree in
    distribution, not draw for draw."""
    dev = mrf.device
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    with torch.no_grad():
        logits = mrf.beta * mrf.all_log_potentials()
        n = mrf.n
        if num_samples * (1 << n) <= _CATEGORICAL_BUDGET:
            g = _gumbel(generator, (num_samples, 1 << n), dev)
            return (g + logits).argmax(dim=-1).to(torch.int32)
        nblk = 1 << ((n + 1) // 2)
        per = logits.reshape(nblk, -1)
        g = _gumbel(generator, (num_samples, nblk), dev)
        blk = (g + torch.logsumexp(per, dim=1)).argmax(dim=-1)
        del g
        g = _gumbel(generator, (num_samples, per.shape[1]), dev)
        within = g.add_(per[blk]).argmax(dim=-1)
        return (blk * per.shape[1] + within).to(torch.int32)


def map_state(mrf: MRF) -> torch.Tensor:
    """Exact MAP state id (argmax of the Gibbs distribution; the first
    maximum on ties), as a 0-d int64 tensor on ``mrf``'s device:
    :func:`kernels.map_state_streaming`'s, which picks the route for the
    device (the chain's table on the CPU, the streaming argmax on the
    card, whose table is the split's)."""
    from qcmrf_tpu_torch.ops import kernels

    return torch.tensor(kernels.map_state_streaming(mrf)[0],
                        device=mrf.device)


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


sample_gibbs = _sampler("sample_gibbs")
sample_gibbs_bits = _sampler("sample_gibbs_bits")
sample_pam = _sampler("sample_pam")
sample_pam_streaming = _sampler("sample_pam_streaming")
sample_conditional = _sampler("sample_conditional")
