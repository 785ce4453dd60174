"""Annealed importance sampling: a stochastic ln Z for any structure and size
(port of :mod:`qcmrf_tpu.models.ais`).

The exact backends cover bounded induced width at any n (elimination) and
any width up to n = 47 (the streaming sweeps). Past both caps AIS (Neal
2001) estimates ln Z, the clique marginals and single-variable events:

* the annealing path ``p_t(x) ~ exp(beta_t * beta * theta^T phi(x))`` runs
  from the uniform distribution (``beta_0 = 0``, ``ln Z_0 = n ln 2``) to the
  model (``beta_T = 1``) on the float32 linear schedule;
* at rung t each chain's log-weight first gains ``(beta_t - beta_{t-1}) *
  beta * theta^T phi(x)`` at its current state, then ``sweeps_per_temp``
  systematic Gibbs sweeps run at ``beta_t * beta``;
* ``ln Z_hat = n ln 2 + logsumexp(log w) - ln M`` (consistent as M grows,
  unbiased in Z, a stochastic lower bound in ln Z), reported with Kish's
  effective sample size and a delta-method standard error.

The chains are :func:`qcmrf_tpu_torch.ops.gibbs_kernel.ais_chains`: on the
card one launch of the chain kernel's AIS mode for every rung of every
chain, on the CPU its plain version. Every estimator takes an explicit
Philox ``seed`` (uint32) and ``stream``: chain c of stream s is keyed
``(seed, s * M + c)``, so successive streams of one seed draw afresh. The
functions run on the model's device (the card unless the model was made
with ``device="cpu"``). With ``mesh`` the chains shard over its devices:
shard d runs chain ids ``s * M + d * M / D ...`` in the chain kernel's AIS
mode on its own device, so every chain draws the Philox words it draws on
one device, and the estimates equal the single-device ones.
"""

from __future__ import annotations

import math

import torch

from qcmrf_tpu_torch.models.mrf import MRF

__all__ = ["ais_log_partition", "ais_clique_marginals", "ais_event_prob",
           "logpot_bits"]


def logpot_bits(mrf: MRF, bits) -> torch.Tensor:
    """``theta^T phi(x)`` float32 of bit-array states ``bits`` (``(..., n)``
    of 0 and 1, variable v at index v; no state-id width limit), summed
    over the cliques in order as the JAX package's ``logpot_bits``."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    bits = torch.as_tensor(bits, device=mrf.device)
    terms = mrf.theta[gibbs_kernel.clique_indices(
        mrf.cliques, bits.reshape(-1, mrf.n))]
    val = torch.zeros(terms.shape[0], dtype=terms.dtype, device=mrf.device)
    for term in terms.unbind(dim=-1):
        val = val + term
    return val.reshape(bits.shape[:-1])


def _run(seed: int, mrf: MRF, num_chains: int, num_temps: int,
         sweeps_per_temp: int, stream: int, mesh):
    """(log-weights float32 (M,), final bits int8 (M, n)) of the linear
    schedule: one :func:`gibbs_kernel.ais_chains` call, or with ``mesh``
    (flattened) one a shard, shard d running the chains ``d * M / D`` to
    ``(d + 1) * M / D - 1`` of the stream on its device, gathered in chain
    order on the model's device (JAX's ``_run_any``; ``M`` must divide
    over the mesh)."""
    from qcmrf_tpu_torch.ops import gibbs_kernel
    from qcmrf_tpu_torch.parallel import sharded

    M, base = int(num_chains), int(stream) * int(num_chains)
    theta = mrf.theta.detach()

    def chains(th, lo, count):
        return gibbs_kernel.ais_chains(
            seed, mrf.cliques, mrf.n, th, mrf.beta, count, int(num_temps),
            int(sweeps_per_temp), chain_ids=range(base + lo,
                                                  base + lo + count))

    if mesh is None:
        return chains(theta, 0, M)
    mesh = sharded._sweep_mesh(mesh)
    D = mesh.size
    if M % D:
        raise ValueError(f"num_chains={M} must divide over the {D}-device "
                         "mesh")
    per = M // D
    outs = sharded._run([(dev, chains, (theta.to(dev), d * per, per))
                         for d, dev in enumerate(mesh.devices)])
    return (sharded.gather([o[0] for o in outs], mrf.device, dim=0),
            sharded.gather([o[1] for o in outs], mrf.device, dim=0))


def _ess(wn: torch.Tensor) -> torch.Tensor:
    """Kish's effective sample size of normalised weights."""
    return 1.0 / torch.sum(wn * wn)


def ais_log_partition(seed: int, mrf: MRF, num_chains: int = 256,
                      num_temps: int = 128, sweeps_per_temp: int = 1,
                      return_diagnostics: bool = False, mesh=None,
                      stream: int = 0):
    """AIS estimate of ``ln Z(beta)``, float32 on the model's device.

    With ``return_diagnostics=True`` returns ``(lnZ_hat, diag)``, ``diag``
    holding ``ess`` (Kish: 1 / sum of squared normalised weights, M when
    all weights are equal), ``stderr`` (the delta-method standard error,
    the population std of the max-normalised weights over their mean times
    sqrt(M)) and ``log_weights`` (M,), for pooling runs by logsumexp less
    ln of the total. A collapsed ESS asks for more rungs."""
    logw, _ = _run(seed, mrf, num_chains, num_temps, sweeps_per_temp,
                   stream, mesh)
    M = logw.shape[0]
    ln2 = torch.log(torch.tensor(2.0, device=logw.device))
    lnZ = (mrf.n * ln2 + torch.logsumexp(logw, dim=0)
           - torch.log(torch.tensor(float(M), device=logw.device)))
    if not return_diagnostics:
        return lnZ
    r = torch.exp(logw - logw.max())
    stderr = (torch.std(r, correction=0)
              / (r.mean() * math.sqrt(float(M))))
    return lnZ, {"ess": _ess(torch.softmax(logw, dim=0)), "stderr": stderr,
                 "log_weights": logw}


def ais_event_prob(seed: int, mrf: MRF, v: int, value: int,
                   num_chains: int = 256, num_temps: int = 128,
                   sweeps_per_temp: int = 1,
                   return_diagnostics: bool = False, mesh=None,
                   stream: int = 0):
    """Self-normalised IS estimate of ``P(x_v = value)``: the final
    annealed states' weighted indicator (a ratio estimator, biased at
    finite M; ``ess`` is its health signal)."""
    logw, bits = _run(seed, mrf, num_chains, num_temps, sweeps_per_temp,
                      stream, mesh)
    wn = torch.softmax(logw, dim=0)
    p = torch.sum(wn * (bits[:, int(v)] == int(value)))
    if not return_diagnostics:
        return p
    return p, {"ess": _ess(wn), "log_weights": logw}


def ais_clique_marginals(seed: int, mrf: MRF, num_chains: int = 256,
                         num_temps: int = 128, sweeps_per_temp: int = 1,
                         return_diagnostics: bool = False, mesh=None,
                         stream: int = 0):
    """Self-normalised IS estimate of ``E_p[phi]`` in theta layout: each
    chain's clique states one-hot, weighted by its normalised importance
    weight (each clique's table sums to 1). Biased at finite M; ``ess`` is
    its health signal."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    logw, bits = _run(seed, mrf, num_chains, num_temps, sweeps_per_temp,
                      stream, mesh)
    wn = torch.softmax(logw, dim=0)
    idx = gibbs_kernel.clique_indices(mrf.cliques, bits)
    mu = torch.zeros(mrf.dimension, dtype=mrf.theta.dtype,
                     device=mrf.device)
    mu.index_add_(0, idx.reshape(-1),
                  wn[:, None].expand_as(idx).reshape(-1))
    if not return_diagnostics:
        return mu
    return mu, {"ess": _ess(wn), "log_weights": logw}
