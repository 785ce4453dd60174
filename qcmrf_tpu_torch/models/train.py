"""Maximum-likelihood MRF training (port of :mod:`qcmrf_tpu.models.train`).

Fits ``theta`` to observed samples by gradient descent on the exact
negative log-likelihood. The gradient ``beta * (E_p[phi] - E_data[phi])``
comes from autograd through the lnZ router (:func:`make_lnz_fn`):

* enumeration (n <= 22): :meth:`MRF.log_partition`, whose backward is the
  moments of the fused lnZ + moments sweep (``lnz_moments_kernel`` on the
  card; the JAX package autodiffs a ``2**n`` table there);
* variable elimination for bounded induced width at any n (torch ops,
  autograd through them);
* past the width cap, the same fused sweep as
  :func:`qcmrf_tpu_torch.models.moments.log_partition_streaming`.

Two steps take the model moments from samplers instead: post-selected
circuit shots (:func:`make_shots_train_step`) and, past both exact caps,
annealed importance sampling (:func:`make_ais_train_step`, ESS-gated).

optax becomes ``torch.optim``: :func:`adam` is ``torch.optim.Adam`` with
optax's update (betas 0.9 and 0.999, eps 1e-8 outside the square root, no
weight decay), and ``optax.sgd`` is ``torch.optim.SGD``. ``raw``, the
unconstrained parameters, is a leaf tensor on the model's device that the
optimizer updates in place; a step zeroes the gradient, runs backward,
steps, and returns the loss evaluated before the update, as the JAX step
does. ``theta <= 0`` is kept by a softplus reparameterisation when
``nonpositive``. :func:`adam_from_numpy` carries an optax Adam state
across.

Over a device mesh (:mod:`qcmrf_tpu_torch.parallel.sharded`):
:func:`make_sharded_train_step` on a 2-D ``(amp, data)`` mesh (lnZ sharded
over ``amp``, the batch over ``data``), the shot step's draws sharded over
every device, the AIS step's chains likewise, and the streaming lnZ of
:func:`make_lnz_fn` sharded over the flattened mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.utils import profiling


def _nll(mrf: MRF, theta: torch.Tensor, data) -> torch.Tensor:
    lnZ = make_lnz_fn(mrf)(theta)
    return lnZ - mrf.beta * mrf.with_theta(theta).log_potential(data).mean()


@dataclasses.dataclass
class TrainState:
    raw: torch.Tensor                 # unconstrained parameters, a leaf
    optimizer: torch.optim.Optimizer  # holds the optimizer state
    step: int = 0


def _to_theta(raw: torch.Tensor, nonpositive: bool) -> torch.Tensor:
    return -torch.nn.functional.softplus(raw) if nonpositive else raw


def _from_theta(theta, nonpositive: bool) -> torch.Tensor:
    """``raw`` for ``theta``: a new tensor (not yet requiring grad)."""
    theta = torch.as_tensor(theta).detach()
    if not nonpositive:
        return theta.clone()
    t = torch.clamp(theta, max=-1e-4)
    # inverse softplus: raw = log(exp(-theta) - 1)
    return torch.log(torch.expm1(-t))


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)`` as ``torch.optim.Adam``."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)


def adam_from_numpy(raw, mu, nu, count, lr: float, device=None):
    """Carry optax Adam state across: ``(raw, optimizer)``, ``raw`` a leaf
    tensor on ``device`` (the current CUDA device unless one is named) and
    a ``torch.optim.Adam`` whose state holds the first and second moments
    ``mu`` and ``nu`` and the step ``count`` (optax's
    ``ScaleByAdamState``), so that a JAX run continues in the port."""
    from qcmrf_tpu_torch.utils.config import resolve_device

    device = resolve_device(device)
    raw = torch.tensor(np.asarray(raw, np.float32), device=device,
                       requires_grad=True)
    opt = adam([raw], lr)
    state = opt.state_dict()
    state["state"] = {0: {
        "step": torch.tensor(float(count)),
        "exp_avg": torch.tensor(np.asarray(mu, np.float32), device=device),
        "exp_avg_sq": torch.tensor(np.asarray(nu, np.float32),
                                   device=device)}}
    opt.load_state_dict(state)
    return raw, opt


def _raw_of(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    """The one tensor ``optimizer`` updates: ``raw``."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != 1:
        raise ValueError(f"the optimizer holds {len(params)} tensors; a "
                         "train step takes one, raw")
    return params[0]


def _state_ids(data, device) -> torch.Tensor:
    if not isinstance(data, torch.Tensor):
        data = np.array(data, dtype=np.int64)
    return torch.as_tensor(data, dtype=torch.int64, device=device)


def make_train_step(template: MRF, optimizer: torch.optim.Optimizer,
                    nonpositive: bool = True) -> Callable:
    """Single-device training step on ``optimizer``'s ``raw``: ``step(batch)
    -> loss``, the mean NLL of the state ids ``batch`` before the update."""
    raw = _raw_of(optimizer)

    @profiling.spanned("qcmrf.train.step")
    def step(batch):
        optimizer.zero_grad()
        with profiling.span("qcmrf.train.loss"):
            loss = _nll(template, _to_theta(raw, nonpositive), batch)
        with profiling.span("qcmrf.train.backward"):
            loss.backward()
        with profiling.span("qcmrf.train.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def _optimizer(raw, optimizer, learning_rate):
    return optimizer([raw]) if optimizer else adam([raw], learning_rate)


def fit_mle(mrf0: MRF, data, steps: int = 300, learning_rate: float = 0.1,
            nonpositive: bool = True,
            optimizer: Optional[Callable] = None) -> Tuple[MRF, torch.Tensor]:
    """Fit theta to observed state ids; returns (fitted MRF, final loss).
    ``optimizer`` makes the optimizer from a parameter list (default:
    :func:`adam` at ``learning_rate``). Runs on ``mrf0``'s device."""
    raw = _from_theta(mrf0.theta, nonpositive).requires_grad_()
    step = make_train_step(mrf0, _optimizer(raw, optimizer, learning_rate),
                           nonpositive)
    data = _state_ids(data, mrf0.device)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        loss = step(data)
    return mrf0.with_theta(_to_theta(raw, nonpositive).detach()), loss


def make_sharded_train_step(template: MRF, optimizer: torch.optim.Optimizer,
                            mesh, nonpositive: bool = True) -> Callable:
    """Training step over a 2-D ``(amp, data)`` mesh: ``step(batch) ->
    loss``, as :func:`make_train_step`. lnZ shards its sweep over the
    ``amp`` axis (differentiable: the sharded fused sweep's moments are
    its backward), the batch's mean log-potential over the ``data`` axis
    (equal slices, each averaged on its device, then the mean of the
    means, JAX's ``pmean``). ``raw`` stays on its device. JAX's amp shards
    each evaluate a slice of the enumerated table; the port's sweep takes
    no table."""
    from qcmrf_tpu_torch.models import moments
    from qcmrf_tpu_torch.parallel import sharded

    amp_axis, data_axis = mesh.axis_names
    amp = sharded.Mesh(mesh.axis_devices(amp_axis))
    sharded._dlog(amp)
    data_devs = mesh.axis_devices(data_axis)
    raw = _raw_of(optimizer)

    def step(batch):
        batch = _state_ids(batch, raw.device)
        if batch.shape[0] % len(data_devs):
            raise ValueError(
                f"batch of {batch.shape[0]} does not split over the "
                f"{len(data_devs)} devices of the {data_axis!r} axis")
        optimizer.zero_grad()
        theta = _to_theta(raw, nonpositive)
        m = template.with_theta(theta)
        lnZ = moments.log_partition_streaming(m, amp)
        means = [(m.beta * sharded._on(m, dev).log_potential(
            chunk.to(dev)).mean()).to(raw.device)
            for dev, chunk in zip(data_devs,
                                  batch.chunk(len(data_devs)))]
        loss = lnZ - torch.stack(means).mean()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit_mle_sharded(mrf0: MRF, data, mesh, steps: int = 100,
                    learning_rate: float = 0.1,
                    nonpositive: bool = True) -> Tuple[MRF, torch.Tensor]:
    """:func:`fit_mle` with :func:`make_sharded_train_step` on the 2-D
    ``(amp, data)`` ``mesh``: (fitted MRF, final loss)."""
    raw = _from_theta(mrf0.theta, nonpositive).requires_grad_()
    step = make_sharded_train_step(mrf0, adam([raw], learning_rate), mesh,
                                   nonpositive)
    data = _state_ids(data, mrf0.device)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        loss = step(data)
    return mrf0.with_theta(_to_theta(raw, nonpositive).detach()), loss


# --------------------------------------------------------------------------
# Shot-based training: model moments from circuit samples
# --------------------------------------------------------------------------


def make_shots_train_step(template: MRF, optimizer: torch.optim.Optimizer,
                          shots: int, data_marg, nonpositive: bool = True,
                          mesh=None) -> Callable:
    """Shot-gradient step: ``step(seed, stream) -> delta_hat``. The model
    moments of ``grad_theta NLL = beta * (E_model[phi] - E_data[phi])``
    are the empirical clique marginals of ``shots`` post-selected circuit
    shots drawn by the sampler kernel at the pre-update theta, with the
    Philox key ``(seed, stream)``; the step applies that gradient
    through the reparameterisation and returns the shots' acceptance
    rate. With ``mesh`` (any mesh whose size divides ``shots``; a 2-D one
    flattened) the draws and their clique counts shard over every device
    (:func:`sharded.sharded_shot_moments`, shard d on Philox stream
    ``stream * D + d``)."""
    from qcmrf_tpu_torch.evaluation.estimators import (
        clique_marginals_from_samples)
    from qcmrf_tpu_torch.parallel import sharded
    from qcmrf_tpu_torch.sim import analytic

    raw = _raw_of(optimizer)
    data_marg = torch.as_tensor(data_marg, dtype=torch.float32,
                                device=raw.device)

    def step(seed: int, stream: int = 0) -> float:
        with torch.no_grad():
            m = template.with_theta(_to_theta(raw, nonpositive))
            if mesh is not None:
                model_marg, delta = sharded.sharded_shot_moments(
                    seed, m, mesh, shots, stream)
            else:
                x, acc = analytic.sample_postselected(seed, m, shots, stream)
                model_marg = clique_marginals_from_samples(m, x, acc)
                delta = float(acc.float().mean())
        optimizer.zero_grad()
        _to_theta(raw, nonpositive).backward(
            template.beta * (model_marg.float() - data_marg))
        optimizer.step()
        return delta

    return step


def fit_mle_shots(mrf0: MRF, data, seed: int, steps: int = 200,
                  shots: int = 1 << 14, learning_rate: float = 0.05,
                  nonpositive: bool = True,
                  optimizer: Optional[Callable] = None) -> Tuple[MRF, float]:
    """Quantum-in-the-loop MLE: the model-moment term of the gradient comes
    from post-selected circuit shots (step ``i`` on the Philox key
    ``(seed, i)``), never from exact inference. Returns (fitted MRF,
    final delta-hat)."""
    from qcmrf_tpu_torch.evaluation.estimators import (
        clique_marginals_from_samples)

    raw = _from_theta(mrf0.theta, nonpositive).requires_grad_()
    data_marg = clique_marginals_from_samples(
        mrf0, _state_ids(data, mrf0.device))
    step = make_shots_train_step(
        mrf0, _optimizer(raw, optimizer, learning_rate), shots, data_marg,
        nonpositive)
    delta = 0.0
    for i in range(steps):
        delta = step(seed, i)
    return mrf0.with_theta(_to_theta(raw, nonpositive).detach()), delta


# --------------------------------------------------------------------------
# AIS-moment training: past both exact caps (induced width beyond
# elimination and n beyond the streaming sweeps)
# --------------------------------------------------------------------------


def make_ais_train_step(template: MRF, optimizer: torch.optim.Optimizer,
                        data_marg, num_chains: int = 256,
                        num_temps: int = 64, sweeps_per_temp: int = 1,
                        ess_min_frac: float = 0.1, nonpositive: bool = True,
                        mesh=None) -> Callable:
    """Stochastic-moment MLE step with no structural cap: ``step(seed,
    stream=0) -> info``. The gradient ``beta * (E_model[phi] - mu_hat)``
    takes the model moments from AIS clique marginals at the pre-update
    theta (:func:`qcmrf_tpu_torch.models.ais.ais_clique_marginals`, Philox
    ``(seed, stream)``) and goes through the reparameterisation's backward.

    ESS gate: where ``ess < ess_min_frac * num_chains`` the step is
    skipped, ``raw`` and the optimizer state untouched (a collapsed weight
    set gives a gradient closer to noise than signal; more rungs are the
    remedy). ``info`` is ``{"ess", "skipped"}``. With ``mesh`` the chains
    shard over its devices (:func:`qcmrf_tpu_torch.models.ais.
    ais_clique_marginals`), the same chains as without."""
    from qcmrf_tpu_torch.models import ais as mais

    raw = _raw_of(optimizer)
    data_marg = torch.as_tensor(data_marg, dtype=torch.float32,
                                device=raw.device)
    ess_min = float(ess_min_frac) * float(num_chains)

    def step(seed: int, stream: int = 0) -> dict:
        with torch.no_grad():
            m = template.with_theta(_to_theta(raw, nonpositive))
            model_marg, diag = mais.ais_clique_marginals(
                seed, m, num_chains=num_chains, num_temps=num_temps,
                sweeps_per_temp=sweeps_per_temp, return_diagnostics=True,
                mesh=mesh, stream=stream)
        ess = float(diag["ess"])
        if ess < ess_min:
            return {"ess": ess, "skipped": True}
        optimizer.zero_grad()
        _to_theta(raw, nonpositive).backward(
            template.beta * (torch.as_tensor(model_marg, dtype=torch.float32,
                                             device=raw.device) - data_marg))
        optimizer.step()
        return {"ess": ess, "skipped": False}

    return step


# --------------------------------------------------------------------------
# Moment-target training on bit-array data: exact MLE past the int32
# state-id ceiling (n > 30)
# --------------------------------------------------------------------------


def empirical_moments_from_bits(template: MRF, bits) -> torch.Tensor:
    """Empirical ``E_data[phi]`` (d,) float32 on the model's device from
    per-variable bit arrays (S, n): the data's sufficient statistics, all
    the NLL needs (``mean log-lik = beta * theta^T mu_hat - lnZ``), with no
    state id and no ``2**n`` anywhere. Counted on the host in float64 as
    the JAX package does."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    bits = np.asarray(bits)
    if bits.ndim != 2 or bits.shape[1] != template.n:
        raise ValueError(
            f"bits must be (samples, n={template.n}), got {bits.shape}")
    if not np.isin(bits, (0, 1)).all():
        raise ValueError("bits must be 0/1 arrays")
    S = bits.shape[0]
    mu = np.zeros(template.dimension)
    for k, C in enumerate(template.cliques):
        m = len(C)
        y = np.zeros(S, dtype=np.int64)
        for i, v in enumerate(C):
            y |= bits[:, v].astype(np.int64) << (m - 1 - i)
        np.add.at(mu, template.theta_offsets[k] + y, 1.0)
    return torch.as_tensor((mu / max(S, 1)).astype(np.float32),
                           device=template.device)


def make_lnz_fn(template: MRF, mesh=None,
                enumerate_max_n: int = 22) -> Callable:
    """``lnZ(theta) -> scalar`` routed by structure, differentiable on every
    branch: the one lnZ router of moment training and structure learning.
    Enumeration up to ``2**enumerate_max_n`` states
    (:meth:`MRF.log_partition`), variable elimination for induced width up
    to ``capability.ELIM_WIDTH_CAP`` (read at call time) at any n, else
    the streaming fused sweep up to ``capability.STREAMING_MAX_N``;
    ``ValueError`` past both exact backends. ``mesh`` shards the
    streaming branch only (flattened when 2-D), the reach of the other
    two not being a ``2**n`` sweep."""
    from qcmrf_tpu_torch.models import capability, elimination, moments

    beta = float(template.beta)
    if template.n <= enumerate_max_n:
        def lnZ_fn(theta):
            return template.with_theta(theta).log_partition()
    elif (elimination.induced_width(template.cliques, template.n)
          <= capability.ELIM_WIDTH_CAP):
        def lnZ_fn(theta):
            return elimination._lnz(template.cliques, template.n, theta,
                                    beta)
    else:
        if template.n > capability.STREAMING_MAX_N:
            raise ValueError(
                f"no exact lnZ: induced width > {capability.ELIM_WIDTH_CAP}"
                f" and n={template.n} > streaming cap "
                f"{capability.STREAMING_MAX_N}")
        def lnZ_fn(theta):
            return moments.log_partition_streaming(
                template.with_theta(theta), mesh)

    return lnZ_fn


def make_moment_train_step(template: MRF, optimizer: torch.optim.Optimizer,
                           mu_hat, nonpositive: bool = True, mesh=None, *,
                           penalty: Optional[Callable] = None,
                           enumerate_max_n: int = -1) -> Callable:
    """Exact-MLE step on the sufficient statistics: ``loss(theta) =
    lnZ(theta) - beta * theta^T mu_hat`` (the exact mean NLL of the data),
    plus ``penalty(theta)`` where one is given. lnZ by elimination or,
    past the width cap, the streaming fused sweep; enumeration only up to
    ``enumerate_max_n`` (by default never: this step serves the big-n
    regime). ``step(batch=None) -> loss``; ``batch`` is ignored (the
    moments are baked in)."""
    raw = _raw_of(optimizer)
    mu_hat = torch.as_tensor(mu_hat, dtype=torch.float32, device=raw.device)
    lnZ_fn = make_lnz_fn(template, mesh=mesh,
                         enumerate_max_n=enumerate_max_n)

    def step(batch=None):
        optimizer.zero_grad()
        theta = _to_theta(raw, nonpositive)
        loss = lnZ_fn(theta) - template.beta * torch.dot(theta, mu_hat)
        if penalty is not None:
            loss = loss + penalty(theta)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
