"""Exact-inference sweeps and shot estimates sharded over a device mesh (the
sweep half of :mod:`qcmrf_tpu.parallel.sharded`).

The JAX package's mesh is single-controller: one process drives every
device of a ``jax.sharding.Mesh`` through ``shard_map``. So is this one. A
:class:`Mesh` is a tuple of ``torch.device`` with named axes, and one
process launches every shard:

* a sweep of the ``2**n`` states (lnZ, the Gibbs table, moments, MAP,
  perturb-and-MAP) cuts the blocks of ``kernels.lse_geometry(2**n)`` into
  one contiguous range a shard. Shard ``d`` sweeps its range with the
  kernels' state-id offset, ``x0_blocks = d * blocks / D``, on its own
  device and stream; its partials are the whole sweep's partials of those
  blocks bit for bit (``csrc/qcmrf_kernels.cu``, section 2), so the mesh's
  first device combines them with the single-device combiners
  (``combine_lse``, ``combine_map``, ``combine_lnz_moments``, the moments'
  float64 block sum) into the single-device answer;
* a shot estimate gives shard ``d`` the sampler's Philox stream ``d``
  (round ``i`` of ``D`` shards: ``i * D + d``) where JAX splits a key; the
  shards' counts are summed.

A mesh may repeat a device: ``Mesh((cpu,) * 8)`` stands for the JAX
tests' eight virtual CPU devices, and ``Mesh((cuda:0,) * 4)`` runs four
shards on one card (their streams overlap where the card has room).
:func:`make_mesh` takes the visible CUDA devices, each once; on the CPU
it repeats the host as often as asked, as JAX's
``--xla_force_host_platform_device_count`` does. No worker processes and
no collectives: the partials are small and cross devices by copies.

The gate-level exchange engine (JAX ``run_statevector_sharded``,
``sharded_outcome_probs``) is slice 6b of ROADMAP.md and raises here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.ops import kernels as K
from qcmrf_tpu_torch.utils import moebius
from qcmrf_tpu_torch.utils.config import resolve_device

AXIS = "amp"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices with named axes: ``devices`` flat and row-major over
    ``sizes`` (one size an axis of ``axis_names``; one axis of all the
    devices by default). A device may repeat."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (AXIS,)
    sizes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        sizes = (len(devs),) if self.sizes is None else tuple(self.sizes)
        if not devs or math.prod(sizes) != len(devs) \
                or len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} of sizes "
                             f"{sizes} do not hold {len(devs)} devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "sizes", sizes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        stride = math.prod(self.sizes[k + 1:])
        return tuple(self.devices[i * stride] for i in range(self.sizes[k]))


def visible_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices :func:`make_mesh` draws from: with ``device`` None or
    CUDA, every visible CUDA device once (raising where PyTorch sees
    none); on the CPU, the host once (:func:`make_mesh` repeats it as
    often as asked)."""
    if resolve_device(device).type == "cpu":
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def device_mesh(sizes, axis_names, device=None) -> Mesh:
    """A mesh of axes ``axis_names`` of ``sizes`` over the first
    ``prod(sizes)`` of :func:`visible_devices`. Raises when fewer are
    visible: a silently smaller mesh would misreport every sharded
    result. On the CPU the host stands for any number of devices."""
    sizes = tuple(int(s) for s in sizes)
    count = math.prod(sizes)
    devs = visible_devices(device)
    if devs[0].type == "cpu":
        devs = devs * count
    if len(devs) < count:
        raise ValueError(
            f"requested a {count}-device mesh but only {len(devs)} "
            "device(s) are visible — a silently smaller mesh would "
            "misreport every sharded result")
    return Mesh(devs[:count], tuple(axis_names), sizes)


def mesh_from_spec(spec: str, device=None) -> Mesh:
    """The CLIs' ``--mesh AxB``: a 2-D ``(amp, data)`` mesh of the first
    A * B of :func:`visible_devices` (:func:`device_mesh`). Exits with
    the reason on a malformed spec or too few devices."""
    try:
        a, b = (int(x) for x in spec.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r}: expected AxB, e.g. 4x2")
    try:
        return device_mesh((a, b), ("amp", "data"), device)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def make_mesh(num_devices: Optional[int] = None, axis: str = AXIS,
              device=None) -> Mesh:
    """A 1-D mesh of the first ``num_devices`` of :func:`visible_devices`
    (all of them by default; on the CPU, one): :func:`device_mesh`."""
    if num_devices is None:
        num_devices = len(visible_devices(device))
    return device_mesh((num_devices,), (axis,), device)


# --------------------------------------------------------------------------
# Mesh helpers
# --------------------------------------------------------------------------


def _dlog(mesh: Mesh) -> int:
    """log2 of the mesh size; rejects a mesh that is not a power of two
    (its shards could not cover the power-of-two sweep evenly)."""
    D = mesh.size
    dlog = D.bit_length() - 1
    if (1 << dlog) != D:
        raise ValueError(
            f"sharded inference needs a power-of-two mesh, got {D} devices")
    return dlog


def mesh_fits(mesh: Mesh, n: int) -> bool:
    """Whether an ``n``-variable sweep can shard over this mesh (``n >=
    log2 D``). Callers drop the mesh and run the single-device sweep, the
    same answer, when this is False: evidence-reduced models routinely
    shrink below the mesh."""
    return n >= _dlog(mesh)


def fit_mesh(mesh, n: int):
    """``mesh`` if an ``n``-variable sweep can shard over it, else
    ``None`` (the drop-the-mesh rule of every conditional entry point).
    Accepts ``None``."""
    return mesh if mesh is not None and mesh_fits(mesh, n) else None


def _sweep_mesh(mesh: Mesh) -> Mesh:
    """The 1-D view of ``mesh`` that the sweep and shot paths shard over:
    a multi-axis mesh (the train CLI's 2-D (amp, data)) is flattened, so
    that every device takes a slice."""
    if len(mesh.axis_names) == 1:
        return mesh
    return Mesh(mesh.devices, ("sweep",))


def _use_slice_kernel(n: int, dlog: int) -> bool:
    """Whether the shards of an ``n``-variable sweep each take a slice of
    its blocks (every sweep path takes this one gate, so that they stay
    in lockstep): the blocks of ``lse_geometry(2**n)`` must divide over
    the ``2**dlog`` shards. They are a power of two, so this fails only
    for small sweeps (fewer than ``2**dlog`` blocks); the whole sweep then
    runs on the mesh's first device, the same answer. (JAX's gate is its
    kernels' width floor; the port's kernels serve every width.)"""
    return K.lse_geometry(1 << n)[0] % (1 << dlog) == 0


def _shards(mesh: Mesh, n: int) -> List[tuple]:
    """``[(device, x0_blocks, blocks)]``, one a shard of an ``n``-variable
    sweep over the 1-D ``mesh``."""
    parts = K.lse_geometry(1 << n)[0]
    if not _use_slice_kernel(n, _dlog(mesh)):
        return [(mesh.devices[0], 0, parts)]
    per = parts // mesh.size
    return [(dev, d * per, per) for d, dev in enumerate(mesh.devices)]


@functools.lru_cache(maxsize=64)
def _stream(device: torch.device, d: int):
    """Shard ``d``'s stream on a CUDA ``device``."""
    return torch.cuda.Stream(device)


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _run(calls) -> list:
    """Run ``fn(*args)`` of each ``(device, fn, args)`` of ``calls``, shard
    ``d`` on its own stream of a CUDA device (after that device's current
    stream), and return the results once each device's current stream
    waits for them."""
    outs, waits = [], []
    for d, (dev, fn, args) in enumerate(calls):
        if dev.type != "cuda":
            outs.append(fn(*args))
            continue
        main = torch.cuda.current_stream(dev)
        s = _stream(dev, d)
        s.wait_stream(main)
        with torch.cuda.stream(s):
            out = fn(*args)
        outs.append(out)
        waits.append((main, s, out))
    for main, s, out in waits:
        main.wait_stream(s)
        for t in _tensors(out):
            t.record_stream(main)
    return outs


def _on(mrf: MRF, dev: torch.device) -> MRF:
    return (mrf if mrf.device == dev
            else dataclasses.replace(mrf, theta=mrf.theta.to(dev)))


def _copies(t: torch.Tensor, shards) -> dict:
    """``t`` on every shard's device (one copy a device)."""
    return {dev: t.to(dev) for dev, *_ in shards}


def _gather(parts, dev, dim: int = -1) -> torch.Tensor:
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _sweep(mesh: Mesh, n: int, fn, *tensors) -> list:
    """``fn(*tensors_on_device, x0_blocks, blocks)`` on every shard of an
    ``n``-variable sweep over the 1-D ``mesh``: the shards' results in
    range order."""
    shards = _shards(mesh, n)
    copies = [_copies(t, shards) for t in tensors]
    return _run([(dev, fn, (*(c[dev] for c in copies), x0, count))
                 for dev, x0, count in shards])


# --------------------------------------------------------------------------
# Sharded exact inference
# --------------------------------------------------------------------------


def _lse_parts(mrf: MRF, mesh: Mesh):
    """The lse kernel's (max, scaled sum) partials of the whole sweep,
    gathered on ``mrf``'s device: (1, parts) each."""
    coef = K.moebius_coefficients(mrf)[None]
    outs = _sweep(mesh, mrf.n, lambda c, x0, b: K.lse_partials(
        mrf.cliques, mrf.n, c, mrf.beta, x0, b), coef)
    return (_gather([o[0] for o in outs], mrf.device),
            _gather([o[1] for o in outs], mrf.device))


def sharded_log_partition(mrf: MRF, mesh: Mesh) -> torch.Tensor:
    """``ln Z`` with the sweep of the ``2**n`` states sharded over the
    mesh: each shard's lse partials of its block range, combined on
    ``mrf``'s device (the single-device sweep's answer bit for bit). Not
    differentiable: :func:`qcmrf_tpu_torch.models.moments.
    log_partition_streaming` with a mesh is."""
    mesh = _sweep_mesh(mesh)
    with torch.no_grad():
        return K.combine_lse(*_lse_parts(mrf, mesh))[0]


def sharded_gibbs_probs(mrf: MRF, mesh: Mesh) -> torch.Tensor:
    """The exact Gibbs distribution, ``(2**n,)`` on ``mrf``'s device: each
    shard writes its slice of the log-potential table (the table kernel
    at its offset; the single-device table bit for bit once gathered),
    then one softmax (JAX returns the probabilities sharded). The port's
    offsets are 64-bit, so slices past 2^31 states are exact (JAX refuses
    them)."""
    mesh = _sweep_mesh(mesh)
    coef = K.moebius_coefficients(mrf.with_theta(mrf.theta.detach()))[None]
    outs = _sweep(mesh, mrf.n, lambda c, x0, b: K.logpot_table(
        mrf.cliques, mrf.n, c, mrf.beta, False, x0, b), coef)
    return torch.softmax(_gather(outs, mrf.device)[0], dim=-1)


def sharded_success_rate(mrf: MRF, mesh: Mesh) -> torch.Tensor:
    """``Z / 2**n`` from the sharded lnZ."""
    return torch.exp(sharded_log_partition(mrf, mesh)
                     - mrf.n * math.log(2.0))


def moments_cap() -> int:
    """The streaming sweeps' n cap (``capability.STREAMING_MAX_N``)."""
    from qcmrf_tpu_torch.models import capability

    return capability.STREAMING_MAX_N


def _check_cap(n: int) -> None:
    if n > moments_cap():
        raise ValueError(f"streaming moments cap at n={moments_cap()} (the "
                         f"JAX package's int32 block ids); got n={n}")


def sharded_clique_moments(mrf: MRF, mesh: Mesh, lnZ=None) -> torch.Tensor:
    """Exact model moments ``E_p[phi]`` (theta layout) with the
    monomial-moments sweep sharded over the mesh, for a given ``lnZ``
    (the sharded lnZ when None): each shard's float32 per-block partials
    are gathered and added in float64 as one sweep's
    (:func:`kernels.monomial_moments`' answer bit for bit)."""
    mesh = _sweep_mesh(mesh)
    _check_cap(mrf.n)
    if lnZ is None:
        lnZ = sharded_log_partition(mrf, mesh)
    dev = mrf.device
    lnz = torch.as_tensor(lnZ, dtype=torch.float32, device=dev).reshape(1)
    masks = moebius.device_masks(mrf.cliques, mrf.n, dev)
    coef = K.moebius_coefficients(mrf.with_theta(mrf.theta.detach()))[None]
    cl, n, beta = mrf.cliques, mrf.n, mrf.beta
    outs = _sweep(mesh, n, lambda c, z, mk, x0, b:
                  K.monomial_moment_partials(cl, n, c, beta, z, mk, x0, b),
                  coef, lnz, masks)
    mono = _gather(outs, dev, dim=1).sum(dim=1, dtype=torch.float64)[0]
    return moebius.masks_from_monomials(mono, cl).to(mrf.theta.dtype)


def sharded_lnz_and_moments(mrf: MRF, mesh: Mesh):
    """``(lnZ, E_p[phi])`` in ONE sharded sweep: each shard's fused
    lnZ + moments partials of its blocks, gathered and combined as one
    sweep's (:func:`kernels.lnz_and_moments`' answer bit for bit), both in
    ``theta``'s dtype. The port's fused kernel takes any structure, so
    JAX's two-sweep fallback has no counterpart."""
    mesh = _sweep_mesh(mesh)
    _check_cap(mrf.n)
    dev = mrf.device
    theta = mrf.theta.detach()
    masks = moebius.device_masks(mrf.cliques, mrf.n, dev)
    coef = K.coefficient_table(mrf.cliques, mrf.n, theta)[None]
    cl, n, beta = mrf.cliques, mrf.n, mrf.beta
    outs = _sweep(mesh, n, lambda c, mk, x0, b: K.lnz_moments_partials(
        cl, n, c, beta, mk, x0, b), coef, masks)
    lnz, mono = K.combine_lnz_moments(_gather([o[0] for o in outs], dev),
                                      _gather([o[1] for o in outs], dev,
                                              dim=1))
    return (lnz[0].to(theta.dtype),
            moebius.masks_from_monomials(mono[0], cl).to(theta.dtype))


def _map_partials(mesh: Mesh, cliques: tuple, n: int, coef: torch.Tensor,
                  beta: float):
    """The map kernel's (value, earliest id) partials of every row of
    ``coef`` over the whole sweep, each shard sweeping its blocks (ids
    absolute), gathered on ``coef``'s device: :func:`kernels.map_partials`
    bit for bit. The one partials path of the sharded MAP and PAM."""
    outs = _sweep(mesh, n, lambda c, x0, b: K.map_partials(
        cliques, n, c, beta, None, x0, b), coef)
    return (_gather([o[0] for o in outs], coef.device),
            _gather([o[1] for o in outs], coef.device))


def sharded_map_state(mrf: MRF, mesh: Mesh):
    """Exact MAP state by the streaming argmax sharded over the mesh:
    ``(state_id, beta * theta^T phi(x))`` as host numbers, the chain's
    maximum with the earliest id of equal maxima (ties across shards
    too), as :func:`kernels.map_state_streaming`."""
    mesh = _sweep_mesh(mesh)
    with torch.no_grad():
        coef = K.moebius_coefficients(mrf)[None]
        v, x = K.combine_map(*_map_partials(mesh, mrf.cliques, mrf.n, coef,
                                            mrf.beta))
    return int(x[0]), float(v[0])


def sharded_sample_pam(generator, mrf: MRF, mesh: Mesh,
                       num_samples: int) -> torch.Tensor:
    """Perturb-and-MAP samples as int32 bit rows ``(num_samples, n)`` with
    every perturbed model's argmax sweep sharded over the mesh: the noise
    is drawn on ``mrf``'s device as by
    :func:`qcmrf_tpu_torch.models.sample.sample_pam_streaming`, so the
    same generator state gives the same samples."""
    from qcmrf_tpu_torch.models import sample

    return sample._bits(sample._pam_ids(generator, mrf, num_samples,
                                        _sweep_mesh(mesh)), mrf.n)


# --------------------------------------------------------------------------
# Sharded shots: shard d draws the sampler's stream d
# --------------------------------------------------------------------------


def _per_device(shots: int, mesh: Mesh) -> int:
    D = mesh.size
    if shots % D:
        raise ValueError(f"shots ({shots}) must be divisible by the mesh "
                         f"size ({D}); a silent floor would bias delta-hat "
                         "estimates")
    return shots // D


def sharded_estimate_delta(seed: int, mrf: MRF, mesh: Mesh, shots: int,
                           iters: int) -> torch.Tensor:
    """``iters`` independent estimates of ``delta = Z / 2**n``, float64
    ``(iters,)`` on ``mrf``'s device, each the acceptance rate of
    ``shots`` shots: shard ``d`` of round ``i`` counts ``shots / D``
    accepted shots in the sampler kernel (no shot written) on Philox
    stream ``i * D + d`` of ``seed``."""
    from qcmrf_tpu_torch.ops import sampler_kernel

    mesh = _sweep_mesh(mesh)
    D, per = mesh.size, _per_device(shots, mesh)

    def counts(m, d):
        return torch.stack([sampler_kernel.sample_accept_count(
            seed, m, per, stream=i * D + d) for i in range(iters)])

    outs = _run([(dev, counts, (_on(mrf, dev), d))
                 for d, dev in enumerate(mesh.devices)])
    total = torch.stack([o.to(mrf.device) for o in outs]).sum(dim=0)
    return total.double() / shots


def sharded_shot_moments(seed: int, mrf: MRF, mesh: Mesh, shots: int,
                         stream: int = 0):
    """Clique marginals ``E_model[phi]`` (float64 ``(d,)``) and delta-hat
    from ``shots`` post-selected shots sharded over the mesh: shard ``d``
    draws ``shots / D`` on Philox stream ``stream * D + d`` and counts its
    accepted clique states; the counts are summed on ``mrf``'s device.
    Returns ``(marginals, delta_hat)``."""
    from qcmrf_tpu_torch.sim import analytic

    mesh = _sweep_mesh(mesh)
    D, per = mesh.size, _per_device(shots, mesh)

    def partial(m, d):
        x, acc = analytic.sample_postselected(seed, m, per,
                                              stream=stream * D + d)
        idx = m.suff_stat_flat_indices(x[acc]).reshape(-1)
        marg = torch.zeros(m.dimension, dtype=torch.float64,
                           device=idx.device)
        marg.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float64,
                                           device=idx.device))
        return marg, acc.sum()

    outs = _run([(dev, partial, (_on(mrf, dev), d))
                 for d, dev in enumerate(mesh.devices)])
    marg = torch.stack([o[0].to(mrf.device) for o in outs]).sum(dim=0)
    cnt = float(sum(int(o[1]) for o in outs))
    return marg / max(cnt, 1.0), cnt / shots


def sharded_sample_postselected(seed: int, mrf: MRF, mesh: Mesh,
                                shots: int, stream: int = 0):
    """``(x, accepted)`` of ``shots`` shots as
    :func:`qcmrf_tpu_torch.sim.analytic.sample_postselected`, shard ``d``
    drawing ``shots / D`` of them on Philox stream ``stream * D + d``;
    gathered on ``mrf``'s device in shard order. No traffic between
    shards: the factorised sampler needs none."""
    from qcmrf_tpu_torch.sim import analytic

    mesh = _sweep_mesh(mesh)
    D, per = mesh.size, _per_device(shots, mesh)
    outs = _run([(dev, analytic.sample_postselected,
                  (seed, _on(mrf, dev), per, stream * D + d))
                 for d, dev in enumerate(mesh.devices)])
    return (_gather([o[0] for o in outs], mrf.device),
            _gather([o[1] for o in outs], mrf.device))


# --------------------------------------------------------------------------
# The gate-level exchange engine: slice 6b
# --------------------------------------------------------------------------


def _slice_6b(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (the gate-level exchange engine of the JAX package's "
            "parallel/sharded.py) comes to the port with slice 6b of "
            "ROADMAP.md")
    refuse.__name__ = name
    refuse.__doc__ = f"JAX's ``{name}``: slice 6b of ROADMAP.md; raises."
    return refuse


run_statevector_sharded = _slice_6b("run_statevector_sharded")
sharded_outcome_probs = _slice_6b("sharded_outcome_probs")
