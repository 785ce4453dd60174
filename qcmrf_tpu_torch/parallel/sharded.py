"""Exact-inference sweeps, shot estimates and the gate-level statevector
sharded over a device mesh (port of :mod:`qcmrf_tpu.parallel.sharded`).

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

* the gate-level engine (:func:`run_statevector_sharded`,
  :func:`sharded_outcome_probs`) keeps ``2**n / D`` amplitudes a shard:
  shard ``d`` holds global amplitudes ``d * 2**local_n`` to ``(d + 1) *
  2**local_n - 1``. It runs JAX's plan: segments of the single-device
  plane engine's fused passes on every shard, diagonal conditions on
  device bits folded into angles evaluated for each shard, and between
  segments targeted exchanges of a device bit with a local bit (half of
  each shard moves between partners, by ``copy_``), then one local bit
  permutation. Results come back per shard; :func:`gather` joins them.

A mesh may repeat a device: ``Mesh((cpu,) * 8)`` stands for the JAX
tests' eight virtual CPU devices, and ``Mesh((cuda:0,) * 4)`` runs four
shards on one card (their streams overlap where the card has room; a
device that holds one shard runs it on its current stream).
:func:`make_mesh` takes the visible CUDA devices, each once; on the CPU
it repeats the host as often as asked, as JAX's
``--xla_force_host_platform_device_count`` does. No worker processes and
no collectives: partials and exchanged halves cross devices by copies.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.circuits.ir import Circuit
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.ops import kernels as K
from qcmrf_tpu_torch.sim.dense import GATES_1Q
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


def _shard_streams(mesh: Mesh) -> list:
    """Each shard's stream (None for a shard off CUDA): its device's
    current stream where the shard is the device's only one, else a stream
    of its own that waits for the device's current stream (shards of one
    card overlap there)."""
    out = []
    for d, dev in enumerate(mesh.devices):
        if dev.type != "cuda":
            out.append(None)
            continue
        main = torch.cuda.current_stream(dev)
        if mesh.devices.count(dev) == 1:
            out.append(main)
            continue
        s = _stream(dev, d)
        s.wait_stream(main)
        out.append(s)
    return out


def _in_stream(stream):
    """A shard's stream as the current one while the block runs."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def _join(streams, parts) -> None:
    """Each device's current stream waits for its shards' own streams and
    owns the shards' tensors from here on (a tensor allocated on the
    current stream needs no record: the wait orders every later use)."""
    for s, tensors in zip(streams, parts):
        if s is None:
            continue
        main = torch.cuda.current_stream(s.device)
        if s == main:
            continue
        main.wait_stream(s)
        for t in tensors:
            t.record_stream(main)


def _run(calls) -> list:
    """Run ``fn(*args)`` of each ``(device, fn, args)`` of ``calls``, shard
    ``d`` on its stream (:func:`_shard_streams`), and return the results
    once each device's current stream waits for them."""
    streams = _shard_streams(Mesh(tuple(dev for dev, _, _ in calls)))
    outs = []
    for s, (_, fn, args) in zip(streams, calls):
        with _in_stream(s):
            outs.append(fn(*args))
    _join(streams, [_tensors(o) for o in outs])
    return outs


def _on(mrf: MRF, dev: torch.device) -> MRF:
    return (mrf if mrf.device == dev
            else dataclasses.replace(mrf, theta=mrf.theta.to(dev)))


def _copies(t: torch.Tensor, shards) -> dict:
    """``t`` on every shard's device (one copy a device)."""
    return {dev: t.to(dev) for dev, *_ in shards}


def gather(parts, device=None, dim: int = -1) -> torch.Tensor:
    """The parts concatenated in order along ``dim`` on ``device`` (the
    first part's by default): a sharded statevector's or distribution's
    shards as one tensor."""
    device = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


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
    return (gather([o[0] for o in outs], mrf.device),
            gather([o[1] for o in outs], mrf.device))


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
    return torch.softmax(gather(outs, mrf.device)[0], dim=-1)


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
    mono = gather(outs, dev, dim=1).sum(dim=1, dtype=torch.float64)[0]
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
    lnz, mono = K.combine_lnz_moments(gather([o[0] for o in outs], dev),
                                      gather([o[1] for o in outs], dev,
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
    return (gather([o[0] for o in outs], coef.device),
            gather([o[1] for o in outs], coef.device))


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
    return (gather([o[0] for o in outs], mrf.device),
            gather([o[1] for o in outs], mrf.device))


# --------------------------------------------------------------------------
# The gate-level exchange engine: the statevector sharded over the mesh
# --------------------------------------------------------------------------


def _swap_views(a: torch.Tensor, b: torch.Tensor) -> None:
    """Swap two equal-shaped views through a scratch copy of ``a``, on the
    current stream of ``a``'s device (three ``copy_``; peer to peer where
    ``b`` lies on another card)."""
    tmp = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    tmp.copy_(a)
    a.copy_(b)
    b.copy_(tmp)


class _Layout:
    """Tracks logical qubit -> physical bit position. Positions
    [0, local_n) are local bits; [local_n, n) are device bits."""

    def __init__(self, n: int, local_n: int):
        self.n = n
        self.local_n = local_n
        self.pos = list(range(n))  # logical -> physical
        self.remaps = 0  # exchanges planned

    def is_local(self, q: int) -> bool:
        return self.pos[q] < self.local_n

    def at_physical(self, p: int) -> int:
        return self.pos.index(p)

    def exchange(self, dev_j: int, loc_p: int):
        """Record a device-bit ``dev_j`` <-> local-bit ``loc_p`` swap."""
        a = self.pos.index(self.local_n + dev_j)
        b = self.pos.index(loc_p)
        self.pos[a], self.pos[b] = loc_p, self.local_n + dev_j
        self.remaps += 1


def _exchange(re: list, im: list, streams: list, dev_j: int, loc_p: int,
              local_n: int) -> None:
    """Swap device bit ``dev_j`` with local bit position ``loc_p`` (JAX's
    ``_exchange_device_local``): shard ``d`` with bit ``dev_j`` of ``d``
    clear trades its local-bit-1 half with partner ``d ^ (1 << dev_j)``'s
    local-bit-0 half, half of each shard moving and every other qubit's
    position untouched. The pair's streams wait for each other around the
    copies, so the copies follow both shards' last passes and precede
    their next ones; the scratch lives on the copying stream. A shard's
    planes are freed only from its own stream, after that stream waited
    for the copies, or after :func:`_join`; so the partner's planes need
    no record of the copying stream."""
    hi, lo = 1 << (local_n - 1 - loc_p), 1 << loc_p
    for d in range(len(re)):
        if (d >> dev_j) & 1:
            continue
        e = d | (1 << dev_j)
        sd, se = streams[d], streams[e]
        if sd is not None:
            sd.wait_stream(se)
        peer = se if sd is not None and se.device != sd.device else None
        with _in_stream(sd), _in_stream(peer):
            for planes in (re, im):
                _swap_views(planes[d].view(hi, 2, lo)[:, 1, :],
                            planes[e].view(hi, 2, lo)[:, 0, :])
        if se is not None:
            se.wait_stream(sd)


def _swap_bits(t: torch.Tensor, a: int, b: int, L: int) -> None:
    """Exchange bit positions ``a`` and ``b`` of the flat index of ``t``
    (``2**L`` values), in place: a view of 5 axes, so that no copy passes
    the device copy kernels' dimension limit at any ``L``."""
    a, b = min(a, b), max(a, b)
    v = t.view(1 << (L - 1 - b), 2, 1 << (b - a - 1), 2, 1 << a)
    _swap_views(v[:, 0, :, 1, :], v[:, 1, :, 0, :])


def _permute_local(t: torch.Tensor, axes, L: int) -> None:
    """JAX's ``reshape((2,) * L).transpose(axes)`` of a flat shard, in
    place, as a run of bit swaps: bit ``q`` of the new index is bit
    ``L - 1 - axes[L - 1 - q]`` of the old one."""
    cur = [L - 1 - axes[L - 1 - q] for q in range(L)]  # qubit -> position
    at = {p: q for q, p in enumerate(cur)}             # position -> qubit
    for q in range(L):
        p = cur[q]
        if p == q:
            continue
        r = at[q]
        _swap_bits(t, q, p, L)
        cur[q], cur[r] = q, p
        at[q], at[p] = q, r


def _restore(layout: _Layout, exchange, dlog: int):
    """Plan the return to the canonical layout: every destined device
    qubit placed by targeted exchanges, then one local permutation (JAX's
    ``axes``, None when nothing is left to permute)."""
    local_n = layout.local_n
    for j in range(dlog):
        t = local_n + j
        p = layout.pos[t]
        if p == local_n + j:
            continue
        if p >= local_n:
            # wrong device bit: route through any local position,
            # preferring a resident that belongs on a local bit
            lp = next((q for q in range(local_n)
                       if layout.at_physical(q) < local_n), 0)
            exchange(p - local_n, lp)
        exchange(j, layout.pos[t])
    if layout.pos == list(range(layout.n)):
        return None
    L = local_n
    return tuple(L - 1 - layout.pos[L - 1 - k] for k in range(L))


def _locality_needs(gates) -> list:
    """Per-gate tuple of qubits that must live on local bits: targets of
    non-diagonal gates. Diagonal gates (rz/cp/flags_phase) and cx controls
    read bit values, which works on device bits without communication."""
    out = []
    for g in gates:
        if g.name == "cx":
            out.append((g.qubits[1],))
        elif g.name in GATES_1Q and g.name != "id":
            out.append((g.qubits[0],))
        else:
            out.append(())
    return out


def _next_use(uses: dict, q: int, i: int) -> int:
    lst = uses[q]
    k = bisect.bisect_right(lst, i)
    return lst[k] if k < len(lst) else 1 << 30


#: exchanges planned by the most recent run_statevector_sharded call
LAST_REMAP_COUNT = 0
#: (gate stream, mesh) -> (path, plan, remaps, symbolic items): the
#: planner's output, kept for at most 64 circuits
_SV_PLAN_CACHE: dict = {}

#: minimum per-device qubit count for the FUSED shard-local path: the
#: plane kernels need lane rows (local_n >= 7) plus row positions >= 7
#: available as exchange victims; below this the gate-by-gate path is
#: cheaper anyway (test-scale circuits)
_FUSED_MIN_LOCAL = 10


class _SymAngle:
    """Planner-time symbolic angle: ``sum_k coef_k * [devconds_k hold]``.

    Folds diagonal conditions on DEVICE bits into fused-pass angles with
    zero communication: the planner's fusion (``planes.fuse_primitives``)
    only needs +, unary -, / and abs, which all stay symbolic, and the
    executor evaluates the angle on the host for each shard, whose device
    bits are constants, before the shard's pass launches.
    """

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = dict(parts)  # {devconds tuple ((j, want), ...): coef}

    @staticmethod
    def _of(v):
        if isinstance(v, _SymAngle):
            return v
        return _SymAngle({(): float(v)})

    def __add__(self, other):
        out = dict(self.parts)
        for k, v in _SymAngle._of(other).parts.items():
            out[k] = out.get(k, 0.0) + v
        return _SymAngle(out)

    __radd__ = __add__

    def __neg__(self):
        return _SymAngle({k: -v for k, v in self.parts.items()})

    def __truediv__(self, d):
        return _SymAngle({k: v / d for k, v in self.parts.items()})

    def __abs__(self):
        return max((abs(v) for v in self.parts.values()), default=0.0)

    def evaluate(self, devbit) -> float:
        """The angle on one shard; ``devbit(j)`` is its device bit j."""
        out = self.parts.get((), 0.0)
        for conds, coef in self.parts.items():
            if not conds:
                continue
            m = 1.0
            for j, want in conds:
                b = float(devbit(j))
                m *= b if want else 1.0 - b
            out = out + coef * m
        return out


def _has_sym(x) -> bool:
    if isinstance(x, _SymAngle):
        return True
    if isinstance(x, (tuple, list)):
        return any(_has_sym(e) for e in x)
    return False


def _evaluate(x, devbit):
    """``x`` with every :class:`_SymAngle` inside it evaluated."""
    if isinstance(x, _SymAngle):
        return x.evaluate(devbit)
    if isinstance(x, tuple):
        return tuple(_evaluate(e, devbit) for e in x)
    if isinstance(x, list):
        return [_evaluate(e, devbit) for e in x]
    return x


def _plan_fused(circuit: Circuit, local_n: int, dlog: int):
    """Execution plan of the fused sharded engine (JAX's, item for item).

    Returns ``(plan, remaps)`` where ``plan`` is a list of ``('ops',
    fused_ops)`` / ``('ex', dev_j, loc_p)`` / ``('perm', axes)`` items. The
    circuit's X-deferred primitive stream (``planes.circuit_primitives``)
    is cut at the targeted qubit exchanges (victims chosen by Belady's
    rule among ROW positions >= 7, so lane qubits never move and the lane
    ops stay valid); each segment gets the single-device engine's fusion
    (``planes.fuse_primitives``) with qubits rewritten to physical
    positions and device-bit diagonal conditions folded into symbolic
    angles.
    """
    from qcmrf_tpu_torch.sim import planes

    n = circuit.num_qubits
    prim = planes.circuit_primitives(circuit)
    layout = _Layout(n, local_n)

    plan = []
    # H-wall prefix -> closed-form uniform init (one write-only pass a
    # shard). The layout is the identity here, so folded qubit q sits at
    # position q: local when q < local_n, device bit q - local_n
    # otherwise. Shards whose UNTOUCHED device bits are not all 0 hold
    # all-zero shards (the carrier's (1 - devbit) product).
    folded, prim = planes.fold_uniform_prefix(prim)
    if folded:
        s_local = tuple(q for q in folded if q < local_n)
        comp_dev = tuple(j for j in range(dlog)
                         if (local_n + j) not in folded)
        plan.append(("ops", [
            ("init_uniform", s_local, comp_dev, len(folded))
        ]))

    uses = {q: [] for q in range(n)}
    for pi, p in enumerate(prim):
        if p[0] == "1q":
            uses[p[2]].append(pi)

    seg = []

    def flush():
        if seg:
            plan.append(("ops", planes.fuse_primitives(list(seg))))
            seg.clear()

    def exchange(dev_j, loc_p):
        flush()
        plan.append(("ex", dev_j, loc_p))
        layout.exchange(dev_j, loc_p)

    for pi, p in enumerate(prim):
        if p[0] == "1q":
            _, U, q = p
            if not layout.is_local(q):
                victim_pos = max(
                    range(7, local_n),
                    key=lambda lp: _next_use(uses, layout.at_physical(lp),
                                             pi),
                )
                exchange(layout.pos[q] - local_n, victim_pos)
            seg.append(("1q", U, layout.pos[q]))
        else:
            _, conds, base, ang = p
            lconds = []
            dconds = []
            for qq, want in conds:
                pp = layout.pos[qq]
                if pp < local_n:
                    lconds.append((pp, want))
                else:
                    dconds.append((pp - local_n, want))
            if dconds:
                ang = _SymAngle({tuple(sorted(dconds)): float(ang)})
            seg.append(("diag", tuple(sorted(lconds)), base, ang))
    flush()

    axes = _restore(layout, exchange, dlog)
    if axes is not None:
        plan.append(("perm", axes))

    # fold the write-only uniform init INTO the first local sandwich group
    # (the single-device engine's sandwichku fold, through the shared
    # sandwich_fold_parts; valid because ancillas are never folded, so the
    # uniform shard's group-ancilla bits are 0): one write-only pass
    # replaces a write pass plus a read-write pass
    if (len(plan) >= 2 and plan[0][0] == "ops"
            and plan[0][1] and plan[0][1][0][0] == "init_uniform"
            and plan[1][0] == "ops" and plan[1][1]):
        _, s_local, comp_dev, total = plan[0][1][0]
        parts = planes.sandwich_fold_parts(plan[1][1][0], s_local)
        if parts is not None:
            fold = ("sandwichku", s_local, comp_dev, total) + parts
            plan = ([("ops", [fold] + plan[1][1][1:])] + plan[2:])
    return plan, layout.remaps


def _uniform_carrier(s_local, comp_dev, total: int, devbit) -> float:
    """A shard's amplitude factor of the folded uniform init: uniform
    ``2^{-total/2}`` with every untouched DEVICE bit forced to 0 (the
    all-zero shard elsewhere); the local pass contributes the remaining
    ``2^{-|s_local|/2}`` through its own masks."""
    dv = float(np.float32(2.0 ** (-0.5 * (total - len(s_local)))))
    for j in comp_dev:
        dv *= 1.0 - devbit(j)
    return dv


def _apply_fused_local(re, im, ops, local_n: int, devbit,
                       symbolic: bool = True):
    """One fused segment on a shard's planes, in place: the single-device
    engine's ``planes.apply_ops`` with the symbolic angles evaluated for
    this shard (``symbolic`` False: the segment has none) and the uniform
    init scaled by the shard's carrier."""
    from qcmrf_tpu_torch.sim import planes

    for op in ops:
        kind = op[0]
        if kind == "init_uniform":
            _, s_local, comp_dev, total = op
            K.uniform_planes(local_n, s_local, out=(re, im), carrier=(
                _uniform_carrier(s_local, comp_dev, total, devbit)))
        elif kind == "sandwichku":
            _, s_local, comp_dev, total, *parts = op
            if symbolic:
                parts = _evaluate(parts, devbit)
            K.apply_hdh_sandwich_multi_uniform(
                local_n, s_local, *parts, out=(re, im),
                carrier=_uniform_carrier(s_local, comp_dev, total, devbit))
        else:
            planes.apply_ops(re, im,
                             [_evaluate(op, devbit) if symbolic else op],
                             local_n)
    return re, im


def _plan_small(circuit: Circuit, local_n: int, dlog: int):
    """Plan of the gate-by-gate path (shards under 2**10 amplitudes):
    ``('g', gate, physical positions of its qubits)`` / ``('ex', dev_j,
    loc_p)`` / ``('perm', axes)`` items and the remap count. A
    non-diagonal gate on a device qubit first evicts the local qubit
    whose next locality need is furthest away (Belady's rule)."""
    n = circuit.num_qubits
    needs = _locality_needs(circuit.gates)
    uses = {q: [] for q in range(n)}
    for gi, qs in enumerate(needs):
        for q in qs:
            uses[q].append(gi)
    layout = _Layout(n, local_n)
    plan = []

    def exchange(dev_j, loc_p):
        plan.append(("ex", dev_j, loc_p))
        layout.exchange(dev_j, loc_p)

    def ensure_local(q, gi):
        p = layout.pos[q]
        if p >= local_n:
            victim = max(range(local_n), key=lambda lp: _next_use(
                uses, layout.at_physical(lp), gi))
            exchange(p - local_n, victim)

    for gi, g in enumerate(circuit.gates):
        if g.name in ("barrier", "measure", "id"):
            continue
        if g.name in GATES_1Q:
            ensure_local(g.qubits[0], gi)
        elif g.name == "cx":
            ensure_local(g.qubits[1], gi)
        elif g.name not in ("rz", "cp", "flags_phase"):
            raise ValueError(f"unsupported sharded gate {g.name}")
        plan.append(("g", g, tuple(layout.pos[q] for q in g.qubits)))
    axes = _restore(layout, exchange, dlog)
    if axes is not None:
        plan.append(("perm", axes))
    return plan, layout.remaps


def _rotated(re, im, ang):
    """``(re + i im) * e^{i ang}``, ``ang`` a float or a float32 tensor."""
    if isinstance(ang, torch.Tensor):
        c, s = torch.cos(ang), torch.sin(ang)
    else:
        c, s = math.cos(ang), math.sin(ang)
    return re * c - im * s, re * s + im * c


def _apply_gate_local(re, im, g, pos, local_n: int, d: int, x):
    """One gate of the gate-by-gate path on shard ``d``'s flat planes
    (``x`` its local indices): new planes. Targets of non-diagonal gates
    sit on local positions; a condition on a device bit is that shard's
    constant."""
    def bit(p):
        if p < local_n:
            return ((x >> p) & 1).to(torch.float32)
        return float((d >> (p - local_n)) & 1)

    name = g.name
    if name == "rz":
        return _rotated(re, im, (g.params[0] / 2.0) * (2.0 * bit(pos[0])
                                                       - 1.0))
    if name == "cp":
        return _rotated(re, im, g.params[0] * (bit(pos[0]) * bit(pos[1])))
    if name == "flags_phase":
        mask = bit(pos[-1])
        for p, f in zip(pos[:-1], g.flags):
            b = bit(p)
            mask = mask * (b if (f + 1) // 2 else 1.0 - b)
        return _rotated(re, im, g.params[0] * mask)
    if name == "cx":
        c = bit(pos[0])
        hi, lo = 1 << (local_n - 1 - pos[1]), 1 << pos[1]
        fr = re.view(hi, 2, lo).flip(1).reshape(-1)
        fi = im.view(hi, 2, lo).flip(1).reshape(-1)
        if not isinstance(c, torch.Tensor):
            return (fr, fi) if c else (re, im)
        sel = c == 1.0
        return torch.where(sel, fr, re), torch.where(sel, fi, im)
    # a 2x2 gate on local bit pos[0]
    U = np.asarray(GATES_1Q[name], dtype=np.complex64)
    ur = torch.from_numpy(U.real.copy()).to(re.device)
    ui = torch.from_numpy(U.imag.copy()).to(re.device)
    hi, lo = 1 << (local_n - 1 - pos[0]), 1 << pos[0]
    r, i_ = re.view(hi, 2, lo), im.view(hi, 2, lo)

    def mix(m, v):
        return torch.einsum("ab,hbl->hal", m, v)

    return ((mix(ur, r) - mix(ui, i_)).reshape(-1),
            (mix(ur, i_) + mix(ui, r)).reshape(-1))


def _run_plan(path: str, plan, sym, circuit: Circuit, mesh: Mesh):
    """Run a plan of :func:`_plan_fused` (``path`` "fused": planes of
    ``(2**local_n / 128, 128)``) or :func:`_plan_small` (flat) from
    ``|0...0>``, shard ``d`` on ``mesh.devices[d]`` and its own stream:
    ``(re, im)``, each a tuple of flat shards."""
    n, D = circuit.num_qubits, mesh.size
    local_n = n - _dlog(mesh)
    shape = K.plane_shape(local_n) if path == "fused" else (1 << local_n,)
    write_only = (path == "fused" and plan and plan[0][0] == "ops"
                  and plan[0][1][0][0] in ("init_uniform", "sandwichku"))
    # the planes are allocated on the devices' current streams, before the
    # shard streams wait for them: the caller frees them there, after
    # _join's wait, and a later call reuses them at once
    make = torch.empty if write_only else torch.zeros
    re = [make(shape, dtype=torch.float32, device=dev)
          for dev in mesh.devices]
    im = [make(shape, dtype=torch.float32, device=dev)
          for dev in mesh.devices]
    if not write_only:
        re[0].view(-1)[0] = 1.0
    xs = [None if path == "fused" else torch.arange(1 << local_n, device=dev)
          for dev in mesh.devices]
    streams = _shard_streams(mesh)

    def devbits(d):
        return lambda j: (d >> j) & 1

    for item, symbolic in zip(plan, sym):
        kind = item[0]
        if kind == "ex":
            _exchange(re, im, streams, item[1], item[2], local_n)
            continue
        for d in range(D):
            with _in_stream(streams[d]):
                if kind == "ops":
                    _apply_fused_local(re[d], im[d], item[1], local_n,
                                       devbits(d), symbolic)
                elif kind == "g":
                    re[d], im[d] = _apply_gate_local(
                        re[d], im[d], item[1], item[2], local_n, d, xs[d])
                else:  # perm: one local bit permutation
                    _permute_local(re[d].view(-1), item[1], local_n)
                    _permute_local(im[d].view(-1), item[1], local_n)
    if circuit.global_phase:
        cs = float(np.cos(circuit.global_phase))
        sn = float(np.sin(circuit.global_phase))
        for d in range(D):
            with _in_stream(streams[d]):
                K._rotate(re[d], im[d], cs, sn)
    re = tuple(r.view(-1) for r in re)
    im = tuple(i_.view(-1) for i_ in im)
    _join(streams, zip(re, im))
    return re, im


def run_statevector_sharded(circuit: Circuit, mesh: Mesh):
    """Simulate a circuit with the statevector sharded over the mesh.

    Returns ``(re, im)``, each a tuple of ``D`` flat float32 shards: shard
    ``d`` holds global amplitudes ``d * 2**local_n`` to ``(d + 1) *
    2**local_n - 1`` (``local_n = n - log2 D``) on ``mesh.devices[d]``
    (:func:`gather` makes one tensor of them; JAX returns one array
    sharded over the mesh). One process drives every shard, each on its
    own stream. A non-diagonal gate on a sharded qubit triggers a targeted
    device-bit <-> local-bit exchange (half of each shard moves between
    partners); the evicted local qubit is chosen by Belady's rule
    (furthest next non-diagonal use), and an arbitrary final layout is
    restored by a sequence of such exchanges plus one local bit
    permutation.

    Shards of >= 2**10 amplitudes take the FUSED path: the shard-local
    work between exchanges runs the single-device engine's pass fusion
    (X-deferral, diagonal profiles, H·D·H sandwiches, lane / row
    composition) and its CUDA kernels, with diagonal conditions on device
    bits folded into angles evaluated for each shard (no communication).
    Smaller shards take the plain PyTorch gate-by-gate path. The plan of
    a (gate stream, mesh) pair is kept (``_SV_PLAN_CACHE``, 64 entries),
    so a repeated call skips the planner; ``LAST_REMAP_COUNT`` is the
    call's exchange count.
    """
    global LAST_REMAP_COUNT
    mesh = _sweep_mesh(mesh)
    n = circuit.num_qubits
    dlog = _dlog(mesh)
    if dlog > n - 1:
        raise ValueError("more device bits than qubits")
    local_n = n - dlog
    cache_key = (n, circuit.num_clbits, float(circuit.global_phase or 0.0),
                 tuple(circuit.gates), mesh)
    hit = _SV_PLAN_CACHE.get(cache_key)
    if hit is None:
        if local_n >= _FUSED_MIN_LOCAL:
            plan, remaps = _plan_fused(circuit, local_n, dlog)
            hit = ("fused", plan, remaps, [_has_sym(item) for item in plan])
        else:
            plan, remaps = _plan_small(circuit, local_n, dlog)
            hit = ("small", plan, remaps, [False] * len(plan))
        if len(_SV_PLAN_CACHE) >= 64:
            _SV_PLAN_CACHE.pop(next(iter(_SV_PLAN_CACHE)))
        _SV_PLAN_CACHE[cache_key] = hit
    path, plan, remaps, sym = hit
    LAST_REMAP_COUNT = remaps
    return _run_plan(path, plan, sym, circuit, mesh)


def _local_bit(x: torch.Tensor, q: int, local_n: int, d: int):
    """Bit ``q`` of the global index of shard ``d``'s local indices ``x``:
    a tensor for a local bit, shard ``d``'s constant for a device bit."""
    if q < local_n:
        return (x >> q) & 1
    return (d >> (q - local_n)) & 1


def _stray_mass(p: torch.Tensor, qubits, local_n: int, d: int):
    """The mass of shard ``d``'s flat ``p`` where any of ``qubits`` is 1:
    the whole shard where one is a device bit set in ``d``, else a sum of
    disjoint strided views (bit ``q`` 1 and every higher listed bit 0),
    with no index tensor."""
    if any(q >= local_n and (d >> (q - local_n)) & 1 for q in qubits):
        return p.sum()
    total = p.new_zeros(())
    t, rest = p, local_n
    for q in sorted((q for q in qubits if q < local_n), reverse=True):
        # split the last (contiguous) axis: still a view
        t = t.view(*t.shape[:-1], 1 << (rest - q - 1), 2, 1 << q)
        total += t[..., 1, :].sum()
        t, rest = t[..., 0, :], q
    return total


def sharded_outcome_probs(circuit: Circuit, mesh: Mesh) -> tuple:
    """Outcome distribution over classical-register values, sharded: a
    tuple of parts whose :func:`gather` is the distribution.

    Identity measurement wiring (every measured qubit wired to clbit ==
    qubit and num_clbits == num_qubits, the QCMRF convention) is the fast
    path: |psi|^2 IS the key distribution, returned as the shards'. Where
    qubits are left unmeasured (the QCMRF workspace) they are first
    verified to carry no |1> mass (tolerance 1e-6); a circuit that fails
    the check takes the marginalizing path.

    Any other wiring (permuted qubit -> clbit maps, measured subsets) is
    marginalized shard-side and stays sharded over key space: owner ``o``
    (``mesh.devices[o]``) holds keys ``o * 2**C / D`` to ``(o + 1) * 2**C
    / D - 1``, the sum of every shard's scatter-add of its |psi|^2 into
    that range, each partial added on the owner in turn (JAX runs a ring
    of D - 1 hops; the bytes moved are the same), so that no device holds
    more than two ranges. A register smaller than the mesh is one
    scatter-add summed on the first device (a 1-tuple). Keys are int64,
    but registers past 31 clbits are refused as JAX refuses them.
    Unmeasured qubits are marginalized out (deferred-measurement semantics
    of ``sim.dense.outcome_probs``)."""
    mesh = _sweep_mesh(mesh)
    nq = circuit.num_qubits
    pairs = circuit.measured_pairs
    measured = {q for q, _ in pairs}
    # no measurements at all -> the raw |psi|^2 distribution over the full
    # register, as sim.dense.outcome_probs' empty-pairs case
    identity = (not pairs
                or (all(q == c for q, c in pairs)
                    and circuit.num_clbits == nq))
    if not identity and circuit.num_clbits > 31:
        # JAX builds its keys bitwise in int32 and refuses bit 31 before
        # the statevector runs; the port refuses the same inputs
        raise ValueError(
            f"keyed marginalization caps at 31 clbits (int32 keys); got "
            f"{circuit.num_clbits}"
        )
    re, im = (list(t) for t in run_statevector_sharded(circuit, mesh))
    p2 = []
    for d in range(len(re)):  # a plane goes once it is squared: the next
        p = re[d].square()    # square reuses its memory
        re[d] = None
        p += im[d].square()
        im[d] = None
        p2.append(p)
    p2 = tuple(p2)
    D = mesh.size
    local_n = nq - _dlog(mesh)

    if identity:
        unmeasured = sorted(set(range(nq)) - measured)
        if not pairs or not unmeasured:
            return p2
        # |psi|^2 IS the key distribution iff the unmeasured qubits carry
        # no |1> mass (unwritten clbits read 0): verify with strided sums.
        # The fused QCMRF path never touches the workspace (stray mass
        # exactly 0); a |0> workspace gathers only rounding, so 1e-6 has
        # room, and rerouting costs only time, never correctness
        stray = sum(float(_stray_mass(p, unmeasured, local_n, d))
                    for d, p in enumerate(p2))
        if stray <= 1e-6:
            return p2
        if circuit.num_clbits > 31:
            raise ValueError(
                "identity-wired circuit with an unmeasured qubit "
                f"carrying |1> mass {stray:.2e} needs the keyed "
                "marginalization, which caps at 31 clbits (int32 keys); "
                f"got {circuit.num_clbits}"
            )

    C = circuit.num_clbits
    keys = []
    for d, p in enumerate(p2):
        x = torch.arange(1 << local_n, device=p.device)
        k = torch.zeros_like(x)
        for q, c in pairs:
            k |= _local_bit(x, q, local_n, d) << c
        keys.append(k)

    if (1 << C) < D:
        # a register smaller than the mesh: the keyed buffer is tiny
        dev0 = mesh.devices[0]
        out = torch.zeros(1 << C, dtype=torch.float32, device=dev0)
        for k, p in zip(keys, p2):
            part = torch.zeros(1 << C, dtype=p.dtype, device=p.device)
            out += part.index_add_(0, k, p).to(dev0)
        return (out,)

    chunk = (1 << C) // D
    shift = C - _dlog(mesh)
    owners = [k >> shift for k in keys]
    slots = [k & (chunk - 1) for k in keys]
    out = []
    for o, dev in enumerate(mesh.devices):
        acc = torch.zeros(chunk, dtype=torch.float32, device=dev)
        for own, slot, p in zip(owners, slots, p2):
            sel = own == o
            part = torch.zeros(chunk, dtype=p.dtype, device=p.device)
            acc += part.index_add_(0, slot[sel], p[sel]).to(dev)
        out.append(acc)
    return tuple(out)
