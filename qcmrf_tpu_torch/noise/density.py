"""Gate-level noisy density-matrix engine (port of
:mod:`qcmrf_tpu.noise.density`), in torch on the device.

A depolarizing channel acts after every lowered 1q/2q gate, where the gate
executes, so errors propagate through the later CX / phase structure. The
engine evolves the exact density matrix over the lowered basis ``[cx, id,
rz, sx, x]`` (:mod:`qcmrf_tpu_torch.circuits.lower`): rho is ``(2^w,
2^w)`` complex64 (8 MB at the suite's widest, 10 qubits) and lives on the
device, the current CUDA device unless the caller names one.

* ``rz`` is a diagonal phase on both sides of rho. Consecutive phases
  commute with each other and carry no error, so their angles are summed
  per basis state in float64 and applied as one phase pass just before the
  next non-diagonal gate.
* ``x`` and ``cx`` are index permutations of rows and columns together
  (one gather), with no matrix built.
* a 1q gate ``U rho U^dagger`` is a reshaped contraction, rows then
  columns.
* IBM convention: ``rz`` is a virtual frame change (no error);
  depolarizing attaches to the physical pulses ``sx``/``x`` (rate ``p1q``)
  and ``cx`` (rate ``p2q``, the joint 2-qubit channel ``rho -> (1-p) rho +
  p I/4 (x) tr_ab(rho)``). ``id`` and idle periods carry no error.
* Mid-circuit measurements are deferred. That is exact under gate noise
  because QCMRF never touches a qubit again after measuring it;
  :func:`noisy_clbit_probs` checks the property and raises on circuits
  that break it.

:func:`evolve_density_batch` evolves B circuits whose lowered gate lists
agree in names and qubits (the reps of one graph: only their ``rz``
angles differ) as one ``(B, 2^w, 2^w)`` tensor, each with its own angles
and its own rates.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from qcmrf_tpu_torch.circuits.ir import Circuit
from qcmrf_tpu_torch.sim.dense import GATES_1Q
from qcmrf_tpu_torch.utils.config import resolve_device

_PHYSICAL_1Q = ("sx", "x", "sxdg", "h")  # pulses that carry p1q error
_SKIP = ("measure", "barrier", "id")
MAX_WIDTH = 13
#: bytes of rho a batch holds at once; larger batches go in chunks
BATCH_BYTES = 1 << 30


def _check_deferred_ok(circuit: Circuit) -> None:
    measured = set()
    for g in circuit.gates:
        if g.name == "measure":
            measured.add(g.qubits[0])
        elif g.name != "barrier" and measured.intersection(g.qubits):
            raise ValueError(
                "gate on an already-measured qubit: deferred-measurement "
                "noise semantics would be wrong for this circuit"
            )


def _check_width(w: int) -> None:
    if w > MAX_WIDTH:
        raise ValueError(
            f"density engine is for suite widths (<={MAX_WIDTH} qubits), "
            f"got {w}"
        )


def _check_lowered(circuit: Circuit) -> None:
    for g in circuit.gates:
        if g.name not in _SKIP and g.name not in ("rz", "x", "cx") \
                and g.name not in GATES_1Q:
            raise ValueError(
                f"density engine consumes lowered circuits; got {g.name!r}"
            )


def _signature(circuit: Circuit) -> tuple:
    return (circuit.num_qubits,
            tuple((g.name, g.qubits) for g in circuit.gates
                  if g.name not in _SKIP))


def _depolarize(rho: torch.Tensor, qs: Sequence[int], keep: torch.Tensor,
                frac: torch.Tensor, w: int) -> None:
    """In place on a ``(B, 2^w, 2^w)`` batch: ``rho -> keep * rho + frac *
    (I (x) tr_qs rho)``, ``keep`` and ``frac`` ``(B,)`` in rho's dtype on
    its device (``1 - p`` and ``p / 2^k``)."""
    B = rho.shape[0]
    k = len(qs)
    order = sorted(qs, reverse=True)  # descending bit position
    # split one side's index into (s0, 2, s1, 2, ..., sk) segments
    segs = []
    prev = w
    for q in order:
        segs.append(1 << (prev - 1 - q))
        segs.append(2)
        prev = q
    segs.append(1 << prev)
    m = len(segs)
    r = rho.reshape((B,) + tuple(segs) * 2)

    def diag_slice(bits):
        sl = []
        for i in range(m):
            sl.append(bits[i // 2] if i % 2 else slice(None))
        return (slice(None),) + tuple(sl) * 2

    # partial trace over the qubit axes: sum of the 2^k diagonal slices
    patterns = list(itertools.product((0, 1), repeat=k))
    tr = r[diag_slice(patterns[0])].clone()
    for bits in patterns[1:]:
        tr += r[diag_slice(bits)]
    r.mul_(keep.reshape((B,) + (1,) * (2 * m)))
    tr.mul_(frac.reshape((B,) + (1,) * (tr.dim() - 1)))
    for bits in patterns:
        r[diag_slice(bits)].add_(tr)


def depolarize_qubits(rho: torch.Tensor, qs: Sequence[int], p,
                      w: int) -> torch.Tensor:
    """Joint depolarizing on qubits ``qs``:
    rho -> (1-p) rho + p * (I/2^k (x) tr_qs rho).

    ``rho`` is ``(2^w, 2^w)`` or a batch ``(B, 2^w, 2^w)``; ``p`` a float
    or one rate a batch row. IN PLACE: mutates ``rho`` through reshaped
    views and returns it; a caller that needs its input pass a clone."""
    batch = rho if rho.dim() == 3 else rho[None]
    p = np.array(np.broadcast_to(np.asarray(p, dtype=np.float64),
                                 (batch.shape[0],)))
    if p.any():
        keep, frac = (torch.as_tensor(v, device=rho.device).to(rho.dtype)
                      for v in (1.0 - p, p / (1 << len(qs))))
        _depolarize(batch, qs, keep, frac, w)
    return rho


def _apply_1q(rho: torch.Tensor, U: torch.Tensor, q: int,
              w: int) -> torch.Tensor:
    """``U rho U^dagger`` on a ``(B, 2^w, 2^w)`` batch, qubit ``q``."""
    B, n = rho.shape[0], 1 << w
    hi, lo = 1 << (w - 1 - q), 1 << q
    Uc = U.conj()

    def side(v, M):
        # v: (..., 2, l); out[..., a, l] = sum_b M[a, b] v[..., b, l]
        return v[..., 0:1, :] * M[:, 0:1] + v[..., 1:2, :] * M[:, 1:2]

    r = side(rho.reshape(B, hi, 2, lo * n), U)
    r = side(r.reshape(B, n * hi, 2, lo), Uc)
    return r.reshape(B, n, n)


def _rates(value, B: int) -> np.ndarray:
    return np.array(np.broadcast_to(np.asarray(value, dtype=np.float64),
                                    (B,)))


def _evolve_same(circuits: Sequence[Circuit], p1q, p2q, dtype, rates,
                 device: torch.device) -> torch.Tensor:
    """Evolve circuits whose gate lists agree in names and qubits."""
    B = len(circuits)
    w = circuits[0].num_qubits
    n = 1 << w
    rate = {name: _rates(p1q, B) for name in _PHYSICAL_1Q}
    rate["cx"] = _rates(p2q, B)
    for name, v in (rates or {}).items():
        rate[name] = _rates(v, B)
    gate_lists = [[g for g in c.gates if g.name not in _SKIP]
                  for c in circuits]
    ops = gate_lists[0]
    rz_at = [i for i, g in enumerate(ops) if g.name == "rz"]
    # every rep's rz angles in one upload: (num rz gates, B)
    angles = torch.as_tensor(
        np.array([[gl[i].params[0] for gl in gate_lists] for i in rz_at],
                 dtype=np.float64).reshape(len(rz_at), B),
        device=device)
    rz_row = {i: k for k, i in enumerate(rz_at)}
    idx = torch.arange(n, device=device)
    signs = [((idx >> q) & 1).to(torch.float64) - 0.5 for q in range(w)]
    mats = {name: torch.as_tensor(np.asarray(GATES_1Q[name]), dtype=dtype,
                                  device=device) for name in GATES_1Q}
    channel = {}  # (name, k) -> (keep, frac) a row, uploaded once
    perms = {}  # qubits of an x / cx -> its index permutation

    def depolarize(rho, g):
        key = (g.name, len(g.qubits))
        if key not in channel:
            p = rate[g.name]
            channel[key] = tuple(torch.as_tensor(v, device=device).to(dtype)
                                 for v in (1.0 - p, p / (1 << key[1])))
        _depolarize(rho, g.qubits, *channel[key], w)

    rho = torch.zeros((B, n, n), dtype=dtype, device=device)
    rho[:, 0, 0] = 1.0
    phase = None  # pending rz angles per basis state, (B, n) float64

    def flush(rho, phase):
        z = torch.polar(torch.ones_like(phase), phase).to(dtype)
        rho.mul_(z[:, :, None])
        rho.mul_(z.conj()[:, None, :])

    for i, g in enumerate(ops):
        if g.name == "rz":
            # e^{i lam/2 (2b - 1)} on the basis states' bit b of qubit q
            term = angles[rz_row[i]][:, None] * signs[g.qubits[0]][None, :]
            phase = term if phase is None else phase.add_(term)
            continue
        if phase is not None:
            flush(rho, phase)
            phase = None
        if g.name in ("x", "cx"):
            perm = perms.get(g.qubits)
            if perm is None:
                c, t = g.qubits if g.name == "cx" else (None, g.qubits[0])
                flip = 1 << t if c is None else ((idx >> c) & 1) << t
                perm = perms[g.qubits] = idx ^ flip
            rho = rho[:, perm[:, None], perm[None, :]]
        else:
            rho = _apply_1q(rho, mats[g.name], g.qubits[0], w)
        if g.name in rate and rate[g.name].any():
            depolarize(rho, g)
    if phase is not None:
        flush(rho, phase)
    return rho


def evolve_density_batch(
    circuits: Sequence[Circuit],
    p1q=0.0,
    p2q=0.0,
    dtype=torch.complex64,
    rates: Optional[Dict[str, object]] = None,
    device=None,
) -> torch.Tensor:
    """Final density matrices ``(B, 2^w, 2^w)`` of B lowered circuits
    under per-gate depolarizing, on ``device`` (the current CUDA device
    unless one is named). ``p1q``, ``p2q`` and the values of ``rates``
    (per-gate-name overrides, e.g. ``{"cx": 0.003}``) are floats or one
    rate a circuit. Circuits whose lowered gate lists agree in names and
    qubits evolve together, one batch row each; otherwise they evolve one
    at a time on the same device."""
    device = resolve_device(device)
    circuits = list(circuits)
    B = len(circuits)
    for c in circuits:
        _check_width(c.num_qubits)
        _check_lowered(c)
    p1q, p2q = _rates(p1q, B), _rates(p2q, B)
    rates = {k: _rates(v, B) for k, v in (rates or {}).items()}

    def pick(sel):
        return dict(p1q=p1q[sel], p2q=p2q[sel],
                    rates={k: v[sel] for k, v in rates.items()})

    sig = _signature(circuits[0])
    if any(_signature(c) != sig for c in circuits[1:]):
        return torch.cat([
            _evolve_same([c], dtype=dtype, device=device, **pick([b]))
            for b, c in enumerate(circuits)])
    n = 1 << circuits[0].num_qubits
    itemsize = torch.empty((), dtype=dtype).element_size()
    chunk = max(1, BATCH_BYTES // (n * n * itemsize))
    parts = [_evolve_same(circuits[s:s + chunk], dtype=dtype, device=device,
                          **pick(slice(s, s + chunk)))
             for s in range(0, B, chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def evolve_density(
    circuit: Circuit,
    p1q: float = 0.0,
    p2q: float = 0.0,
    dtype=torch.complex64,
    rates: Optional[Dict[str, float]] = None,
    device=None,
) -> torch.Tensor:
    """Final density matrix ``(2^w, 2^w)`` of the lowered circuit under
    per-gate depolarizing. ``rates`` optionally overrides the per-gate-name
    rate (e.g. ``{"cx": 0.003}``)."""
    return evolve_density_batch([circuit], p1q, p2q, dtype=dtype,
                                rates=rates, device=device)[0]


def clbit_probs_from_diag(circuit: Circuit,
                          diag: torch.Tensor) -> torch.Tensor:
    """Map the ``2^w`` diagonal (or a batch of them, ``(B, 2^w)``) onto
    the ``2^num_clbits`` outcome distribution in float64 (deferred
    measurement; unwritten clbits read 0)."""
    w = circuit.num_qubits
    idx = torch.arange(1 << w, device=diag.device)
    keys = torch.zeros_like(idx)
    for q, c in circuit.measured_pairs:
        keys |= ((idx >> q) & 1) << c
    out = torch.zeros(diag.shape[:-1] + (1 << circuit.num_clbits,),
                      dtype=torch.float64, device=diag.device)
    return out.index_add_(-1, keys, diag.to(torch.float64))


def _clbit_probs(circuit: Circuit, rho: torch.Tensor) -> torch.Tensor:
    diag = torch.diagonal(rho, dim1=-2, dim2=-1).real.clamp_min(0.0)
    probs = clbit_probs_from_diag(circuit, diag)
    s = probs.sum(-1, keepdim=True)
    bad = [float(v) for v in s.reshape(-1).cpu() if not 0.97 < float(v) < 1.03]
    if bad:  # float32 accumulation sanity bound
        raise RuntimeError(f"density diagonal lost normalization: {bad[0]}")
    return probs / s


def noisy_clbit_probs(
    circuit: Circuit,
    p1q: float = 0.0,
    p2q: float = 0.0,
    dtype=torch.complex64,
    rates: Optional[Dict[str, float]] = None,
    device=None,
) -> torch.Tensor:
    """Exact outcome distribution of the noisy circuit over its classical
    register, float64 on ``device`` (before any readout error: that is a
    separate channel on the clbit distribution, :func:`confuse_bits`)."""
    return noisy_clbit_probs_batch([circuit], p1q, p2q, dtype=dtype,
                                   rates=rates, device=device)[0]


def noisy_clbit_probs_batch(
    circuits: Sequence[Circuit],
    p1q=0.0,
    p2q=0.0,
    dtype=torch.complex64,
    rates: Optional[Dict[str, object]] = None,
    device=None,
) -> torch.Tensor:
    """:func:`noisy_clbit_probs` of B circuits, ``(B, 2^num_clbits)``,
    through :func:`evolve_density_batch`. The circuits share one clbit
    wiring when they evolve as one batch."""
    circuits = list(circuits)
    for c in circuits:
        _check_deferred_ok(c)
    rho = evolve_density_batch(circuits, p1q, p2q, dtype=dtype, rates=rates,
                               device=device)
    wiring = {(c.num_qubits, c.num_clbits, tuple(c.measured_pairs))
              for c in circuits}
    if len(wiring) == 1:
        return _clbit_probs(circuits[0], rho)
    return torch.stack([_clbit_probs(c, r) for c, r in zip(circuits, rho)])


def confuse_bits(probs, e01, e10, bits: Sequence[int], width: int,
                 invert: bool = False, device=None) -> torch.Tensor:
    """Per-bit readout confusion (or its inverse) on a key distribution in
    float64, on the probabilities' device (a host array goes to ``device``,
    the current CUDA device unless one is named); the same column-stochastic
    convention as :func:`qcmrf_tpu_torch.noise.channels.apply_readout_confusion`.

    ``probs`` is ``(2^width,)`` or a batch ``(B, 2^width)``; ``e01`` and
    ``e10`` are one rate a bit (or a scalar for all bits), or a ``(B,
    len(bits))`` array of one rate a bit a batch row."""
    if not isinstance(probs, torch.Tensor):
        probs = torch.as_tensor(np.asarray(probs), device=resolve_device(device))
    q = probs.to(torch.float64)
    lead = q.shape[:-1]
    q = q.reshape(-1, 1 << width)
    nb = len(bits)

    def rate(e):
        e = torch.as_tensor(np.asarray(e, dtype=np.float64), device=q.device)
        return e.reshape(-1, nb) if e.dim() == 2 else e.expand(nb)[None]

    e01, e10 = rate(e01), rate(e10)
    e01, e10 = torch.broadcast_tensors(e01, e10)
    # M[..., m, t] = P(measured m | true t), one matrix a row and a bit
    M = torch.stack([torch.stack([1.0 - e01, e10], -1),
                     torch.stack([e01, 1.0 - e10], -1)], -2)
    if invert:
        M = torch.linalg.inv(M)
    for i, b in enumerate(bits):
        lo, hi = 1 << b, 1 << (width - 1 - b)
        v = q.reshape(-1, hi, 2, lo)
        q = torch.einsum("zmt,zhtl->zhml", M[:, i].expand(v.shape[0], 2, 2),
                         v).reshape(-1, 1 << width)
    return q.reshape(lead + (1 << width,))
