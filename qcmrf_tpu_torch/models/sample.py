"""Classical samplers over MRFs: exact, Gibbs chain and perturb-and-MAP
(port of :mod:`qcmrf_tpu.models.sample`).

* :func:`sample_exact`: IID draws from the Gibbs distribution by the
  ``2**n`` logits of the log-potential kernel;
* :func:`sample_gibbs` (state ids) and :func:`sample_gibbs_bits` (bit
  rows, any n): one systematic-scan chain, thinned, through the chain
  kernel (:func:`qcmrf_tpu_torch.ops.gibbs_kernel.gibbs_chains`), whose
  site update is :func:`bits_site_delta_fn`'s local energy;
* :func:`sample_pam` (state ids) and :func:`sample_pam_streaming` (bit
  rows): low-order perturb-and-MAP, every sample the exact MAP of
  ``beta * theta`` plus IID Gumbel noise on every clique-state weight; the
  perturbed models are coefficient rows of one map-kernel launch
  (:func:`kernels.map_partials`), no ``2**n`` array of perturbed values;
* :func:`sample_conditional`: samples given evidence, by exact clique-table
  reduction and the method's sampler on the free-variable model;
* :func:`map_state`: the argmax of the log-potential table (on the card
  the streaming argmax kernel, :func:`kernels.map_state_streaming`);
* :func:`map_state_clamped`: the evidence-constrained MAP (MPE) for any
  clique structure, by exact clique-table reduction
  (:func:`qcmrf_tpu_torch.models.moments.reduce_evidence`) and the
  streaming argmax kernel on the free-variable model.

A sampler takes a ``torch.Generator`` on the model's device, or an integer
seed for one; the chains take a 32-bit Philox seed, drawn from the
generator when one is given. JAX's keys give other numbers: the port's
draws agree with the JAX package's in distribution, not draw for draw.
"""

from __future__ import annotations

import torch

from qcmrf_tpu_torch.models import capability
from qcmrf_tpu_torch.models.mrf import MRF
from qcmrf_tpu_torch.utils import profiling

#: sample_conditional's PAM routing: max-product elimination up to this
#: induced width (per-sample traceback tables of ``2^width`` entries),
#: the streaming argmax sweep past it
_PAM_ELIM_WIDTH = capability.PAM_ELIM_WIDTH

#: sample_conditional's exact routing: the enumerated table up to this
#: many free variables, elimination's ancestral sampler past it
_EXACT_TABLE_N = 20

#: sample_exact: most ``num_samples * num_states`` for the single-stage
#: draw (its Gumbel matrix holds that many floats); bigger draws split
#: into the exact two-stage block categorical
_CATEGORICAL_BUDGET = 1 << 28


def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1) (a
    draw of 0 is lifted to the smallest normal float, as JAX's ``gumbel``
    draws from [tiny, 1): the noise stays finite)."""
    u = torch.rand(shape, generator=gen, device=device)
    u.clamp_(min=torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


def _generator(generator, device) -> torch.Generator:
    """``generator``, or a ``torch.Generator`` on ``device`` seeded with
    the integer ``generator``."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def _chain_seed(generator) -> int:
    """A chain's 32-bit Philox seed: the integer itself, or one drawn from
    the ``torch.Generator``."""
    if isinstance(generator, torch.Generator):
        return int(torch.randint(0, 1 << 31, (1,), generator=generator,
                                 device=generator.device))
    return int(generator) & 0xFFFFFFFF


def _bits(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int32 bit rows ``(num, n)`` of int64 state ids (variable 0 the most
    significant bit)."""
    shifts = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=ids.device)
    return ((ids.to(torch.int64)[:, None] >> shifts) & 1).to(torch.int32)


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
    generator = _generator(generator, dev)
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
    the streaming argmax (:func:`kernels.map_state_streaming`; with
    ``mesh``, :func:`sharded.sharded_map_state`, unless the reduced model
    is smaller than the mesh), and the winner's bits re-embed around the
    evidence."""
    from qcmrf_tpu_torch.models import moments
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.parallel import sharded

    red, const = moments.reduce_evidence(mrf, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    n = mrf.n
    base = 0
    for v, b in ev.items():
        base |= b << (n - 1 - v)
    with profiling.span("qcmrf.wait"):
        offset = float(mrf.beta) * float(const)
    if red is None:
        return base, offset
    mesh = sharded.fit_mesh(mesh, red.n)
    rid, val = (kernels.map_state_streaming(red) if mesh is None
                else sharded.sharded_map_state(red, mesh))
    free = [v for v in range(n) if v not in ev]
    nf = len(free)
    for j, v in enumerate(free):
        base |= ((rid >> (nf - 1 - j)) & 1) << (n - 1 - v)
    return base, val + offset




# --------------------------------------------------------------------------
# Gibbs chains
# --------------------------------------------------------------------------


def bits_site_delta_fn(mrf: MRF):
    """``site_delta(v, bits)`` = the log-potential ``theta^T phi`` of
    ``bits`` with x_v = 1 less that with x_v = 0, from the cliques that
    hold v only (the chains' local energy; theta at beta 1). ``bits`` is an
    integer array or tensor ``(..., n)`` of 0 and 1; the result is float32
    of shape ``bits.shape[:-1]`` on ``mrf``'s device, summed in the chain
    kernel's order (:func:`gibbs_kernel.site_deltas`)."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    theta = mrf.theta.detach()[None]

    def site_delta(v, bits):
        b = torch.as_tensor(bits, device=mrf.device).to(torch.int64)
        flat = b.reshape(-1, mrf.n)
        d = gibbs_kernel.site_deltas(mrf.cliques, mrf.n,
                                     theta.expand(flat.shape[0], -1), flat,
                                     int(v))
        return d.reshape(b.shape[:-1])

    return site_delta


def sample_gibbs_bits(generator, mrf: MRF, num_samples: int, thin: int = 10,
                      burn: int = 10) -> torch.Tensor:
    """One single-site systematic-scan Gibbs chain on a bit-array state
    (any n): ``burn + (num_samples - 1) * thin + 1`` sweeps, every site
    drawn from its local conditional (the cliques that hold it only), and
    the state after sweeps ``burn + i * thin`` returned as int32 bits
    ``(num_samples, n)`` on ``mrf``'s device. One launch of the chain
    kernel (:func:`gibbs_kernel.gibbs_chains`, C = 1) on the card; its
    plain version on the CPU. ``generator`` is an integer seed or a
    ``torch.Generator`` (:func:`_chain_seed`)."""
    from qcmrf_tpu_torch.ops import gibbs_kernel

    with torch.no_grad():
        out = gibbs_kernel.gibbs_chains(
            _chain_seed(generator), mrf.cliques, mrf.n,
            mrf.theta.detach().reshape(1, -1), mrf.beta,
            num_samples, thin, burn)
    return out[0].to(torch.int32)


def sample_gibbs(generator, mrf: MRF, num_samples: int, thin: int = 10,
                 burn: int = 10) -> torch.Tensor:
    """The chain of :func:`sample_gibbs_bits` as int32 state ids
    ``(num_samples,)`` (variable 0 the most significant bit; n <= 30), the
    reference's ``--mode gibbs`` baseline (a long chain thinned by 10)."""
    if mrf.n > 30:
        raise ValueError(f"n={mrf.n}: int32 state ids end at n = 30; use "
                         "sample_gibbs_bits")
    from qcmrf_tpu_torch.ops import gibbs_kernel

    bits = sample_gibbs_bits(generator, mrf, num_samples, thin, burn)
    return gibbs_kernel.ids_from_bits(bits).to(torch.int32)


# --------------------------------------------------------------------------
# Perturb-and-MAP
# --------------------------------------------------------------------------

#: a PAM call's map-kernel outputs hold at most this many (row, block)
#: pairs at once on the card, and its plain version this many table values
_PAM_CHUNK = 1 << 22


def _pam_ids(generator, mrf: MRF, num_samples: int,
             mesh=None) -> torch.Tensor:
    """int64 ids ``(num_samples,)``: for each sample, IID standard Gumbel
    noise on every entry of ``beta * theta``, and the MAP state of that
    perturbed model (at beta 1): the perturbed models are the coefficient
    rows of :func:`kernels.map_partials` (the map kernel on the card, the
    chain's table on the CPU), the first maximum on ties. Rows go to the
    kernel in chunks whose outputs stay within ``_PAM_CHUNK`` pairs (table
    values on the CPU), the noise drawn chunk by chunk in sample order.
    With a 1-D ``mesh`` each chunk's sweep is sharded over it
    (``sharded._map_partials``); the noise and the answer are the
    same."""
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.parallel import sharded

    dev = mrf.device
    gen = _generator(generator, dev)
    cl, n = mrf.cliques, mrf.n
    if dev.type == "cpu":
        per = max(1, _PAM_CHUNK >> n)
    else:
        per = max(1, _PAM_CHUNK // kernels.lse_geometry(1 << n)[0])
    base = mrf.beta * mrf.theta.detach()
    out = torch.empty(num_samples, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for lo in range(0, num_samples, per):
            rows = min(per, num_samples - lo)
            g = _gumbel(gen, (rows, mrf.dimension), dev)
            coef = kernels.coefficient_table(cl, n, g.add_(base))
            parts = (kernels.map_partials(cl, n, coef, 1.0) if mesh is None
                     else sharded._map_partials(mesh, cl, n, coef, 1.0))
            out[lo:lo + rows] = kernels.combine_map(*parts)[1]
    return out


def sample_pam(generator, mrf: MRF, num_samples: int) -> torch.Tensor:
    """Low-order perturb-and-MAP samples as int32 state ids
    ``(num_samples,)`` (the reference's ``--mode pam`` baseline): IID
    Gumbel noise on every clique-state weight of ``beta * theta``, and the
    MAP state of each perturbed model, by the map kernel with the perturbed
    models as rows of one launch. Approximate (the low-order perturbation
    bounds the law), as the classical baseline is. The map kernel returns
    the chain's maximum with the earliest id; the JAX package's table
    argmax sums the clique entries in another order, so a near-tie may fall
    to another state: a deviation in distribution only."""
    return _pam_ids(generator, mrf, num_samples).to(torch.int32)


def sample_pam_streaming(generator, mrf: MRF,
                         num_samples: int) -> torch.Tensor:
    """The perturb-and-MAP samples of :func:`sample_pam` as int32 bit rows
    ``(num_samples, n)`` (column v = variable v), for any structure: the
    map kernel sweeps every perturbed model without a ``2**n`` array (on
    the CPU, below any n, the chain's table of each). With the same
    generator state the two forms give identical samples."""
    return _bits(_pam_ids(generator, mrf, num_samples), mrf.n)


# --------------------------------------------------------------------------
# Evidence-conditioned sampling: clamp by exact clique-table reduction,
# run the method's sampler on the free-variable model, re-embed.
# --------------------------------------------------------------------------


def sample_conditional(generator, mrf: MRF, num_samples: int,
                       evidence: dict, method: str = "exact",
                       mesh=None) -> torch.Tensor:
    """Samples of ``p(x_free | evidence)`` as int32 bit rows ``(num, n)``
    on ``mrf``'s device, the evidence columns clamped (column v = variable
    v). The evidence reduces the model exactly
    (:func:`moments.reduce_evidence`) and the reduced model runs:

    - ``"exact"``: IID exact draws: the enumerated table up to
      ``_EXACT_TABLE_N`` free variables; past it elimination's ancestral
      sampler (bounded width and stored factors), else the table up to
      ``capability.EXACT_TABLE_HARD_N``; past every cap it raises;
    - ``"gibbs"``: the bit-array chain (any n);
    - ``"pam"``: perturb-and-MAP: max-product elimination up to induced
      width ``_PAM_ELIM_WIDTH`` (from ``MIN_KERNEL_N`` free variables),
      the map kernel's streaming sweep otherwise; wide and past
      ``capability.STREAMING_MAX_N`` raises. A free variable in no reduced
      clique is an independent uniform bit, drawn after the PAM samples.
      With ``mesh`` (and a reduced model no smaller than it) the argmax
      sweeps shard over it (:func:`sharded.sharded_sample_pam`), in place
      of elimination's PAM too, as the JAX package routes it.

    The caps are read from :mod:`capability` at call time; ``mesh``
    serves ``"pam"`` only."""
    from qcmrf_tpu_torch.models import elimination, moments
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.parallel import sharded

    dev = mrf.device
    red, _ = moments.reduce_evidence(mrf, evidence)
    ev = {int(v): int(b) for v, b in evidence.items()}
    n = mrf.n
    bits = torch.zeros((num_samples, n), dtype=torch.int32, device=dev)
    for v, b in ev.items():
        bits[:, v] = b
    if red is None:
        return bits
    if method not in ("exact", "gibbs", "pam"):
        raise ValueError(f"unknown method {method!r}; expected "
                         "'exact', 'gibbs', or 'pam'")
    gen = _generator(generator, dev)
    free = [v for v in range(n) if v not in ev]
    if method == "pam":
        covered = {j for C in red.cliques for j in C}
        iso = [j for j in range(red.n) if j not in covered]
        width = elimination.induced_width(red.cliques, red.n)
        max_n = capability.STREAMING_MAX_N
        if red.n > max_n and width > _PAM_ELIM_WIDTH:
            raise ValueError(
                f"conditional PAM on this model needs either the "
                f"streaming argmax sweep (free variables {red.n} > cap "
                f"{max_n}) or max-product elimination (induced width "
                f"{width} > cap {_PAM_ELIM_WIDTH}: per-sample traceback "
                f"tables are steps x 2^width); add evidence to shrink the "
                f"free set or use method='gibbs' on a narrower submodel")
        mesh = sharded.fit_mesh(mesh, red.n)
        if mesh is not None:
            rbits = sharded.sharded_sample_pam(gen, red, mesh, num_samples)
        elif red.n >= kernels.MIN_KERNEL_N and width <= _PAM_ELIM_WIDTH:
            rbits = elimination.sample_pam(gen, red, num_samples)
        else:
            rbits = sample_pam_streaming(gen, red, num_samples)
        if iso:
            rbits[:, iso] = (torch.rand((num_samples, len(iso)),
                                        generator=gen, device=dev)
                             < 0.5).to(torch.int32)
    elif method == "exact" and red.n > _EXACT_TABLE_N:
        width = elimination.induced_width(red.cliques, red.n)
        cap = capability.ELIM_WIDTH_CAP
        floats_cap = capability.SAMPLER_TABLE_FLOATS_CAP
        hard_n = capability.EXACT_TABLE_HARD_N
        if width <= cap and elimination.plan_table_floats(
                red.cliques, red.n) <= floats_cap:
            rbits = elimination.sample_exact_elim(gen, red, num_samples)
        elif red.n <= hard_n:
            rbits = _bits(sample_exact(gen, red, num_samples), red.n)
        else:
            raise ValueError(
                f"exact conditional sampling on this model needs either "
                f"an enumerable table (free variables {red.n} > cap "
                f"{hard_n}) or elimination's ancestral sampler (induced "
                f"width {width} > cap {cap}, or its stored step factors "
                f"over {floats_cap:.3g} floats); add evidence to shrink "
                f"the free set, or use method='gibbs' (approximate) or "
                f"method='pam'")
    elif method == "gibbs":
        rbits = sample_gibbs_bits(gen, red, num_samples)
    else:
        rbits = _bits(sample_exact(gen, red, num_samples), red.n)
    bits[:, free] = rbits.to(torch.int32)
    return bits
