"""Backend-feasibility caps and the capability matrix (port of
:mod:`qcmrf_tpu.models.capability`): the same caps, width-cap override
and :func:`explain` dict, served by ``infer --explain``, and the big-n
threshold of the train CLI's bit-array data path. Host only: nothing here
touches a device.

The caps (why each exists):

* ``ELIM_WIDTH_CAP``: max induced width routed through variable
  elimination; a wider plan's per-step ``2^width`` factor tables stop
  paying off against the streaming sweep (128 MB at 25). Env override
  ``QCMRF_ELIM_WIDTH_CAP`` forces the streaming branch from a real
  process without a 2^26-state model.
* ``STREAMING_MAX_N``: the streaming sweeps' n cap of the JAX package
  (int32 block ids over a 2^16-state block: 47 = 31 + 16). The port's
  kernels use int64 ids and need no such cap; it is kept so that both
  packages route and refuse alike.
* ``MMAP_WIDTH_CAP``: marginal-MAP's constrained (sum-first, max-last)
  elimination width; a 2^30-entry float32 message is ~4 GB.
* ``MMAP_ENUM_MAX_VARS``: past that width, streaming mmap enumerates
  ``2^|max_vars|`` clamped sweeps; 16 bounds the blowup.
* ``EXACT_TABLE_HARD_N``: the exact sampler's single table of ``2^n``
  logits; 26 = 256 MB float32.
* ``SAMPLER_TABLE_FLOATS_CAP``: elimination's ancestral sampler stores
  every step's factor table; 2^28 floats = 1 GB.
* ``CIRCUIT_SAMPLER_MAX_N``: circuit shot samplers return int32 state
  ids, so quantum-in-the-loop training caps at n = 30.

One departure from the JAX package: for ``query="sample"`` it selects
``sampler:pam`` even where that sampler is marked infeasible (width past
``ELIM_WIDTH_CAP`` and n past ``STREAMING_MAX_N``); here ``selected`` is
then ``None``, as for every other query with no feasible backend.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

#: max induced width routed through variable elimination (any n).
ELIM_WIDTH_CAP = int(os.environ.get("QCMRF_ELIM_WIDTH_CAP", "25"))

#: the JAX package's streaming n cap (its int32 block ids x 2^16 block),
#: kept so that both packages route alike.
STREAMING_MAX_N = 47

#: marginal-MAP constrained-elimination width cap (4 GB message table).
MMAP_WIDTH_CAP = 30

#: streaming mmap enumerates 2^|max_vars| clamped sweeps; cap the set.
MMAP_ENUM_MAX_VARS = 16

#: exact sampler's single-stage 2^n logits table cap (256 MB float32).
EXACT_TABLE_HARD_N = 26

#: ancestral sampler's stored-factor budget (2^28 floats = 1 GB).
SAMPLER_TABLE_FLOATS_CAP = 1 << 28

#: circuit shot samplers return int32 state ids (``--grad shots``).
CIRCUIT_SAMPLER_MAX_N = 30


def big_n_threshold() -> int:
    """n above which the train CLI's data travels as bit arrays (int32
    state ids end); ``QCMRF_BIG_N_THRESHOLD`` lets tests drive that path
    at tiny widths. Read at call time."""
    return int(os.environ.get("QCMRF_BIG_N_THRESHOLD", "30"))


def _entry(ok: bool, reason: str) -> Dict:
    return {"feasible": bool(ok), "reason": reason}


def explain(cliques: Sequence[Sequence[int]], n: int,
            evidence: Optional[dict] = None,
            query: str = "lnz",
            max_vars: Optional[Sequence[int]] = None,
            mesh: bool = False) -> Dict:
    """Feasibility of every backend for one (structure, query) — the
    printable capability matrix behind ``infer --explain``.

    Returns ``{"n", "induced_width", "query", "backends": {name:
    {"feasible", "reason"}}, "selected": name_or_None}`` where
    ``selected`` is the backend the infer CLI's routing would use.
    Host-side analysis only — never initializes a device backend, so
    it is safe to call before platform resolution.
    """
    from qcmrf_tpu_torch.models import elimination

    evidence = dict(evidence or {})
    cl = [tuple(sorted(int(v) for v in C)) for C in cliques]
    width = elimination.induced_width(cl, n)
    wide = width > ELIM_WIDTH_CAP
    use_streaming = wide or mesh
    nf = n - len(evidence)

    b: Dict[str, Dict] = {}
    b["elimination"] = _entry(
        not wide,
        f"induced width {width} <= cap {ELIM_WIDTH_CAP} (exact at any n)"
        if not wide else
        f"induced width {width} > cap {ELIM_WIDTH_CAP}")
    b["streaming"] = _entry(
        n <= STREAMING_MAX_N,
        f"n={n} <= {STREAMING_MAX_N} (exact at any width; "
        "mesh-shardable)" if n <= STREAMING_MAX_N else
        f"n={n} > {STREAMING_MAX_N} (int32 block ids)")
    ais_queries = ("lnz", "marginals", "prob")
    b["ais"] = _entry(
        query in ais_queries,
        "stochastic estimate, no structural cap (diagnosed by ESS/"
        "stderr)" if query in ais_queries else
        f"serves lnz, marginals and prob only, not {query!r}")

    selected = None
    if query in ("lnz", "prob", "map", "marginals"):
        if not wide and not mesh:
            selected = "elimination"
        elif n <= STREAMING_MAX_N:
            selected = "streaming"
        elif query in ais_queries:
            selected = "ais"
    elif query == "mmap":
        M = [v for v in (max_vars or []) if v not in evidence]
        cw = elimination.mmap_width(cl, n, M, evidence)
        fits_elim = cw <= ELIM_WIDTH_CAP
        b["elimination"] = _entry(
            fits_elim,
            f"constrained (sum-first) width {cw} "
            + (f"<= cap {ELIM_WIDTH_CAP}" if fits_elim
               else f"> cap {ELIM_WIDTH_CAP}"))
        swept = n - len(evidence) - len(M)
        stream_ok = swept <= STREAMING_MAX_N and len(M) <= MMAP_ENUM_MAX_VARS
        b["streaming"] = _entry(
            stream_ok,
            f"2^{len(M)} clamped sweeps over {swept} free variables"
            + ("" if stream_ok else
               f" (caps: sweeps 2^{MMAP_ENUM_MAX_VARS}, swept size "
               f"{STREAMING_MAX_N})"))
        selected = ("elimination" if fits_elim
                    else "streaming" if stream_ok else None)
    elif query == "sample":
        # exact route: enumerable table on the reduced model, or a
        # bounded ancestral plan (the CLI evaluates the reduced model;
        # the unreduced bounds here give the conservative answer)
        exact_ok = nf <= EXACT_TABLE_HARD_N or (
            width <= ELIM_WIDTH_CAP
            and elimination.plan_table_floats(cl, n)
            <= SAMPLER_TABLE_FLOATS_CAP)
        b["sampler:exact"] = _entry(
            exact_ok,
            f"2^{nf} free states vs table cap 2^{EXACT_TABLE_HARD_N}; "
            f"ancestral plan needs width <= {ELIM_WIDTH_CAP} and "
            f"<= {SAMPLER_TABLE_FLOATS_CAP:.3g} stored floats")
        b["sampler:gibbs"] = _entry(True, "bit-array chain, any n")
        pam_ok = width <= ELIM_WIDTH_CAP or n <= STREAMING_MAX_N
        b["sampler:pam"] = _entry(
            pam_ok, "Gumbel perturbation + MAP (elimination or streaming)")
        selected = ("sampler:exact" if exact_ok
                    else "sampler:pam" if pam_ok else None)
    b["circuit-shots"] = _entry(
        n <= CIRCUIT_SAMPLER_MAX_N,
        f"int32 state ids cap circuit sampling at n="
        f"{CIRCUIT_SAMPLER_MAX_N}" + ("" if n <= CIRCUIT_SAMPLER_MAX_N
                                      else f"; n={n}"))

    return {"n": n, "num_cliques": len(cl), "induced_width": width,
            "query": query, "evidence_vars": len(evidence),
            "backends": b, "selected": selected}
