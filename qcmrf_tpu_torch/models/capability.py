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
* ``PAM_ELIM_WIDTH``: perturb-and-MAP by max-product elimination keeps a
  ``2^width`` traceback table a sample; wider structures take the
  streaming argmax sweep.

Departures from the JAX package, all for ``query="sample"``, where its
``selected`` disagrees with what the infer CLI runs: ``selected`` follows
the CLI's routing (:func:`sample_method`) on the evidence-reduced
structure, for the ``method`` asked (the JAX package judges the unreduced
structure and ignores ``--method``), and it is ``None`` where no sampler
is feasible (the JAX package selects ``sampler:pam`` there). The
samplers' feasibility entries are judged on the reduced structure too.
Likewise for ``method="ais"`` on lnz, prob and marginals: ``selected`` is
``ais``, the backend the CLI runs whatever the structure (the JAX package
ignores the method and names the exact backend).
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

#: widest structure whose PAM samples come from max-product elimination.
PAM_ELIM_WIDTH = 16


def big_n_threshold() -> int:
    """n above which the train CLI's data travels as bit arrays (int32
    state ids end); ``QCMRF_BIG_N_THRESHOLD`` lets tests drive that path
    at tiny widths. Read at call time."""
    return int(os.environ.get("QCMRF_BIG_N_THRESHOLD", "30"))


def _entry(ok: bool, reason: str) -> Dict:
    return {"feasible": bool(ok), "reason": reason}


def reduce_structure(cliques: Sequence[Sequence[int]], n: int,
                     evidence: dict):
    """The structure of the evidence-reduced model, host only: ``(scopes,
    reduced)``. ``scopes[k]`` is clique k's unobserved variables in its own
    order, relabelled onto the free variables taken in ascending order
    (``free[i]`` becomes ``i``); it is empty where the evidence observes
    the whole clique. ``reduced`` is the reduced model's ``(cliques, n)``:
    the non-empty scopes, or ``((0,),)`` (a zero-potential clique) when
    free variables remain in no clique; ``None`` when every variable is
    observed. ``moments.reduce_evidence`` gives its model this structure."""
    ev = {int(v) for v in evidence}
    rank, nf = [-1] * n, 0  # -1: observed
    for v in range(n):
        if v not in ev:
            rank[v], nf = nf, nf + 1
    scopes = [tuple([rank[v] for v in C if rank[v] >= 0]) for C in cliques]
    if not nf:
        return scopes, None
    return scopes, (tuple(C for C in scopes if C) or ((0,),), nf)


def _sampler_sizes(cliques, n: int, evidence: dict):
    """(free variables, induced width, stored-factor floats) of the
    reduced structure; zeros when every variable is observed."""
    from qcmrf_tpu_torch.models import elimination

    _, red = reduce_structure(cliques, n, evidence)
    if red is None:
        return 0, 0, 0
    rc, rn = red
    return (rn, elimination.induced_width(rc, rn),
            elimination.plan_table_floats(rc, rn))


def sample_method(cliques: Sequence[Sequence[int]], n: int, evidence: dict,
                  method: str = "exact"):
    """``(method, note)``: the sampler ``infer --query sample`` runs for
    ``method``. ``exact`` past the table cap (``EXACT_TABLE_HARD_N`` free
    variables) stays exact where the reduced structure has a bounded
    ancestral plan (``ELIM_WIDTH_CAP``, ``SAMPLER_TABLE_FLOATS_CAP``), else
    it goes to ``pam`` and ``note`` says why (else ``None``). Host only;
    the caps are read at call time."""
    nf = n - len(evidence)
    if method != "exact" or nf <= EXACT_TABLE_HARD_N:
        return method, None
    rn, width, floats = _sampler_sizes(cliques, n, evidence)
    if width <= ELIM_WIDTH_CAP and floats <= SAMPLER_TABLE_FLOATS_CAP:
        return method, None
    return "pam", (
        f"method 'exact' needs an enumerable table (2^{nf} free states > "
        f"cap 2^{EXACT_TABLE_HARD_N}) or a bounded reduced elimination "
        f"plan (width cap {ELIM_WIDTH_CAP}, stored-factor cap "
        f"{SAMPLER_TABLE_FLOATS_CAP:.3g} floats); routed to 'pam'")


def explain(cliques: Sequence[Sequence[int]], n: int,
            evidence: Optional[dict] = None,
            query: str = "lnz",
            max_vars: Optional[Sequence[int]] = None,
            mesh: bool = False, method: str = "exact") -> Dict:
    """Feasibility of every backend for one (structure, query) — the
    printable capability matrix behind ``infer --explain``.

    Returns ``{"n", "induced_width", "query", "backends": {name:
    {"feasible", "reason"}}, "selected": name_or_None}`` where
    ``selected`` is the backend the infer CLI's routing would use (for
    ``query="sample"``, with sampler ``method``). Host-side analysis only — never initializes a device backend, so
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
    if method == "ais" and query in ais_queries:
        selected = "ais"
    elif query in ("lnz", "prob", "map", "marginals"):
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
        # every sampler runs on the evidence-reduced model: an enumerable
        # table or a bounded ancestral plan for exact; for PAM the
        # streaming sweep's n cap or elimination's PAM width
        rn, rwidth, rfloats = _sampler_sizes(cl, n, evidence)
        exact_ok = nf <= EXACT_TABLE_HARD_N or (
            rwidth <= ELIM_WIDTH_CAP and rfloats <= SAMPLER_TABLE_FLOATS_CAP)
        b["sampler:exact"] = _entry(
            exact_ok,
            f"2^{nf} free states vs table cap 2^{EXACT_TABLE_HARD_N}; "
            f"ancestral plan needs width <= {ELIM_WIDTH_CAP} and "
            f"<= {SAMPLER_TABLE_FLOATS_CAP:.3g} stored floats")
        b["sampler:gibbs"] = _entry(True, "bit-array chain, any n")
        pam_ok = rn <= STREAMING_MAX_N or rwidth <= PAM_ELIM_WIDTH
        b["sampler:pam"] = _entry(
            pam_ok, "Gumbel perturbation + MAP (elimination or streaming)")
        run, _ = sample_method(cl, n, evidence, method)
        selected = (None if run not in ("exact", "gibbs", "pam")
                    or not b[f"sampler:{run}"]["feasible"]
                    else f"sampler:{run}")
    b["circuit-shots"] = _entry(
        n <= CIRCUIT_SAMPLER_MAX_N,
        f"int32 state ids cap circuit sampling at n="
        f"{CIRCUIT_SAMPLER_MAX_N}" + ("" if n <= CIRCUIT_SAMPLER_MAX_N
                                      else f"; n={n}"))

    return {"n": n, "num_cliques": len(cl), "induced_width": width,
            "query": query, "evidence_vars": len(evidence),
            "backends": b, "selected": selected}
