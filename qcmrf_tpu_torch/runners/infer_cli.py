"""``python -m qcmrf_tpu_torch infer``: serve inference queries on a model
(port of :mod:`qcmrf_tpu.runners.infer_cli`, same flags and JSON).

Load a model (a ``{'cliques', 'theta'}`` JSON such as the train CLI's
``fitted_model.json``, or ``--graph``) and answer:

    lnz        log-partition (or the evidence's log-mass with --evidence);
               --method ais estimates it by annealed importance sampling
               with an ESS and stderr report, at any structure and size
    prob       P(x_v = b | evidence)         (--of v=b)
    map        evidence-constrained MAP state
    mmap       marginal MAP over --max-vars (the rest summed out)
    marginals  clique-marginal tables E[phi | evidence] (theta layout)
    sample     conditional samples as bit rows (--method exact|gibbs|pam)

Backends route by structure: induced width up to
``capability.ELIM_WIDTH_CAP`` goes through variable elimination (any n);
wider structures go through the streaming sweeps (n <= 47): the
streaming logsumexp, argmax and monomial-moments kernels. ``--method
ais`` (lnz, prob, marginals) has no cap: one launch of the chain kernel's
AIS mode on the evidence-reduced model, seeded by ``--sample-seed``.
``--explain`` prints the capability matrix instead of answering, on the
host only.
Output is one JSON object on stdout (and ``--out``); ``--queries
file.jsonl`` answers a batch of per-query overrides in one process (JSONL
out, ``index`` echoes the line order).

``--platform default`` means the card, as for ``run``: the JAX package's
``default`` serves n <= 26 on the host, the port does not. ``--mesh AxB``
shards the streaming sweeps (and routes every query there, as the JAX
CLI does), the ``pam`` sampler and the AIS chains over A * B devices
(:func:`qcmrf_tpu_torch.parallel.sharded.mesh_from_spec`); a
model that evidence leaves smaller than the mesh answers on one device.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import List, Optional

import numpy as np

from qcmrf_tpu_torch.utils import profiling
from qcmrf_tpu_torch.utils.config import parse_with_config, resolve_platform


def _parse_assignments(spec: str) -> dict:
    """'0=1,5=0' -> {0: 1, 5: 0} (also accepts ';' separators). A
    variable assigned two values is rejected."""
    out = {}
    for part in spec.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        v, _, b = part.partition("=")
        try:
            v, b = int(v), int(b)
        except ValueError:
            raise SystemExit(
                f"bad assignment {part!r}: expected var=bit, e.g. 0=1")
        if v in out and out[v] != b:
            raise SystemExit(
                f"variable {v} assigned twice ({out[v]} and {b})")
        out[v] = b
    return out


def _bits_to_id(bits) -> int:
    """Variable-0-as-MSB state id from a bit row (any width)."""
    x = 0
    for b in bits:
        x = (x << 1) | int(b)
    return x


def _logpot_from_bits(mrf, bits) -> float:
    """beta * theta^T phi(bits) on the host, in float64."""
    total, off = 0.0, 0
    theta = mrf.theta.detach().cpu().double().numpy()
    for C in mrf.cliques:
        c = len(C)
        y = 0
        for s, v in enumerate(C):
            y |= int(bits[int(v)]) << (c - 1 - s)
        total += theta[off + y]
        off += 1 << c
    return float(mrf.beta) * total


def _validate_method(query: str, method: str, where: str = "") -> None:
    """Reject method/query combinations up front (the JAX CLI's rules)."""
    if method == "ais" and query not in ("lnz", "marginals", "prob"):
        raise SystemExit(
            f"{where}--method ais serves --query lnz, marginals and "
            f"prob only (the stochastic no-cap estimator has no "
            f"{query!r} form); drop --method or change --query")
    if method in ("gibbs", "pam") and query != "sample":
        raise SystemExit(
            f"{where}--method {method} applies to --query sample only "
            f"(--query {query} is answered by its exact backend)")


def _floats(t) -> list:
    with profiling.span("qcmrf.wait"):
        t = t.detach().cpu()
    return t.double().numpy().tolist()


def _ais_report(chains: int, args, diag, stderr: bool = False) -> dict:
    """``result["ais"]``: the JAX CLI's keys, ``stderr`` for lnz only."""
    out = {"chains": chains, "temps": args.ais_temps,
           "seed": args.sample_seed, "ess": float(diag["ess"])}
    if stderr:
        out["stderr"] = float(diag["stderr"])
    return out


def _ais_chains(args, mesh) -> tuple:
    """(chains, note): the chain count actually run, rounded up to a
    multiple of the mesh's device count (JAX's rule)."""
    chains = int(args.ais_chains)
    if mesh is None or chains % mesh.size == 0:
        return chains, None
    rounded = -(-chains // mesh.size) * mesh.size
    return rounded, (f"--ais-chains {chains} rounded up to {rounded} "
                     f"(a multiple of the {mesh.size}-device mesh)")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="qcmrf_tpu_torch infer")
    parser.add_argument("--model", type=str, default=None,
                        help="model JSON with {'cliques', 'theta'}: the "
                             "train CLI's fitted_model.json loads directly")
    parser.add_argument("--graph", type=str, default=None,
                        help="alternative to --model: 'chain:N' | "
                             "'grid:RxC' | clique-list JSON (theta "
                             "defaults to zeros unless --theta is given)")
    parser.add_argument("--theta", type=str, default=None,
                        help="theta for --graph: an inline JSON list "
                             "('[-0.5, -0.1, ...]') or the path of a "
                             "JSON file holding one")
    parser.add_argument("--theta-scale", type=float, default=None,
                        help="with --graph and no --theta: draw theta ~ "
                             "-|N(0,1)| * scale (seeded by --theta-seed) "
                             "instead of zeros")
    parser.add_argument("--theta-seed", type=int, default=0)
    parser.add_argument("--beta", type=float, default=None,
                        help="inverse temperature (default: model file's "
                             "value or 1.0)")
    parser.add_argument("--query", type=str, default="lnz",
                        choices=["lnz", "prob", "map", "mmap",
                                 "marginals", "sample"])
    parser.add_argument("--evidence", type=str, default="",
                        help="clamped variables, e.g. '0=1,5=0'")
    parser.add_argument("--of", type=str, default=None,
                        help="the queried assignment for --query prob, "
                             "e.g. '3=1'")
    parser.add_argument("--max-vars", type=str, default=None,
                        help="comma-separated variables maximized over "
                             "for --query mmap (the rest are summed out)")
    parser.add_argument("--num-samples", type=int, default=100)
    parser.add_argument("--method", type=str, default="exact",
                        choices=["exact", "gibbs", "pam", "ais"],
                        help="sampler for --query sample; 'ais' on "
                             "--query lnz/marginals/prob estimates by "
                             "annealed importance sampling (any "
                             "structure and size)")
    parser.add_argument("--ais-chains", type=int, default=256)
    parser.add_argument("--ais-temps", type=int, default=128)
    parser.add_argument("--sample-seed", type=int, default=0)
    parser.add_argument("--mesh", type=str, default=None,
                        help="shard the streaming sweeps over an AxB "
                             "device mesh")
    parser.add_argument("--queries", type=str, default=None,
                        help="JSONL file of per-query overrides (keys: "
                             "query/evidence/of/max_vars/num_samples/"
                             "method/sample_seed) answered in one process")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the result JSON to this path "
                             "(JSONL with --queries)")
    parser.add_argument("--explain", action="store_true",
                        help="print the capability matrix (which backends "
                             "can answer this structure, evidence and "
                             "query, and why) instead of answering; host "
                             "only, never touches a device")
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="'default' means 'gpu'; both raise where "
                             "PyTorch sees no CUDA device")
    return parser


def _load_model(args) -> tuple:
    """``(cliques, theta, beta)`` of ``--model`` or ``--graph``: host-side
    JSON and numpy only, before any device."""
    from qcmrf_tpu_torch.runners.train_cli import parse_graph

    beta = args.beta
    if args.model:
        with open(args.model) as f:
            spec = json.load(f)
        cliques = spec["cliques"]
        theta = np.asarray(spec["theta"], np.float64)
        if beta is None:
            beta = float(spec.get("beta", 1.0))
    elif args.graph:
        cliques = parse_graph(args.graph)
        dim = sum(1 << len(C) for C in cliques)
        if args.theta:
            # inline JSON list or a file path holding one (sniff the '[')
            s = args.theta.strip()
            try:
                if s.startswith("["):
                    theta = np.asarray(json.loads(s), np.float64)
                else:
                    with open(args.theta) as f:
                        theta = np.asarray(json.load(f), np.float64)
            except (OSError, json.JSONDecodeError) as e:
                raise SystemExit(
                    f"--theta {args.theta!r}: not a readable JSON file "
                    f"nor an inline JSON list ({e})")
        elif args.theta_scale is not None:
            rng = np.random.RandomState(args.theta_seed)
            theta = -np.abs(rng.randn(dim)) * float(args.theta_scale)
        else:
            theta = np.zeros((dim,))
        if beta is None:
            beta = 1.0
    else:
        raise SystemExit("pass --model fitted_model.json or --graph ...")
    return cliques, theta, beta


def _batch_specs(args) -> list:
    """The ``--queries`` lines, every one validated before any is
    answered (none without the flag)."""
    _validate_method(args.query, args.method)
    if not args.queries:
        return []
    with open(args.queries) as f:
        batch_specs = [json.loads(line) for line in f if line.strip()]
    allowed = {"query", "evidence", "of", "max_vars", "num_samples",
               "method", "sample_seed"}
    for i, spec in enumerate(batch_specs):
        bad = set(spec) - allowed
        if bad:
            raise SystemExit(
                f"--queries line {i + 1}: unknown keys {sorted(bad)} "
                f"(allowed: {sorted(allowed)})")
        _validate_method(spec.get("query", args.query),
                         spec.get("method", args.method),
                         where=f"--queries line {i + 1}: ")
    return batch_specs


@profiling.spanned("qcmrf.infer")
def main(argv: Optional[List[str]] = None):
    with profiling.span("qcmrf.infer.parse"):
        args = parse_with_config(_parser(), argv)
    with profiling.span("qcmrf.infer.load"):
        cliques, theta, beta = _load_model(args)
    with profiling.span("qcmrf.infer.parse"):
        batch_specs = _batch_specs(args)

    n_vars = 1 + max(v for C in cliques for v in C)

    if args.explain:
        from qcmrf_tpu_torch.models import capability

        mv = None
        if args.max_vars:
            mv = [int(v) for v in
                  args.max_vars.replace(";", ",").split(",") if v.strip()]
        report = capability.explain(
            cliques, n_vars, evidence=_parse_assignments(args.evidence),
            query=args.query, max_vars=mv, mesh=args.mesh is not None,
            method=args.method)
        _emit([report], args.out)
        return report

    with profiling.span("qcmrf.infer.model"):
        device = resolve_platform(args.platform)
        from qcmrf_tpu_torch.models.mrf import MRF
        from qcmrf_tpu_torch.parallel import sharded

        mrf = MRF.create(cliques, theta=theta, beta=beta, device=device)
        mesh = (sharded.mesh_from_spec(args.mesh, device) if args.mesh
                else None)

    if not args.queries:
        result = _answer(mrf, args, mesh, beta)
        _emit([result], args.out)
        return result
    results = []
    for i, spec in enumerate(batch_specs):
        qargs = copy.copy(args)
        for k, v in spec.items():
            # JSON-native forms coerce to the flag formats:
            # evidence {"0": 1} -> "0=1", max_vars [1, 2] -> "1,2"
            if k == "evidence" and isinstance(v, dict):
                v = ",".join(f"{u}={b}" for u, b in v.items())
            elif k in ("max_vars", "of") and isinstance(v, (list, dict)):
                v = (",".join(f"{u}={b}" for u, b in v.items())
                     if isinstance(v, dict)
                     else ",".join(str(u) for u in v))
            setattr(qargs, k, v)
        res = _answer(mrf, qargs, mesh, beta)
        res["index"] = i
        results.append(res)
    _emit(results, args.out)
    return results


@profiling.spanned("qcmrf.infer.emit")
def _emit(results, out) -> None:
    """One JSON line per result on stdout, and into ``out`` when given."""
    lines = [json.dumps(r) for r in results]
    for line in lines:
        print(line)
    if out:
        with open(out, "w") as f:
            f.write("".join(line + "\n" for line in lines))


@profiling.spanned("qcmrf.infer.answer")
def _answer(mrf, args, mesh, beta) -> dict:
    """Answer one query namespace against a loaded model. The caps are
    read from :mod:`capability` at call time."""
    from qcmrf_tpu_torch.models import ais as mais
    from qcmrf_tpu_torch.models import capability, elimination, moments
    from qcmrf_tpu_torch.models import sample as msample

    with profiling.span("qcmrf.infer.route"):
        evidence = _parse_assignments(args.evidence)
        elimination._validate_evidence(mrf.n, evidence)

        # ---- backend routing --------------------------------------------
        cap = capability.ELIM_WIDTH_CAP
        max_n = capability.STREAMING_MAX_N
        width = elimination.induced_width(mrf.cliques, mrf.n)
        use_streaming = width > cap or mesh is not None
        ais_q = args.method == "ais" and args.query in ("lnz", "marginals",
                                                        "prob")
        if (use_streaming and mrf.n > max_n
                and args.query not in ("mmap", "sample") and not ais_q):
            # mmap routes on its own (constrained) width below, a sampler's
            # feasibility is per method on the reduced model, and AIS has no
            # cap
            raise SystemExit(
                f"n={mrf.n} needs the streaming sweep (induced width {width} "
                f"> elimination cap {cap}, or --mesh), which caps at "
                f"n={max_n}")

        result = {"query": args.query, "n": mrf.n,
                  "num_cliques": mrf.num_cliques, "beta": float(beta),
                  "evidence": {str(v): b for v, b in evidence.items()},
                  "backend": "streaming" if use_streaming else "elimination"}

    if args.query == "lnz":
        if ais_q:
            # AIS on the evidence-reduced model: log mass = beta * const +
            # lnZ(reduced); every variable observed leaves the constant
            chains, chains_note = _ais_chains(args, mesh)
            red, const = (moments.reduce_evidence(mrf, evidence)
                          if evidence else (mrf, 0.0))
            if red is not None:
                lnz_red, diag = mais.ais_log_partition(
                    args.sample_seed, red, num_chains=chains,
                    num_temps=args.ais_temps, return_diagnostics=True,
                    mesh=mesh)
            else:
                lnz_red, diag = 0.0, {"ess": float(chains), "stderr": 0.0}
            val = float(beta) * float(const) + float(lnz_red)
            result["backend"] = "ais"
            result["ais"] = _ais_report(chains, args, diag, stderr=True)
            if chains_note:
                result["note"] = chains_note
        elif use_streaming:
            val = moments.log_partition_clamped_streaming(mrf, evidence,
                                                          mesh)
        else:
            val = elimination.log_partition_clamped(mrf, evidence)
        with profiling.span("qcmrf.wait"):
            result["lnz" if not evidence else "log_mass"] = float(val)
    elif args.query == "prob":
        if not args.of:
            raise SystemExit("--query prob needs --of v=b")
        of = _parse_assignments(args.of)
        if len(of) != 1:
            raise SystemExit("--of takes exactly one assignment")
        (v, b), = of.items()
        if ais_q:
            # the final states' weighted indicator on the reduced model
            chains, chains_note = _ais_chains(args, mesh)
            result["backend"] = "ais"
            if v in evidence:
                p = 1.0 if evidence[v] == b else 0.0
                diag = {"ess": float(chains)}
            else:
                red, _ = (moments.reduce_evidence(mrf, evidence)
                          if evidence else (mrf, 0.0))
                if red is None:
                    raise SystemExit("--query prob: all variables are "
                                     "observed but the queried one is "
                                     "not in the evidence — impossible")
                free = [u for u in range(mrf.n)
                        if u not in {int(w) for w in evidence}]
                p, diag = mais.ais_event_prob(
                    args.sample_seed, red, free.index(v), b,
                    num_chains=chains, num_temps=args.ais_temps,
                    return_diagnostics=True, mesh=mesh)
            result["ais"] = _ais_report(chains, args, diag)
            if chains_note:
                result["note"] = chains_note
        elif use_streaming:
            p = moments.conditional_prob_streaming(mrf, v, b, evidence,
                                                   mesh)
        else:
            p = elimination.conditional_prob(mrf, v, b, evidence)
        result["of"] = f"{v}={b}"
        with profiling.span("qcmrf.wait"):
            result["prob"] = float(p)
    elif args.query == "map":
        if use_streaming:
            sid, val = msample.map_state_clamped(mrf, evidence, mesh)
            bits = [(sid >> (mrf.n - 1 - v)) & 1 for v in range(mrf.n)]
        else:
            red, _ = moments.reduce_evidence(mrf, evidence)
            bits = [0] * mrf.n
            for v, b in evidence.items():
                bits[int(v)] = int(b)
            if red is not None:
                free = [v for v in range(mrf.n) if v not in
                        {int(u) for u in evidence}]
                rbits = elimination.map_state_bits(red).cpu().numpy()
                for j, v in enumerate(free):
                    bits[v] = int(rbits[j])
            sid, val = _bits_to_id(bits), _logpot_from_bits(mrf, bits)
        result["state_id"] = sid
        result["state_bits"] = bits
        result["beta_logpot"] = float(val)
    elif args.query == "mmap":
        if not args.max_vars:
            raise SystemExit("--query mmap needs --max-vars v1,v2,...")
        try:
            req = sorted({int(v) for v in
                          args.max_vars.replace(";", ",").split(",")
                          if v.strip()})
        except ValueError:
            raise SystemExit(
                f"bad --max-vars {args.max_vars!r}: expected "
                "comma-separated variable indices")
        # mmap routes on the constrained (sum-first, max-last) width, not
        # the plain induced width: deferring the max variables can blow it
        # up (a star: 2 unconstrained, |leaves| + 1 constrained)
        M = [v for v in req if v not in evidence]
        cw = elimination.mmap_width(mrf.cliques, mrf.n, M, evidence)
        if cw <= cap:
            result["backend"] = "elimination"
            if mesh is not None:
                result["note"] = ("--mesh unused: constrained width "
                                  f"{cw} fits single-pass elimination")
            assignment, val = elimination.marginal_map(mrf, req, evidence)
        else:
            # 2^|M| clamped sweeps, each over n - |ev| - |M| variables
            swept = mrf.n - len(evidence) - len(M)
            if swept > max_n:
                raise SystemExit(
                    f"mmap constrained elimination width {cw} > cap "
                    f"{cap} and each clamped sweep covers {swept} free "
                    f"variables > streaming cap {max_n}: no exact "
                    "backend; reduce --max-vars or add evidence")
            enum_cap = capability.MMAP_ENUM_MAX_VARS
            if len(M) > enum_cap:
                raise SystemExit(
                    f"mmap constrained elimination width {cw} > cap "
                    f"{cap}, and streaming mmap enumerates 2^{len(M)} "
                    f"clamped sweeps (cap 2^{enum_cap}) — reduce "
                    "--max-vars")
            result["backend"] = "streaming"
            assignment, val = moments.marginal_map_streaming(mrf, req,
                                                             evidence, mesh)
        result["max_vars"] = {str(v): b for v, b in assignment.items()}
        result["log_mass"] = float(val)
    elif args.query == "marginals":
        if ais_q:
            # the weighted scatter of the final states, re-embedded through
            # the evidence reduction as on the exact routes
            chains, chains_note = _ais_chains(args, mesh)
            red, _ = (moments.reduce_evidence(mrf, evidence)
                      if evidence else (mrf, 0.0))
            if red is not None:
                rmom, diag = mais.ais_clique_marginals(
                    args.sample_seed, red, num_chains=chains,
                    num_temps=args.ais_temps, return_diagnostics=True,
                    mesh=mesh)
            else:
                rmom, diag = np.zeros((0,)), {"ess": float(chains)}
            mu = (moments.embed_clamped_marginals(mrf, evidence, rmom)
                  if evidence else rmom)
            result["backend"] = "ais"
            result["ais"] = _ais_report(chains, args, diag)
            if chains_note:
                result["note"] = chains_note
        elif use_streaming:
            mu = moments.clique_marginals_clamped_streaming(mrf, evidence,
                                                            mesh)
        elif evidence:
            # clamp exactly, then bounded-width marginals on the reduced
            # model, re-embedded the same way
            red, _ = moments.reduce_evidence(mrf, evidence)
            rmom = (elimination.clique_marginals(red) if red is not None
                    else np.zeros((0,)))
            mu = moments.embed_clamped_marginals(mrf, evidence, rmom)
        else:
            mu = elimination.clique_marginals(mrf)
        result["marginals"] = _floats(mu)
    elif args.query == "sample":
        method, note = capability.sample_method(mrf.cliques, mrf.n,
                                                evidence, args.method)
        notes = [note] if note else []
        if mesh is not None and method != "pam":
            notes.append(f"--mesh shards the 'pam' sampler only; "
                         f"'{method}' runs single-device")
        try:
            bits = msample.sample_conditional(
                args.sample_seed, mrf, args.num_samples, evidence,
                method=method, mesh=mesh if method == "pam" else None)
        except ValueError as e:
            # a sampler with no feasible backend explains its limits
            raise SystemExit(str(e))
        result["method"] = method
        if notes:
            result["note"] = "; ".join(notes)
        result["samples"] = bits.cpu().numpy().astype(np.int32).tolist()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
