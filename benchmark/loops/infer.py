"""Inference queries served by the program's ``infer`` CLI: one client,
closed loop, each query sent when the last is answered.

Set-up draws theta from the configuration's law, writes the model JSON
once into a directory under ``TMPDIR``, and warms up with one query of
every kind at every evidence size. The window's queries come in blocks
that each hold every one of ``kinds`` with every one of
``evidence_sizes`` once, in an order drawn from the seed, with evidence
variables, values and a ``prob`` query's variable drawn from it too; so
every seed sends the same mix. The client calls
``runners.infer_cli.main(argv)`` in-process for each (its standard output
captured). A query's latency runs from the call to its answer in host
memory.

Correct: for a seeded sample of the answered queries of each kind, the
answer against the reference's on the same model and evidence: ln Z or the
evidence's log-mass, P(x_v = b | evidence), the clique marginals, and the
MAP state's log-potential (the reference's best less that of the
program's state, which also has to agree with the evidence, and the
program's value of it against the reference's).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import tempfile
import time

import torch

from benchmark import harness, inputs


def draw_queries(n: int, kinds, sizes, rng):
    """Queries without end, (kind, evidence {v: b}, of (v, b) or None),
    in blocks of every kind with every evidence size once."""
    plan = [(kind, size) for size in sizes for kind in kinds]
    while True:
        for j in rng.permutation(len(plan)):
            kind, size = plan[j]
            chosen = rng.choice(n, size=size, replace=False)
            evidence = {int(v): int(rng.integers(0, 2)) for v in chosen}
            of = None
            if kind == "prob":
                free = [v for v in range(n) if v not in evidence]
                of = (int(rng.choice(free)), int(rng.integers(0, 2)))
            yield kind, evidence, of


class Loop:
    def __init__(self, config, mix, seed, device, spans):
        from qcmrf_tpu_torch.runners import infer_cli

        self.config, self.mix, self.device, self.spans = (
            config, mix, device, spans)
        self.ref = harness.load_module("reference", config["reference"])
        self.cliques = inputs.cliques(config)
        self.n = int(config["n"])
        self.beta = float(config.get("beta", 1.0))
        self.theta = inputs.neg_half_normal(
            inputs.dimension(self.cliques), config["theta_scales"][0],
            inputs.generator(seed, "theta", device), device)
        self.tmp = tempfile.mkdtemp(prefix="bench-infer-")
        self.model_path = os.path.join(self.tmp, "model.json")
        with open(self.model_path, "w") as f:
            json.dump({"cliques": [list(C) for C in self.cliques],
                       "theta": self.theta.double().tolist(),
                       "beta": self.beta}, f)
        self.platform = "cpu" if device.type == "cpu" else "gpu"
        kinds, sizes = mix["kinds"], mix["evidence_sizes"]
        stream = draw_queries(self.n, kinds, sizes,
                              inputs.rng(seed, "warm"))
        self.warm = [next(stream) for _ in range(len(kinds) * len(sizes))]
        self.queries = draw_queries(self.n, kinds, sizes,
                                    inputs.rng(seed, "order"))
        self.latencies = []

        def system(argv):
            with contextlib.redirect_stdout(io.StringIO()):
                return infer_cli.main(argv)

        #: the program under test: CLI arguments -> the answer's dict
        self.system = system
        self.kept = {}
        self.keepers = {k: harness.reservoir(int(mix["checked_per_kind"]),
                                             inputs.rng(seed, "sample"))
                        for k in mix["kinds"]}

    def argv(self, query) -> list:
        kind, evidence, of = query
        args = ["--model", self.model_path, "--query", kind, "--method",
                self.mix["method"], "--platform", self.platform]
        if evidence:
            args += ["--evidence",
                     ",".join(f"{v}={b}" for v, b in evidence.items())]
        if of is not None:
            args += ["--of", f"{of[0]}={of[1]}"]
        return args

    def _call(self, query):
        with self.spans("bench.query"):
            return self.system(self.argv(query))

    def warm_up(self):
        for q in self.warm:
            self._call(q)

    def _timed(self, i):
        query = next(self.queries)
        t0 = time.perf_counter()
        answer = self._call(query)
        self.latencies.append(time.perf_counter() - t0)
        return query, answer

    def window(self, seconds):
        seen = {k: 0 for k in self.mix["kinds"]}
        done_queries = []

        def done(j, out):
            query, answer = out
            kind = query[0]
            done_queries.append(query)
            slot = self.keepers[kind](seen[kind])
            seen[kind] += 1
            if slot is not None:
                self.kept[(kind, slot)] = (query, answer)

        window = harness.closed_loop(
            seconds, self._timed, done,
            work={"queries": done_queries, "cliques": self.cliques,
                  "n": self.n})
        window.latencies_s = self.latencies
        return window

    def release(self):
        self.system = None
        shutil.rmtree(self.tmp, ignore_errors=True)

    def checks(self):
        model = self.ref.PairwiseMRF(self.cliques, self.theta.double(),
                                     self.n, self.beta)
        table = model.table()
        gaps = {"lnz_gap": 0.0, "prob_gap": 0.0, "marg_gap": 0.0,
                "map_gap": 0.0}
        for (kind, _), (query, answer) in sorted(self.kept.items()):
            _, evidence, of = query
            if kind == "lnz":
                _, sub = model.condition(table, evidence)
                got = answer["log_mass" if evidence else "lnz"]
                gap = abs(got - float(sub.logsumexp(0)))
            elif kind == "prob":
                _, sub = model.condition(table, evidence)
                _, hit = model.condition(table, {**evidence, of[0]: of[1]})
                want = math.exp(float(hit.logsumexp(0) - sub.logsumexp(0)))
                gap = abs(answer["prob"] - want)
            elif kind == "marginals":
                want = model.conditional_marginals(table, evidence)
                got = want.new_tensor(answer["marginals"])
                gap = float((got - want).abs().max())
            else:
                _, best = model.map_state(table, evidence)
                sid = int(answer["state_id"])
                agrees = all((sid >> (self.n - 1 - v)) & 1 == b
                             for v, b in evidence.items())
                at = float(table[sid])
                gap = (max(best - at, abs(answer["beta_logpot"] - at))
                       if agrees else math.inf)
            name = {"lnz": "lnz_gap", "prob": "prob_gap",
                    "marginals": "marg_gap", "map": "map_gap"}[kind]
            gaps[name] = max(gaps[name], gap)
        lim = self.mix["limits"]
        return [harness.Check(k, v, lim[k]) for k, v in gaps.items()]


def parse_query(argv):
    """(kind, evidence, of) back from the CLI arguments the loop built."""
    args = dict(zip(argv[::2], argv[1::2]))

    def pairs(spec):
        return {int(v): int(b) for v, b in
                (p.split("=") for p in spec.split(",") if p)}

    evidence = pairs(args.get("--evidence", ""))
    of = next(iter(pairs(args["--of"]).items())) if "--of" in args else None
    return args["--query"], evidence, of


def control(loop):
    """Answers from the reference's table in the control's precision, in
    the CLI's keys, in the program's place."""
    from benchmark.control import CONTROL_DTYPE

    model = loop.ref.PairwiseMRF(loop.cliques, loop.theta, loop.n,
                                 loop.beta, CONTROL_DTYPE)
    table = model.table()

    def system(argv):
        kind, evidence, of = parse_query(argv)
        _, sub = model.condition(table, evidence)
        lnz = sub.float().logsumexp(0).to(CONTROL_DTYPE)
        if kind == "lnz":
            return {"lnz" if not evidence else "log_mass": float(lnz)}
        if kind == "prob":
            _, hit = model.condition(table, {**evidence, of[0]: of[1]})
            hit = hit.float().logsumexp(0).to(CONTROL_DTYPE)
            return {"prob": float(torch.exp(hit - lnz))}
        if kind == "marginals":
            mu = model.conditional_marginals(table, evidence)
            return {"marginals": mu.float().tolist()}
        sid, value = model.map_state(table, evidence)
        return {"state_id": sid, "beta_logpot": value}

    return system


def altered(loop):
    """A query's value or MAP state altered where it is produced."""
    inner = loop.system

    def system(argv):
        out = dict(inner(argv))
        for key in ("lnz", "log_mass", "prob"):
            if key in out:
                out[key] += 1e-3
        if "marginals" in out:
            out["marginals"] = [out["marginals"][0] + 1e-3] + \
                out["marginals"][1:]
        if "state_id" in out:
            out["state_id"] ^= 1
        return out

    return system


#: the timed path broken underneath, each way this loop's cells can break
FAULTS = {"altered": altered}
