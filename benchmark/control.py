"""The comparison's readings: the program's, the control's and the
faults', at a cell's own size and load, several seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \
        --seconds 3 [--side program|control|<fault>]

``program`` runs the cell as the benchmark does (a short window) and
prints each seed's compared numbers: the lower readings. ``control`` puts
the plain reference, computed in bfloat16, in the program's place: the
nearest precision below the float32 the configurations state, whose
numbers have to fail a limit. A fault breaks the timed path underneath the
harness (the program's output with half of the batch left out, an answer
altered where it is produced, a training step that leaves its state
unchanged); a cell's faults are those its loop can have. Each seed
prints one JSON line. The benchmark's own runs never run this; the tests
under ``benchmark/tests`` run it at small sizes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CONTROL_DTYPE = torch.bfloat16


# ---- controls: the reference in bfloat16 in the program's place ------------


def shots_control(loop):
    """Draw x uniformly and keep it with the reference's acceptance
    probability prod_k exp(beta theta_k) evaluated in bfloat16."""
    ref = loop.ref
    gen = torch.Generator(device=loop.device).manual_seed(20260)

    def system(key, stream, theta):
        model = ref.PairwiseMRF(loop.cliques, theta, loop.n,
                                loop.beta, CONTROL_DTYPE)
        keep = torch.exp(model.table()).float()
        x = torch.randint(0, 1 << loop.n, (loop.shots,), generator=gen,
                          device=loop.device, dtype=torch.int32)
        u = torch.rand(loop.shots, generator=gen, device=loop.device)
        return x, (u >= keep[x.long()]).to(torch.int32)

    return system


def circuit_control(loop):
    """The reference's post-selected law in bfloat16."""
    ref = loop.ref

    def system(theta):
        model = ref.PairwiseMRF(loop.cliques, theta, loop.n,
                                loop.beta, CONTROL_DTYPE)
        return model.postselected(model.table())[0].float()

    return system


def parse_query(argv):
    """(kind, evidence, of) back from the CLI arguments the loop built."""
    args = dict(zip(argv[::2], argv[1::2]))

    def pairs(spec):
        return {int(v): int(b) for v, b in
                (p.split("=") for p in spec.split(",") if p)}

    evidence = pairs(args.get("--evidence", ""))
    of = next(iter(pairs(args["--of"]).items())) if "--of" in args else None
    return args["--query"], evidence, of


def infer_control(loop):
    """Answers from the reference's table in bfloat16, in the CLI's keys."""
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


def train_control(loop):
    """Read the reference's own first steps in bfloat16 in place of the
    program's, and its loss in bfloat16 where they end in place of the
    window's last: returns ``None`` (no system to time)."""
    k = int(loop.mix["reference_steps"])
    ref = loop.ref.train_reference(
        loop.cliques, loop.n, loop.beta, loop.theta0, loop.data,
        k, loop.lr, dtype=CONTROL_DTYPE)
    loop.losses = ref["losses"]
    loop.grad1 = ref["grad1"].float()
    loop.raw0 = ref["raw0"].float()
    loop.raw_k = ref["raw"].float()
    loop.last = (ref["raw"], loop.ref.nll(loop.cliques, loop.n, loop.beta,
                                          ref["raw"], loop.data,
                                          CONTROL_DTYPE))
    return None


CONTROLS = {"shots": shots_control, "circuit": circuit_control,
            "infer": infer_control, "train": train_control}


# ---- faults: the timed path broken underneath ------------------------------


def half_batch(loop):
    """Half of the outcomes left out (shots), half of the data rows
    (training)."""
    inner = loop.system
    if loop.mix["loop"] == "train":
        return lambda batch: inner(batch[:batch.shape[0] // 2])
    return lambda key, stream, theta: tuple(
        t[:t.shape[0] // 2] for t in inner(key, stream, theta))


def altered(loop):
    """One answer altered where it is produced: the state of an accepted
    shot (the first 1/16 of them set to 0, the accepted count kept), a
    probability, a query's value or MAP state."""
    inner, kind = loop.system, loop.mix["loop"]
    if kind == "shots":
        def system(key, stream, theta):
            x, a = inner(key, stream, theta)
            hit = torch.nonzero(a == 0).flatten()
            x = x.clone()
            x[hit[: hit.numel() // 16]] = 0
            return x, a
    elif kind == "circuit":
        def system(theta):
            probs = inner(theta).clone()
            probs[0] *= 1.001
            return probs
    elif kind == "infer":
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
    else:
        def system(batch):
            return inner(batch) * 1.001
    return system


def unchanged(loop):
    """A training step that returns its loss and leaves the parameters as
    they were."""
    step, raw = loop.system, loop.raw

    def system(batch):
        before = raw.detach().clone()
        loss = step(batch)
        with torch.no_grad():
            raw.copy_(before)
        return loss

    return system


#: the faults each loop's cell can have
FAULTS = {"shots": {"half_batch": half_batch, "altered": altered},
          "circuit": {"altered": altered},
          "infer": {"altered": altered},
          "train": {"half_batch": half_batch, "altered": altered,
                    "unchanged": unchanged}}


def read(spec, workload: str, seed: int, seconds: float, side: str,
         device, config: dict = None, mix: dict = None) -> dict:
    """One seed's compared numbers on ``side``."""
    from benchmark import harness
    from benchmark.trace import Spans

    _, cfg, mx = harness.cell_inputs(spec, workload)
    cfg = config if config is not None else cfg
    mx = mix if mix is not None else mx
    loop = harness.load_module("loops", mx["loop"]).Loop(
        cfg, mx, seed, torch.device(device), Spans(False))
    if side == "control":
        loop.system = CONTROLS[mx["loop"]](loop)
    elif side != "program":
        loop.system = FAULTS[mx["loop"]][side](loop)
    window = None
    if loop.system is not None:
        loop.warm_up()
        window = loop.window(seconds)
    loop.release()
    checks = loop.checks()
    return {"workload": workload, "seed": seed, "side": side,
            "units": None if window is None else window.units,
            "failed": None if window is None else window.failed,
            "checks": {c.name: c.value for c in checks},
            "over_limit": [c.name for c in checks if not c.ok]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--side", default="program")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.load_spec(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = read(spec, args.workload, seed, args.seconds, args.side,
                   "cuda:0")
        out["seconds"] = round(time.perf_counter() - t0, 1)
        out["checks"] = {k: (v if math.isfinite(v) else str(v))
                         for k, v in out["checks"].items()}
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
