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
unchanged). Each loop module ``loops/<loop>.py`` brings both: its
``control(loop)`` returns the control's system (or ``None`` where the
control sets the loop's readings itself), and its ``FAULTS`` maps each
fault its cells can have to a function of the loop that returns the
broken system. Each seed prints one JSON line. The benchmark's own runs
never run this; the tests under ``benchmark/tests`` run it at small sizes
on the CPU.
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
#: the control's precision, which every loop's ``control`` computes in
CONTROL_DTYPE = torch.bfloat16


def read(spec, workload: str, seed: int, seconds: float, side: str,
         device, config: dict = None, mix: dict = None) -> dict:
    """One seed's compared numbers on ``side``."""
    from benchmark import harness
    from benchmark.trace import Spans

    _, cfg, mx = harness.cell_inputs(spec, workload)
    cfg = config if config is not None else cfg
    mx = mix if mix is not None else mx
    module = harness.load_module("loops", mx["loop"])
    loop = module.Loop(cfg, mx, seed, torch.device(device), Spans(False))
    if side == "control":
        loop.system = module.control(loop)
    elif side != "program":
        loop.system = module.FAULTS[side](loop)
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
