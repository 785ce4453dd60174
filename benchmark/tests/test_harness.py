"""The harness end to end at small sizes on the CPU (the look for a card
skipped), the result's form, and the form of ``BENCHMARK.json``."""

import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness, inputs

ROOT = Path(harness.ROOT)
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def run_small(small, workload, trace=False, seconds=0.5):
    cfg, mix = small(workload)
    return harness.run_cell(SPEC, workload, 20260917 + (1 << 33), seconds,
                            trace, "cpu", time.perf_counter(), config=cfg,
                            mix=mix)


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_is_correct_at_small_size(small, workload):
    out = run_small(small, workload)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    names = {m["name"] for m in harness.cell_metrics(
        SPEC, next(w for w in SPEC["workloads"]
                   if w["name"] == workload), False)}
    assert set(out["metrics"]) == names
    assert "setup_s" in names and len(names) >= 2
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_window(small, workload):
    out = run_small(small, workload, trace=True)
    assert out["correct"] is True
    dev = out["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] == 0.0   # no device here
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    cell = next(w for w in SPEC["workloads"] if w["name"] == workload)
    allowed = {m["name"] for m in harness.cell_metrics(SPEC, cell, True)}
    assert set(out["metrics"]) <= allowed


def test_emit_puts_checks_last_on_stderr_and_the_result_last_on_stdout():
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {"a": {"value": 1.0, "limit": 2.0}}}
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    assert json.loads(out.getvalue().splitlines()[-1]) == result
    assert err.getvalue().splitlines()[-1] == "check a 1.0 limit 2.0 ok"


def test_run_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "chain15.shots", "--seed", str(3 << 31),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_fails_in_a_tree_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "k27.infer", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_cell_loads_jax_or_the_jax_package(small):
    # a fresh interpreter runs every cell at its small size, then lists
    # the top-level names of every module it loaded
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
        "from benchmark import harness\n"
        "from conftest import small_inputs\n"
        "spec = harness.load_spec()\n"
        "for w in (c['name'] for c in spec['workloads']):\n"
        "    cfg, mix = small_inputs(spec, w)\n"
        "    for trace in (False, True):\n"
        "        r = harness.run_cell(spec, w, 7, 0.3, trace, 'cpu',\n"
        "            time.perf_counter(), cfg, mix)\n"
        "        assert r['correct'], (w, r['checks'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "qcmrf_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN_MODULES), top


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_its_form():
    spec = SPEC
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir()
    assert all(one_line(w) for w in spec["command"])
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"])
        assert one_line(c["source"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        assert (ROOT / "benchmark" / "reference"
                / f"{data['reference']}.py").is_file()
    cells = spec["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and one_line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        mix = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "loops"
                / f"{mix['loop']}.py").is_file()
    assert {w["config"] for w in cells} == set(configs)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"] != "setup_s":
            harness.load_module("metrics", m["name"]).read
    for w in cells:
        reported = harness.cell_metrics(spec, w, False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.cell_metrics(spec, w, True)


def test_closed_loop_counts_units_and_failures():
    seen = []

    def call(i):
        if i == 2:
            raise RuntimeError("a failed call")
        time.sleep(0.01)
        return i

    w = harness.closed_loop(0.1, call, lambda j, out: seen.append((j, out)),
                            per_call=5, work={"a": 1})
    calls = w.attempted // 5
    assert w.failed == 5 and w.units == 5 * (calls - 1)
    assert seen == [(j, i) for j, i in enumerate(
        i for i in range(calls) if i != 2)]
    assert w.elapsed_s >= 0.1 and w.work == {"a": 1}


def test_every_seed_sends_the_same_query_mix():
    infer = harness.load_module("loops", "infer")
    kinds, sizes = ["lnz", "prob", "marginals", "map"], [0, 1, 2, 3, 4]
    block = len(kinds) * len(sizes)
    mixes = []
    for seed in (1, 2 << 40):
        stream = infer.draw_queries(27, kinds, sizes,
                                    inputs.rng(seed, "order"))
        queries = [next(stream) for _ in range(3 * block)]
        mixes.append(sorted((k, len(e)) for k, e, _ in queries))
        for k, e, of in queries:
            assert all(0 <= v < 27 for v in e)
            assert (of is not None) == (k == "prob")
            assert of is None or of[0] not in e
    assert mixes[0] == mixes[1] == sorted(
        [(k, s) for k in kinds for s in sizes] * 3)
