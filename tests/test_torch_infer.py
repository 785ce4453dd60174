"""Port parity of ``infer``: the port's CLI answers every query with the
JSON of the JAX package's CLI, on the CPU, on both routes (variable
elimination, and the streaming sweeps forced by a width cap of 1 in both
packages). Keys, routes, state ids, bits and assignments are equal;
floats agree within 1e-5."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.models import train as jtrain  # noqa: E402
from qcmrf_tpu.runners import infer_cli as jinfer  # noqa: E402

from qcmrf_tpu_torch import __main__ as cli  # noqa: E402
from qcmrf_tpu_torch.models import capability  # noqa: E402
from qcmrf_tpu_torch.runners import infer_cli  # noqa: E402
from qcmrf_tpu_torch.runners.train_cli import parse_graph  # noqa: E402

TOL = 1e-5

QUERIES = (
    {"query": "lnz"},
    {"query": "lnz", "evidence": "0=1,5=0"},
    {"query": "prob", "of": "3=1"},
    {"query": "prob", "of": "3=1", "evidence": "0=1"},
    {"query": "prob", "of": "0=0", "evidence": "0=1"},
    {"query": "map"},
    {"query": "map", "evidence": {"0": 1, "5": 0}},
    {"query": "mmap", "max_vars": [0, 1, 2]},
    {"query": "mmap", "max_vars": "1,4", "evidence": "1=1"},
    {"query": "marginals"},
    {"query": "marginals", "evidence": "0=1,2=0"},
)


def assert_same(got, want, where=""):
    """Equal JSON, floats within TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.fixture
def k10(tmp_path):
    """K10 with a theta file: the JAX streaming route runs its kernels."""
    cl = [[i, j] for i in range(10) for j in range(i + 1, 10)]
    graph = tmp_path / "k10.json"
    graph.write_text(json.dumps(cl))
    return ["--graph", str(graph), "--theta-scale", "0.5", "--theta-seed",
            "4", "--beta", "1.3"]


@pytest.fixture
def model_file(tmp_path):
    rng = np.random.RandomState(2)
    cl = [[0, 1, 2], [2, 3], [3, 4, 5, 6], [6, 7], [7, 0], [1, 5]]
    d = sum(1 << len(C) for C in cl)
    path = tmp_path / "fitted_model.json"
    path.write_text(json.dumps({"cliques": cl, "beta": 0.8,
                                "theta": (-np.abs(rng.randn(d))).tolist()}))
    return ["--model", str(path)]


def batch(tmp_path, queries=QUERIES):
    path = tmp_path / "queries.jsonl"
    path.write_text("\n".join(json.dumps(q) for q in queries) + "\n")
    return ["--queries", str(path)]


@pytest.mark.parametrize("route", ["elimination", "streaming"])
@pytest.mark.parametrize("spec", ["k10", "model_file", "grid"])
def test_batch_json_equals_jax(spec, route, request, tmp_path, monkeypatch,
                               capsys):
    base = (["--graph", "grid:3x3", "--theta-scale", "0.7"]
            if spec == "grid" else request.getfixturevalue(spec))
    if route == "streaming":
        monkeypatch.setattr(jtrain, "_ELIM_WIDTH_CAP", 1)
        monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    argv = base + batch(tmp_path) + ["--platform", "cpu"]
    got = infer_cli.main(argv + ["--out", str(tmp_path / "port.jsonl")])
    want = jinfer.main(argv)
    assert len(got) == len(want) == len(QUERIES)
    assert [r["backend"] for r in got] == [r["backend"] for r in want]
    assert {r["backend"] for r in got} == {route}
    assert_same(got, want)
    lines = (tmp_path / "port.jsonl").read_text().splitlines()
    assert [json.loads(s) for s in lines] == got
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert printed[:len(got)] == got


@pytest.mark.parametrize("route", ["elimination", "streaming"])
def test_single_queries_equal_jax(route, k10, tmp_path, monkeypatch):
    if route == "streaming":
        monkeypatch.setattr(jtrain, "_ELIM_WIDTH_CAP", 1)
        monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    for argv in (["--query", "lnz"],
                 ["--query", "prob", "--of", "7=0", "--evidence", "2=1;4=0"],
                 ["--query", "map", "--evidence", "9=1"],
                 ["--query", "mmap", "--max-vars", "3,8"],
                 ["--query", "marginals", "--evidence", "6=1"]):
        out = tmp_path / "r.json"
        got = infer_cli.main(k10 + argv + ["--platform", "cpu", "--out",
                                           str(out)])
        assert_same(got, jinfer.main(k10 + argv + ["--platform", "cpu"]),
                    str(argv))
        assert json.loads(out.read_text()) == got


def test_explain_equals_jax(k10, tmp_path):
    for argv in (["--query", "lnz"], ["--query", "map", "--evidence", "0=1"],
                 ["--query", "mmap", "--max-vars", "0,1,2"],
                 ["--query", "sample"], ["--query", "marginals", "--mesh",
                                         "2x1"]):
        out = tmp_path / "e.json"
        got = infer_cli.main(k10 + argv + ["--explain", "--out", str(out)])
        assert got == jinfer.main(k10 + argv + ["--explain"])
        assert json.loads(out.read_text()) == got


def test_cli_dispatch(k10, capsys):
    assert cli.main(["infer"] + k10 + ["--query", "map", "--platform",
                                       "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["state_bits"] == jinfer.main(
        k10 + ["--query", "map", "--platform", "cpu"])["state_bits"]


def test_unported_options_name_their_slices(k10, tmp_path):
    """``--mesh`` (slice 6a) answers as without it; a mesh that is not
    AxB or not a power of two is refused."""
    lnz, mp = (infer_cli.main(k10 + argv + ["--mesh", "2x1", "--platform",
                                            "cpu"])
               for argv in (["--query", "lnz"], ["--query", "map"]))
    assert lnz["backend"] == mp["backend"] == "streaming"
    assert lnz["lnz"] == pytest.approx(infer_cli.main(
        k10 + ["--platform", "cpu"])["lnz"], rel=1e-6)
    assert mp["state_bits"] == infer_cli.main(
        k10 + ["--query", "map", "--platform", "cpu"])["state_bits"]
    with pytest.raises(ValueError, match="power-of-two mesh"):
        infer_cli.main(k10 + ["--mesh", "3x1", "--platform", "cpu"])
    cases = ((["--query", "lnz", "--mesh", "2"], "expected AxB"),
             (batch(tmp_path, [{"query": "lnz"},
                               {"query": "map", "method": "ais"}]),
              "line 2: --method ais serves --query lnz, marginals and "
              "prob only"))
    for argv, match in cases:
        with pytest.raises(SystemExit, match=match):
            infer_cli.main(k10 + argv + ["--platform", "cpu"])
    with pytest.raises(SystemExit, match="applies to --query sample only"):
        infer_cli.main(k10 + ["--query", "map", "--method", "gibbs"])


def test_errors_match_jax(k10):
    for argv, match in ((["--query", "prob"], "needs --of"),
                        (["--query", "prob", "--of", "1=1,2=0"],
                         "exactly one"),
                        (["--query", "mmap"], "needs --max-vars"),
                        (["--query", "mmap", "--max-vars", "a"],
                         "bad --max-vars"),
                        (["--evidence", "0=1,0=0"], "assigned twice"),
                        (["--evidence", "x"], "bad assignment")):
        for main in (infer_cli.main, jinfer.main):
            with pytest.raises(SystemExit, match=match):
                main(k10 + argv + ["--platform", "cpu"])
    with pytest.raises(SystemExit, match="--model"):
        infer_cli.main(["--query", "lnz", "--platform", "cpu"])


def test_streaming_cap_errors_match_jax(monkeypatch):
    """Past the width cap and n = 47 the CLI refuses, as JAX's does; a
    streaming mmap is refused by its swept size."""
    monkeypatch.setattr(jtrain, "_ELIM_WIDTH_CAP", 1)
    monkeypatch.setattr(capability, "ELIM_WIDTH_CAP", 1)
    for main in (infer_cli.main, jinfer.main):
        with pytest.raises(SystemExit, match="caps at n=47"):
            main(["--graph", "chain:48", "--platform", "cpu"])
        with pytest.raises(SystemExit, match="each clamped sweep covers 50"):
            main(["--graph", "chain:52", "--platform", "cpu", "--query",
                  "mmap", "--max-vars", "0,1"])


@pytest.mark.parametrize("platform", ["gpu", "default"])
def test_card_platforms_raise_without_cuda(platform, k10):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_cli.main(k10 + ["--platform", platform])
    # --explain never touches a device
    assert infer_cli.main(k10 + ["--platform", platform,
                                 "--explain"])["selected"] == "elimination"


def test_parse_graph_is_host_only():
    assert parse_graph("chain:4") == [[0, 1], [1, 2], [2, 3]]
    from qcmrf_tpu.runners.train_cli import parse_graph as jparse

    assert parse_graph("grid:3x4") == jparse("grid:3x4")
