"""Slice 7a of the port on the CPU: ``utils.config.Config`` against the
JAX package's (JSON both ways), ``utils.profiling.timed``, ``trace`` and
``device_busy`` (a CPU-only profile, and a hand-written trace with known
intervals and gaps), and ``runners.bench``: its argument parsing, its
refusal without a CUDA device (the bench measures the card), and its
grid model. The measurements themselves run on the card
(``chip_smoke.py``, phase bench)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.utils import config as jconfig  # noqa: E402

from qcmrf_tpu_torch import __main__ as cli  # noqa: E402
from qcmrf_tpu_torch.runners import bench  # noqa: E402
from qcmrf_tpu_torch.utils import config, profiling  # noqa: E402


@pytest.mark.parametrize("fields", [
    {},
    {"scale": 0.1, "shots": 1024, "engine": "noisy:torino",
     "mesh_shape": (4, 2), "mesh_axes": ("amp", "data"), "outdir": "o"},
    {"models_path": "m.json", "sample_seed": 3, "data_seed": 7,
     "platform": "cpu", "reps": 2},
])
def test_config_round_trips_with_jax(fields):
    """The port's Config has JAX's fields and defaults; its JSON reads
    back in JAX's Config.from_json and JAX's in the port's, equal field
    for field."""
    assert [f.name for f in dataclasses.fields(config.Config)] == [
        f.name for f in dataclasses.fields(jconfig.Config)]
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(
        jconfig.Config())
    mine = config.Config(**fields)
    theirs = jconfig.Config(**fields)
    assert dataclasses.asdict(jconfig.Config.from_json(mine.to_json())) == \
        dataclasses.asdict(theirs)
    assert config.Config.from_json(theirs.to_json()) == mine
    assert config.CONFIG_KEYS == frozenset(dataclasses.asdict(mine))


def test_config_platform_and_mesh():
    """apply_platform resolves cpu and refuses a TPU name and, with no
    CUDA device, gpu; make_mesh builds the (amp, data) mesh (the CPU
    repeated) or None."""
    c = config.Config(platform="cpu", mesh_shape=(4, 2),
                      mesh_axes=("amp", "data"))
    assert c.apply_platform() == torch.device("cpu")
    mesh = c.make_mesh()
    assert mesh.shape == {"amp": 4, "data": 2} and mesh.size == 8
    assert config.Config(platform="cpu").make_mesh() is None
    with pytest.raises(ValueError, match="unknown platform"):
        config.Config(platform="tpu").apply_platform()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            config.Config(platform="gpu").apply_platform()


def test_timed_on_the_host():
    """timed returns seconds a call on the host clock for CPU results:
    a call that sleeps 20 ms measures 20-200 ms, warm-up calls not
    counted."""
    import time

    calls = []

    def slow():
        calls.append(1)
        time.sleep(0.02)
        return torch.zeros(1)

    s = profiling.timed(slow, reps=3, warmup=2)
    assert 0.02 <= s < 0.2 and len(calls) == 5


def test_trace_and_device_busy_on_the_cpu(tmp_path):
    """A CPU-only profile: trace writes one Chrome trace into its
    directory, device_busy finds no CUDA kernel in it, so the device is
    idle throughout a window of positive length."""
    with profiling.trace(str(tmp_path / "t")) as d:
        x = torch.randn(256, 256)
        (x @ x).sum()
    files = profiling.trace_files(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    b = profiling.device_busy(files[0])
    assert b["kernels"] == 0 and b["busy_ms"] == 0 and b["union_ms"] == 0
    assert b["window_ms"] > 0 and b["idle_share"] == 1.0
    assert b["gaps"] == [[0.0, b["window_ms"]]]


def test_device_busy_parses_known_intervals(tmp_path):
    """A hand-written trace: a host span over [0, 1000) us and kernels at
    [100, 300), [200, 400) (overlapping), [600, 650) and [900, 1000):
    busy 0.55 ms summed, a union of 0.45 ms, a 1 ms window, idle share
    0.55; the longest gaps 0.25 ms at 0.65 ms, 0.2 ms at 0.4 ms, 0.1 ms
    at 0; memcpy and instant events are not kernels. The idle time by
    program span: the gap at 0.4 ms under the wait span nested in the
    answer span in the request span, the two others under the request
    span alone; the benchmark's span and the device's copy of a program
    span name no gap."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 200, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 600, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 700, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 900, "dur": 100},
        {"ph": "i", "cat": "kernel", "name": "mark", "ts": 950},
        {"ph": "X", "cat": "user_annotation", "name": "qcmrf.infer",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "qcmrf.infer.answer",
         "ts": 350, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "qcmrf.wait",
         "ts": 480, "dur": 40},
        {"ph": "X", "cat": "user_annotation", "name": "bench.query",
         "ts": 10, "dur": 980},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "qcmrf.wait",
         "ts": 700, "dur": 150},
    ]
    path = tmp_path / "x.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    b = profiling.device_busy(str(path), top=2, gaps=3)
    assert b["kernels"] == 4
    assert b["busy_ms"] == pytest.approx(0.55)
    assert b["union_ms"] == pytest.approx(0.45)
    assert b["window_ms"] == pytest.approx(1.0)
    assert b["idle_share"] == pytest.approx(0.55)
    assert [name for name, _, _ in b["top"]] == ["b", "a"]
    assert b["top"][0][1:] == [pytest.approx(0.3), 2]
    np.testing.assert_allclose(b["gaps"], [[0.65, 0.25], [0.4, 0.2],
                                           [0.0, 0.1]])
    assert list(b["gap_spans"]) == ["qcmrf.infer", "qcmrf.wait"]
    assert b["gap_spans"]["qcmrf.infer"] == pytest.approx(0.35)
    assert b["gap_spans"]["qcmrf.wait"] == pytest.approx(0.2)
    empty = tmp_path / "e.pt.trace.json"
    empty.write_text(json.dumps([]))
    with pytest.raises(ValueError, match="no timed events"):
        profiling.device_busy(str(empty))


def test_bench_arguments_and_refusal_without_a_card(capsys):
    """bench takes JAX's flags (--n, --shots, --trace, --json; an unknown
    one exits 2) and raises without a CUDA device: the bench measures the
    card and has no CPU fallback."""
    with pytest.raises(SystemExit) as e:
        bench.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert all(flag in out for flag in ("--n", "--shots", "--trace",
                                        "--json"))
    with pytest.raises(SystemExit) as e:
        bench.main(["--bogus"])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        for call in (lambda: bench.main(["--json", "--n", "12"]),
                     lambda: cli.main(["bench", "--json"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


def test_grid_model():
    """grid_model(n) is JAX bench's grid, 4 x 5 at n = 20 and 5 x 5 at
    n = 28."""
    m = bench.grid_model(20, "cpu")
    assert m.n == 20 and m.num_cliques == 31
    assert bench.grid_model(28, "cpu").n == 25
