"""The port's hardware-emulation CLIs and its whisker figure on the CPU
(slice 5): ``run --engine noisy:<preset> | calibrated:<hw>`` write the
JAX package's result schemas, ``eval`` scores them as JAX's harness does,
and ``whisker`` collects what JAX's collects from the same files."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.evaluation import harness as jharness  # noqa: E402
from qcmrf_tpu.models.suite import generate_suite as jgenerate  # noqa: E402
from qcmrf_tpu.viz import whisker as jwhisker  # noqa: E402

from qcmrf_tpu_torch import __main__ as cli  # noqa: E402
from qcmrf_tpu_torch.evaluation import harness  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite, load_suite  # noqa: E402
from qcmrf_tpu_torch.runners import eval as run_eval  # noqa: E402
from qcmrf_tpu_torch.runners import run_experiment  # noqa: E402
from qcmrf_tpu_torch.viz import whisker  # noqa: E402

SCALES = (0.1, 0.25, 0.5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def noisy_root(tmp_path_factory):
    """``run --engine noisy:torino`` at the three scales, 2 000 shots, each
    file also under the name whisker reads (``result_noisy_torino.json``)."""
    root = tmp_path_factory.mktemp("noisy")
    for s in SCALES:
        out = run_experiment.main([
            "--platform", "cpu", "--engine", "noisy:torino", "--scale",
            f"{s:g}", "--shots", "2000", "--sample-seed", str(int(s * 100)),
            "--outdir", str(root / f"res_{s:g}")])
        assert out.endswith(f"result_noisy_torino_{s:g}.json")
        shutil.copy(out, root / f"res_{s:g}" / "result_noisy_torino.json")
    return root


def test_noisy_files_have_the_hardware_schema(noisy_root):
    for s in SCALES:
        path = noisy_root / f"res_{s:g}" / f"result_noisy_torino_{s:g}.json"
        d = json.loads(path.read_text())
        assert set(d) == {"quasi_dists", "metadata"}
        assert len(d["quasi_dists"]) == len(d["metadata"]) == 70
        assert {"shots", "circuit_metadata", "readout_mitigation_overhead",
                "readout_mitigation_time", "warning"} == set(d["metadata"][0])
        assert all(m["shots"] == 2000 for m in d["metadata"])
        dists, norm = jharness.load_result_dists(str(path))
        assert norm == 1
        assert all(abs(sum(q.values()) - 1.0) < 1e-9 for q in dists)


def test_whisker_collect_matches_jax(noisy_root, tmp_path):
    L_F, L_delta, WH = whisker.collect("noisy_torino", str(noisy_root),
                                       device="cpu")
    jL_F, jL_delta, jWH = jwhisker.collect("noisy_torino", str(noisy_root))
    assert L_F.shape == L_delta.shape == (30, 2)
    np.testing.assert_allclose(L_F, jL_F, rtol=0, atol=1e-6)
    np.testing.assert_allclose(L_delta, jL_delta, rtol=0, atol=1e-6)
    assert sorted(WH) == sorted(jWH) == list(SCALES)
    for s in SCALES:
        np.testing.assert_allclose(WH[s], jWH[s], rtol=0, atol=1e-6)
    # noisy deltas still fall with scale
    assert np.mean(WH[0.1]) > np.mean(WH[0.5])
    out = whisker.render("noisy_torino", L_delta, WH,
                         out_path=str(tmp_path / "success.pdf"))
    assert os.path.isfile(out) and os.path.getsize(out) > 1000
    assert not open(out, "rb").read().count(b" c f")  # matplotlib's
    plain = whisker.render_plain("noisy_torino", L_delta, WH,
                                 out_path=str(tmp_path / "plain.pdf"))
    check_plain_pdf(plain, marks=30)


def check_plain_pdf(path, marks):
    """The plain renderer's PDF: every cross-reference offset lands on its
    object, the stream's length is its byte count, and it draws ``marks``
    filled scatter marks, three boxes and the four axis labels."""
    data = open(path, "rb").read()
    assert data.startswith(b"%PDF-1.4\n") and data.endswith(b"%%EOF\n")
    start = int(data.rsplit(b"startxref\n", 1)[1].split()[0])
    assert data[start:].startswith(b"xref\n0 7\n")
    rows = data[start:].split(b"\n")[3:9]
    for i, row in enumerate(rows, start=1):
        off = int(row.split()[0])
        assert data[off:].startswith(b"%d 0 obj\n" % i), (i, off)
    head, rest = data.split(b"stream\n", 1)
    length = int(head.rsplit(b"/Length ", 1)[1].split()[0])
    assert rest[length:].startswith(b"\nendstream")
    stream = rest[:length].decode("latin-1")
    assert stream.count(" c f") == marks
    assert stream.count(" re S") == 3
    for label in ("Parameter norm", "Empirical success rate",
                  "Scale sigma", "Estimated success rate"):
        assert label in stream


def test_whisker_command_writes_its_pdf(noisy_root, tmp_path):
    out = tmp_path / "success_noisy_torino.pdf"
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "qcmrf_tpu_torch", "whisker", "--platform",
         "cpu", "--backend", "noisy_torino", "--res-root", str(noisy_root),
         "--out", str(out)], capture_output=True, text=True, env=env,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"wrote {out}" in res.stdout
    assert out.stat().st_size > 1000
    assert cli.main(["whisker", "--platform", "cpu", "--backend",
                     "noisy_torino", "--res-root", str(noisy_root),
                     "--out", str(tmp_path / "again.pdf")]) == 0
    assert (tmp_path / "again.pdf").stat().st_size > 1000


def test_whisker_renders_plain_without_matplotlib(noisy_root, tmp_path,
                                                   monkeypatch):
    import importlib.util

    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "matplotlib"
                        else find(n, *a))
    _, L_delta, WH = whisker.collect("noisy_torino", str(noisy_root),
                                     device="cpu")
    out = whisker.render("noisy_torino", L_delta, WH,
                         out_path=str(tmp_path / "auto.pdf"))
    check_plain_pdf(out, marks=30)


def test_whisker_needs_the_card_without_a_platform(noisy_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: whisker.main(["--backend", "noisy_torino",
                                       "--res-root", str(noisy_root)]),
                 lambda: whisker.collect("noisy_torino", str(noisy_root))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _eval_both(root, name, scale, norm=None):
    argv = ["--results", name, "--scale", f"{scale:g}", "--res-root",
            str(root), "--platform", "cpu", "--kl"]
    if norm is not None:
        argv += ["--norm", str(norm)]
    results = run_eval.main(argv)
    dists, file_norm = jharness.load_result_dists(
        str(root / f"res_{scale:g}" / name))
    want = jharness.evaluate_suite(jgenerate(scale), dists=dists,
                                   norm=norm or file_norm)
    for r, w in zip(results, want):
        for field in ("fidelities", "successes", "kls"):
            np.testing.assert_allclose(getattr(r, field), getattr(w, field),
                                       rtol=0, atol=1e-6)
    return results


def test_noisy_cli_runs_evaluate(noisy_root, tmp_path, capsys):
    results = _eval_both(noisy_root, "result_noisy_torino_0.1.json", 0.1)
    assert "success rate" in capsys.readouterr().out
    assert all(0.9 < r.mean_f <= 1.0 for r in results)
    # the unmitigated preset writes a counts list of 70 dicts
    assert cli.main(["run", "--platform", "cpu", "--engine",
                     "noisy:depolarizing", "--scale", "0.1", "--shots",
                     "1000", "--outdir", str(tmp_path / "res_0.1")]) == 0
    assert "70 circuits" in capsys.readouterr().out
    counts = json.loads(
        (tmp_path / "res_0.1" / "result_noisy_depolarizing_0.1.json")
        .read_text())
    assert isinstance(counts, list) and len(counts) == 70
    assert all(sum(c.values()) == 1000 for c in counts)
    results = _eval_both(tmp_path, "result_noisy_depolarizing_0.1.json", 0.1,
                         norm=1000)
    for r in results:
        assert r.mean_delta < max(r.exact_deltas) + 0.05


def test_calibrated_cli_uses_the_stored_calibration(tmp_path, capsys):
    """``calibrated:torino`` with no target data: the stored physical
    calibration, every graph's reps one density batch, the hardware schema
    with its negative quasi-probabilities, scored as by JAX."""
    out = run_experiment.main([
        "--platform", "cpu", "--engine", "calibrated:torino", "--scale",
        "0.1", "--shots", "1000", "--outdir", str(tmp_path / "res_0.1")])
    assert "70 circuits" in capsys.readouterr().out
    d = json.loads(open(out).read())
    assert set(d) == {"quasi_dists", "metadata"}
    assert len(d["quasi_dists"]) == 70
    assert any(v < 0 for q in d["quasi_dists"] for v in q.values())
    results = _eval_both(tmp_path, "result_calibrated_torino_0.1.json", 0.1)
    # the stored tables' collapse: chain-4 accepts far below noiseless
    assert results[3].mean_delta < 0.5 * np.mean(results[3].exact_deltas)


def test_calibrated_cli_refits_on_target_data(tmp_path):
    """With --res-root given and res_0.1/result_torino.json under it, the
    engine fits the per-graph calibrated model to that file; without a
    calibration and without targets it names both."""
    suite = generate_suite(0.1)
    sub = {"GRAPHS": suite.graphs[1:2],
           "THETAS": {"0": suite.thetas[1]}}
    res = tmp_path / "res_0.1"
    res.mkdir()
    (res / "models_0.1.json").write_text(json.dumps(sub))
    target = run_experiment.run_suite(
        load_suite(str(res / "models_0.1.json"), 0.1),
        shots=10_000, engine="noisy:ehningen", seed=1, device="cpu")
    (res / "result_torino.json").write_text(json.dumps(target))
    out = run_experiment.main([
        "--platform", "cpu", "--engine", "calibrated:torino", "--scale",
        "0.1", "--res-root", str(tmp_path), "--outdir",
        str(tmp_path / "out")])
    d = json.loads(open(out).read())
    assert len(d["quasi_dists"]) == 10
    sub_suite = load_suite(str(res / "models_0.1.json"), 0.1)
    want = harness.evaluate_suite(sub_suite, dists=target["quasi_dists"],
                                  norm=1, device="cpu")[0]
    have = harness.evaluate_suite(sub_suite, dists=d["quasi_dists"], norm=1,
                                  device="cpu")[0]
    assert abs(have.mean_f - want.mean_f) <= 0.01
    assert abs(have.mean_delta - want.mean_delta) <= 0.03
    with pytest.raises(FileNotFoundError) as err:
        run_experiment.run_suite(generate_suite(0.1), shots=10,
                                 engine="calibrated:nowhere", device="cpu",
                                 res_root=str(tmp_path))
    assert "nowhere_0.1.json" in str(err.value)
    assert "result_nowhere.json" in str(err.value)
