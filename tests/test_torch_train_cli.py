"""The port's train CLI against the JAX package's on the same numpy-made
``--data`` files: ``fitted_model.json`` theta within 1e-4 and
``final_nll`` within 1e-5 on the enumeration, big-n (bit arrays,
elimination) and wide (streaming fused sweep) routes and under
``--learn-structure``; the port's checkpoints (numbered ``ckpt/<step>``
directories, ``torch.save``), resume, config files, shot gradient and the
exits that name a later slice."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from qcmrf_tpu.models import sample as jsample  # noqa: E402
from qcmrf_tpu.models import train as jtrain  # noqa: E402
from qcmrf_tpu.runners import train_cli as jcli  # noqa: E402

from qcmrf_tpu_torch import __main__ as cli  # noqa: E402
from qcmrf_tpu_torch.models import capability  # noqa: E402
from qcmrf_tpu_torch.runners import train_cli  # noqa: E402
from test_structure import planted_chain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, obj):
    path.write_text(json.dumps(obj))
    return str(path)


@pytest.fixture(scope="module")
def ids5(tmp_path_factory):
    """2047 state ids of a 5-chain (2047: no clique count is exactly a
    quarter, so no gradient entry of the constant start is 0 and Adam's
    first step follows no rounding noise)."""
    d = tmp_path_factory.mktemp("ids")
    x = np.random.RandomState(3).randint(0, 32, 2047)
    return _write(d / "ids.json", x.tolist())


def _both(tmp_path, argv):
    """fitted_model.json of the JAX CLI and of the port's, on the CPU."""
    docs = []
    for name, main in (("jax", jcli.main), ("port", train_cli.main)):
        out = main(argv + ["--platform", "cpu",
                           "--outdir", str(tmp_path / name)])
        docs.append(json.loads(open(out).read()))
    return docs


def assert_docs_agree(got, want):
    assert got["cliques"] == want["cliques"]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=0,
                               atol=1e-4)
    assert abs(got["final_nll"] - want["final_nll"]) <= 1e-5


def test_fit_matches_jax(tmp_path, ids5):
    want, got = _both(tmp_path, ["--graph", "chain:5", "--data", ids5,
                                 "--steps", "40", "--lr", "0.1",
                                 "--checkpoint-every", "20"])
    assert_docs_agree(got, want)
    cfg = json.loads((tmp_path / "port" / "train_config.json").read_text())
    assert cfg["steps"] == 40 and cfg["platform"] == "cpu"


def _port(tmp, *extra):
    return train_cli.main(["--graph", "chain:5", "--lr", "0.1",
                           "--platform", "cpu", "--outdir", str(tmp),
                           *extra])


def test_checkpoint_resume_roundtrip(tmp_path, ids5):
    """Numbered step directories; resume picks up at the newest and lands
    where an uninterrupted run does."""
    out = _port(tmp_path, "--data", ids5, "--steps", "40",
                "--checkpoint-every", "20")
    nll_40 = json.loads(open(out).read())["final_nll"]
    for step in (20, 40):
        assert (tmp_path / "ckpt" / str(step) / train_cli.CKPT_FILE).is_file()
    out = _port(tmp_path, "--data", ids5, "--steps", "80",
                "--checkpoint-every", "20", "--resume")
    resumed = json.loads(open(out).read())
    assert resumed["final_nll"] <= nll_40 + 1e-3
    assert len(resumed["theta"]) == 16
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["60", "80"]
    straight = json.loads(open(_port(
        tmp_path / "straight", "--data", ids5, "--steps", "80",
        "--checkpoint-every", "80")).read())
    np.testing.assert_allclose(resumed["theta"], straight["theta"], rtol=0,
                               atol=1e-7)


def test_foreign_checkpoints_are_refused(tmp_path, ids5):
    orbax = tmp_path / "o" / "ckpt" / "40"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(SystemExit, match="orbax"):
        _port(tmp_path / "o", "--data", ids5, "--steps", "60", "--resume")
    legacy = tmp_path / "l"
    legacy.mkdir()
    (legacy / "checkpoint.npz").write_bytes(b"")
    with pytest.raises(SystemExit, match="legacy"):
        _port(legacy, "--data", ids5, "--steps", "2", "--resume")


def test_config_file_supplies_defaults(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"data_seed": 3, "platform": "cpu",
                               "outdir": str(tmp_path / "o")}))
    train_cli.main(["--graph", "chain:4", "--samples", "1024", "--steps",
                    "10", "--config", str(cfg)])
    dumped = json.load(open(tmp_path / "o" / "train_config.json"))
    assert dumped["data_seed"] == 3 and dumped["steps"] == 10
    assert dumped["lr"] == 0.05 and dumped["checkpoint_every"] == 100
    assert os.path.isfile(tmp_path / "o" / "fitted_model.json")
    data = json.load(open(tmp_path / "o" / "data.json"))
    assert len(data) == 1024 and 0 <= min(data) and max(data) < 16


def test_config_file_rejects_unknown_keys(tmp_path):
    cfg = tmp_path / "bad.json"
    cfg.write_text(json.dumps({"sedd": 3}))
    with pytest.raises(SystemExit, match="unknown keys"):
        train_cli.main(["--steps", "1", "--config", str(cfg)])


@pytest.fixture
def bits7(tmp_path):
    bits = (np.random.RandomState(4).rand(301, 7) < 0.4).astype(int)
    return _write(tmp_path / "bits7.json", bits.tolist())


def test_big_n_path_matches_jax(tmp_path, monkeypatch, bits7):
    """Bit-array data past the threshold: moment-target training through
    elimination in both packages."""
    monkeypatch.setenv("QCMRF_BIG_N_THRESHOLD", "5")
    want, got = _both(tmp_path, ["--graph", "chain:7", "--data", bits7,
                                 "--steps", "25", "--lr", "0.15"])
    assert_docs_agree(got, want)
    with pytest.raises(SystemExit, match="7-bit arrays"):
        train_cli.main(["--graph", "chain:7", "--data", _write(
            tmp_path / "ids.json", [1, 2, 3]), "--platform", "cpu",
            "--outdir", str(tmp_path / "x")])


def test_wide_path_matches_jax(tmp_path, monkeypatch):
    """A wide structure past the threshold: the streaming fused sweep in
    the port against JAX's streaming custom VJP, the width cap set to 1
    (patched in process for JAX, QCMRF_ELIM_WIDTH_CAP=1 in a child process
    for the port)."""
    k6 = _write(tmp_path / "k6.json",
                [[i, j] for i in range(6) for j in range(i + 1, 6)])
    bits = _write(tmp_path / "bits.json", (np.random.RandomState(5).rand(
        257, 6) < 0.3).astype(int).tolist())
    argv = ["--graph", k6, "--data", bits, "--steps", "4", "--lr", "0.2",
            "--platform", "cpu"]
    monkeypatch.setenv("QCMRF_BIG_N_THRESHOLD", "5")
    monkeypatch.setattr(jtrain, "_ELIM_WIDTH_CAP", 1)
    want = json.loads(open(jcli.main(
        argv + ["--outdir", str(tmp_path / "jax")])).read())
    env = dict(os.environ, QCMRF_ELIM_WIDTH_CAP="1", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "qcmrf_tpu_torch", "train", *argv,
                    "--outdir", str(tmp_path / "port")], cwd=REPO, env=env,
                   check=True, timeout=300, capture_output=True)
    got = json.loads((tmp_path / "port" / "fitted_model.json").read_text())
    assert_docs_agree(got, want)


def test_learn_structure_matches_jax(tmp_path):
    true, edges = planted_chain(5, seed=3)
    x = np.asarray(jsample.sample_exact(jax.random.PRNGKey(3), true, 4096))
    data = _write(tmp_path / "x.json", x.tolist())
    want, got = _both(tmp_path, ["--graph", "chain:5", "--data", data,
                                 "--steps", "200", "--learn-structure"])
    assert got["structure"]["selected"] == want["structure"]["selected"] \
        == edges
    for k in ("candidates", "template_cliques", "threshold", "l1"):
        assert got["structure"][k] == want["structure"][k]
    norm = np.asarray(want["structure"]["interaction_norm"])
    real = norm >= want["structure"]["threshold"]
    np.testing.assert_allclose(
        np.asarray(got["structure"]["interaction_norm"])[real], norm[real],
        rtol=0, atol=1e-3)
    assert_docs_agree(got, want)


def test_shots_gradient_mode(tmp_path):
    """--grad shots trains on sampled moments (data drawn from a random
    chain, seed 3), and a resumed run continues the shot stream (step s
    draws on the key (seed + 1, s)) instead of replaying it: 30 + 30 steps
    land where 60 do."""
    shots = ["--seed", "3", "--samples", "2048", "--grad", "shots",
             "--grad-shots", "4096"]
    out = _port(tmp_path / "a", "--steps", "60", "--checkpoint-every", "30",
                *shots)
    straight = json.loads(open(out).read())
    assert np.isfinite(straight["final_nll"])
    assert straight["final_nll"] < 3.2  # from ~n ln 2 = 3.47 at the start
    _port(tmp_path / "b", "--steps", "30", *shots)
    out = _port(tmp_path / "b", "--steps", "60", "--resume", *shots)
    resumed = json.loads(open(out).read())
    np.testing.assert_allclose(resumed["theta"], straight["theta"], rtol=0,
                               atol=1e-7)


def test_unported_options_name_their_slices(tmp_path, monkeypatch, ids5):
    """``--mesh`` (slice 6a) runs; what JAX refuses, the port refuses
    alike: a bad AxB, shots that do not split over the mesh, and
    elimination training past the threshold on a mesh."""
    for argv, match in ((["--mesh", "2"], "expected AxB"),
                        (["--grad", "shots", "--grad-shots", "4097",
                          "--mesh", "2x1"], "divisible by the mesh")):
        with pytest.raises(SystemExit, match=match):
            train_cli.main(["--steps", "1", "--platform", "cpu",
                            "--outdir", str(tmp_path)] + argv)
    out = train_cli.main(["--steps", "1", "--platform", "cpu", "--mesh",
                          "2x1", "--outdir", str(tmp_path / "m")])
    assert np.isfinite(json.loads(open(out).read())["final_nll"])
    monkeypatch.setenv("QCMRF_BIG_N_THRESHOLD", "5")
    with pytest.raises(SystemExit, match="elimination training is single"):
        train_cli.main(["--graph", "chain:7", "--steps", "1", "--platform",
                        "cpu", "--mesh", "2x1", "--outdir", str(tmp_path)])


def test_guards_match_jax(tmp_path):
    k48 = _write(tmp_path / "k48.json",
                 [[i, j] for i in range(48) for j in range(i + 1, 48)])
    with pytest.raises(SystemExit, match="tops out") as e:
        train_cli.main(["--graph", k48, "--steps", "1", "--outdir",
                        str(tmp_path)])
    assert "--grad ais" in str(e.value)
    for argv, match in ((["--graph", "chain:40", "--grad", "shots"],
                         "shots"),
                        (["--learn-structure", "--grad", "shots"],
                         "learn-structure"),
                        (["--learn-structure", "--grad", "ais"],
                         "learn-structure")):
        for main in (train_cli.main, jcli.main):
            with pytest.raises(SystemExit, match=match):
                main(["--steps", "1", "--platform", "cpu", "--outdir",
                      str(tmp_path)] + argv)
    assert capability.big_n_threshold() == 30


@pytest.mark.parametrize("platform", ["gpu", "default"])
def test_card_platforms_raise_without_cuda(platform, tmp_path, ids5):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--graph", "chain:5", "--data", ids5, "--platform",
                        platform, "--outdir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_cli_dispatch(tmp_path, ids5, capsys):
    assert cli.main(["train", "--graph", "chain:5", "--data", ids5,
                     "--steps", "3", "--platform", "cpu", "--outdir",
                     str(tmp_path)]) == 0
    assert "wrote" in capsys.readouterr().out
    assert "train" in cli.__doc__
