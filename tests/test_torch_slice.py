"""The port's slices end to end on the CPU: ``run`` (analytic and
statevector engines) writes counts that the JAX package's harness scores,
the port's ``eval`` scores them the same, and the platform choices behave
as documented."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qcmrf_tpu.circuits.compiler import compile_qcmrf as jcompile  # noqa: E402
from qcmrf_tpu.evaluation import harness as jharness  # noqa: E402
from qcmrf_tpu.models import suite as jsuite  # noqa: E402
from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402
from qcmrf_tpu.sim import dense as jdense  # noqa: E402

from qcmrf_tpu_torch import __main__ as cli  # noqa: E402
from qcmrf_tpu_torch.evaluation import harness  # noqa: E402
from qcmrf_tpu_torch.models.suite import generate_suite  # noqa: E402
from qcmrf_tpu_torch.ops import circuit_kernel  # noqa: E402
from qcmrf_tpu_torch.runners import eval as run_eval  # noqa: E402
from qcmrf_tpu_torch.runners import run_experiment  # noqa: E402

SHOTS = 2000


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_run")
    out = run_experiment.main([
        "--platform", "cpu", "--shots", str(SHOTS), "--scale", "0.1",
        "--outdir", str(root / "res_0.1")])
    assert out.endswith("result_analytic_0.1.json")
    return root


def test_run_file_scores_under_jax_harness(run_dir):
    path = run_dir / "res_0.1" / "result_analytic_0.1.json"
    dists, norm = jharness.load_result_dists(str(path))
    assert len(dists) == 70
    assert all(sum(d.values()) == SHOTS for d in dists)
    suite = jsuite.generate_suite(0.1)
    for d, (j, C) in zip(dists, [(j, C) for j, C in enumerate(suite.graphs)
                                 for _ in range(10)]):
        n = max(v for c in C for v in c) + 1
        assert all(len(k) == n + len(C) + 1 for k in d)
    results = jharness.evaluate_suite(suite, dists=dists, norm=SHOTS)
    for r in results:
        assert r.mean_f >= 0.97, (r.graph, r.mean_f)


def test_port_eval_matches_jax_field_by_field(run_dir, capsys):
    results = run_eval.main([
        "--results", "result_analytic_0.1.json", "--scale", "0.1",
        "--res-root", str(run_dir), "--norm", str(SHOTS), "--kl",
        "--platform", "cpu"])
    table = capsys.readouterr().out
    path = run_dir / "res_0.1" / "result_analytic_0.1.json"
    dists, _ = jharness.load_result_dists(str(path))
    jsuite_ = jsuite.generate_suite(0.1)
    want = jharness.evaluate_suite(jsuite_, dists=dists, norm=SHOTS)
    assert len(results) == len(want) == 7
    for r, w in zip(results, want):
        assert r.graph == w.graph
        for field in ("fidelities", "successes", "kls"):
            np.testing.assert_allclose(getattr(r, field), getattr(w, field),
                                       rtol=0, atol=1e-6)
        j = jsuite_.graphs.index(w.graph)
        exact = [float(JMRF.create(w.graph, theta=t).success_rate())
                 for t in jsuite_.thetas[j]]
        np.testing.assert_allclose(r.exact_deltas, exact, rtol=1e-5)
        # shot noise of 2000 shots
        assert max(abs(a - b) for a, b in
                   zip(r.successes, r.exact_deltas)) < 0.05
    assert table.strip() == jharness.results_table(want, with_kl=True)
    # the models file the run wrote is the suite's, byte for byte
    models = run_dir / "res_0.1" / "models_0.1.json"
    assert json.loads(models.read_text()) == jsuite_.to_json_dict()


def test_run_reads_stored_models_under_res_root(run_dir, tmp_path):
    out = run_experiment.main([
        "--platform", "cpu", "--shots", "64", "--scale", "0.1",
        "--res-root", str(run_dir), "--outdir", str(tmp_path),
        "--sample-seed", "3"])
    counts = json.loads(open(out).read())
    assert len(counts) == 70 and all(sum(c.values()) == 64 for c in counts)
    cfg = json.loads((tmp_path / "config_run_0.1.json").read_text())
    assert cfg["sample_seed"] == 3 and cfg["platform"] == "cpu"


def test_run_is_deterministic_per_seed():
    suite = generate_suite(0.1)
    a = run_experiment.run_suite(suite, shots=300, seed=5,
                                 device="cpu")
    b = run_experiment.run_suite(suite, shots=300, seed=5,
                                 device="cpu")
    c = run_experiment.run_suite(suite, shots=300, seed=6,
                                 device="cpu")
    assert a == b and a != c


@pytest.mark.parametrize("platform", ["gpu", "default"])
def test_gpu_platform_raises_without_cuda(platform, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment.main(["--platform", platform, "--shots", "10",
                             "--scale", "0.1", "--outdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval.main(["--platform", platform, "--res-root", str(tmp_path)])
    assert not (tmp_path / "models_0.1.json").exists()


@pytest.mark.parametrize("case", ["sandwich24", "lowered28",
                                  "lane_circuit", "gibbs", "sharded24"])
def test_host_ab_needs_the_card(case, capsys):
    """The A/B timing script exits 1, printing no result, without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from qcmrf_tpu_torch.runners import host_ab

    assert host_ab.main([case]) == 1
    assert capsys.readouterr().out == ""


def _chain12():
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.models.mrf import MRF

    mrf = MRF.create([[i, i + 1] for i in range(5)], theta=-0.2 * np.ones(20),
                     device="cpu")
    return compile_qcmrf(mrf, with_measurements=False)


def _file_mode_root() -> str:
    """A res_0.1/r.json of one all-zeros count per suite circuit."""
    import tempfile

    root = tempfile.mkdtemp()
    os.makedirs(os.path.join(root, "res_0.1"))
    with open(os.path.join(root, "res_0.1", "r.json"), "w") as f:
        json.dump([{"0": 10_000}] * 70, f)
    return root


def _default_device_calls():
    import tempfile

    from qcmrf_tpu_torch.models import pauli, sample, train
    from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf, grid_mrf
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.runners import bench, train_cli
    from qcmrf_tpu_torch.sim import batch, dense, planes

    from qcmrf_tpu_torch.parallel import sharded

    return {
        "bench.main": lambda: bench.main(["--json", "--n", "12"]),
        "bench.record": bench.record,
        "sharded.make_mesh": lambda: sharded.make_mesh(),
        "bench.copy_kernel_gbps": lambda: bench.copy_kernel_gbps(12),
        "bench.fma_peak_tflops": lambda: bench.fma_peak_tflops(),
        "train.fit_mle": lambda: train.fit_mle(
            MRF.create([[0, 1]], theta=[-0.1] * 4), [0, 3], steps=1),
        "train.adam_from_numpy": lambda: train.adam_from_numpy(
            np.zeros(4), np.zeros(4), np.zeros(4), 1, 0.1),
        "sample.sample_exact": lambda: sample.sample_exact(
            0, MRF.create([[0, 1]], theta=[-0.1] * 4), 8),
        "train_cli.main": lambda: train_cli.main([
            "--graph", "chain:3", "--steps", "1", "--platform", "default",
            "--outdir", tempfile.mkdtemp()]),
        "bench.gate_apply_gbps": lambda: bench.gate_apply_gbps(12),
        "PauliSum.diagonal": lambda: pauli.z_on(3, 1).diagonal(),
        "MRF.create": lambda: MRF.create([[0, 1]], theta=[-0.1] * 4).theta,
        "MRF.from_numpy": lambda: MRF.from_numpy(
            [[0, 1]], np.full(4, -0.1)).theta,
        "chain_mrf": lambda: chain_mrf(3).theta,
        "grid_mrf": lambda: grid_mrf(2, 2).theta,
        "ModelSuite.mrfs": lambda: [m.theta for m in
                                    generate_suite(0.1, reps=1).mrfs()],
        "planes.run_statevector": lambda: planes.run_statevector(_chain12()),
        "planes.simulate_probs": lambda: planes.simulate_probs(_chain12()),
        "planes.run_ops": lambda: planes.run_ops(
            planes.fuse_ops(_chain12()), 12),
        "dense.run_statevector": lambda: dense.run_statevector(_chain12()),
        "circuit_kernel.batched_circuit_probs":
            lambda: circuit_kernel.batched_circuit_probs(
                [[0, 1]], [[-0.1] * 4]),
        "circuit_kernel.batched_circuits_probs":
            lambda: circuit_kernel.batched_circuits_probs(
                [([[0, 1]], [[-0.1] * 4]), ([[0]], [[-0.2] * 2])]),
        "kernels.apply_hdh_sandwich_multi_uniform":
            lambda: kernels.apply_hdh_sandwich_multi_uniform(
                9, (0, 1), 7, ((),), ((),), (0.1,)),
        "batch.batched_joint_probs":
            lambda: batch.batched_joint_probs([[0, 1]], [[-0.1] * 4]),
        "run_experiment.run_suite": lambda: run_experiment.run_suite(
            generate_suite(0.1), shots=10, engine="statevector"),
        "harness.evaluate_suite": lambda: harness.evaluate_suite(
            generate_suite(0.1, reps=1), mode="gibbs", num_samples=10),
        "harness.evaluate_suite(mode='file')":
            lambda: harness.evaluate_suite(
                generate_suite(0.1, reps=1), dists=[{"0": 1.0}] * 7,
                mode="file"),
        "eval.main(--mode file)": lambda: run_eval.main(
            ["--results", "r.json", "--scale", "0.1", "--res-root",
             _file_mode_root()]),
        **_noise_default_device_calls(),
    }


def _one_graph_suite():
    suite = generate_suite(0.1, reps=2)
    return dataclasses.replace(suite, graphs=suite.graphs[1:2],
                               thetas={0: suite.thetas[1]})


def _noise_default_device_calls():
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.noise import backends, density, fit, physical
    from qcmrf_tpu_torch.viz import whisker

    def lowered():
        return physical.lowered_for_noise(
            MRF.create([[0, 1]], theta=[-0.1] * 4, device="cpu"))

    dists = [{"00000": 0.6, "00001": 0.4}] * 2
    return {
        "density.noisy_clbit_probs": lambda: density.noisy_clbit_probs(
            lowered(), 0.001, 0.01),
        "density.evolve_density_batch": lambda: density.evolve_density_batch(
            [lowered(), lowered()], 0.001, 0.01),
        "density.confuse_bits(host array)": lambda: density.confuse_bits(
            np.full(4, 0.25), 0.01, 0.02, [0, 1], 2),
        "backends.run_noisy_suite": lambda: backends.run_noisy_suite(
            0, _one_graph_suite(), backends.preset("torino"), 10),
        "backends.run_calibrated_suite": lambda: backends.run_calibrated_suite(
            0, _one_graph_suite(), fit.CalibratedNoiseModel(
                "t", 0.01, (fit.GraphCalibration(0.1, 0.1, 0.0),)), 10),
        "physical.run_physical_suite": lambda: physical.run_physical_suite(
            0, _one_graph_suite(), physical.PhysicalNoiseModel(
                "t", 0.1, 0.01, (0.5,), (0.0,), (0.0,)), 10),
        "physical.fit_physical_predictive":
            lambda: physical.fit_physical_predictive(
                "t", _one_graph_suite(), dists, shots=10, polish_rounds=1),
        "fit.fit_calibrated": lambda: fit.fit_calibrated(
            "t", _one_graph_suite(), dists, iters=2, shots=10),
        "fit.fit_depolarizing_rate": lambda: fit.fit_depolarizing_rate(
            _one_graph_suite(), dists),
        "run_experiment.run_suite(noisy)": lambda: run_experiment.run_suite(
            _one_graph_suite(), shots=10, engine="noisy:torino"),
        "run_experiment.run_suite(calibrated)":
            lambda: run_experiment.run_suite(
                _one_graph_suite(), shots=10, engine="calibrated:torino"),
        "whisker.collect": lambda: whisker.collect("noisy", _file_mode_root()),
        "whisker.main": lambda: whisker.main(
            ["--backend", "noisy", "--res-root", _file_mode_root()]),
    }


@pytest.mark.parametrize("entry", sorted(_default_device_calls()))
def test_entry_points_default_to_the_card(entry):
    """Called without a device, an entry point runs on the current CUDA
    device, and raises where there is none: never a silent CPU run."""
    call = _default_device_calls()[entry]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        return
    out = call()
    first = out[0] if isinstance(out, (tuple, list)) else out
    assert not isinstance(first, torch.Tensor) or first.is_cuda


def test_unported_options_name_their_slice(run_dir, tmp_path):
    from qcmrf_tpu_torch.models import ais
    from qcmrf_tpu_torch.models.mrf import chain_mrf
    from qcmrf_tpu_torch.parallel import sharded

    # the bench command (slice 7a) measures the card: it raises without one
    assert "bench     " in cli.__doc__
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["bench"])
    # the AIS chains shard over a mesh (slice 6a): the same chains
    m = chain_mrf(3, device="cpu")
    mesh = sharded.make_mesh(2, device="cpu")
    for fn in (ais.ais_log_partition, ais.ais_clique_marginals):
        assert torch.equal(fn(0, m, 4, 2, mesh=mesh), fn(0, m, 4, 2))
    # the gate-level sharded engine (slice 6b): a Bell pair across the
    # mesh's device bit, one part a shard
    from qcmrf_tpu_torch.circuits.ir import Circuit

    bell = Circuit(2)
    bell.h(1).cx(1, 0)
    parts = sharded.sharded_outcome_probs(bell, mesh)
    assert len(parts) == 2
    torch.testing.assert_close(sharded.gather(parts),
                               torch.tensor([0.5, 0.0, 0.0, 0.5]),
                               rtol=0, atol=1e-6)
    # file mode ignores --native, as the JAX harness does
    results = run_eval.main(["--results", "result_analytic_0.1.json",
                             "--scale", "0.1", "--res-root", str(run_dir),
                             "--native", "--platform", "cpu"])
    assert len(results) == 7


def test_cli_dispatch_and_config(tmp_path, capsys):
    assert cli.main([]) == 0
    assert cli.main(["nonesuch"]) == 2
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"shots": 32, "platform": "cpu",
                               "mesh_shape": [4, 2]}))
    assert cli.main(["run", "--config", str(cfg), "--scale", "0.1",
                     "--outdir", str(tmp_path / "res_0.1")]) == 0
    assert "['mesh_shape']" in capsys.readouterr().err
    counts = json.loads(
        (tmp_path / "res_0.1" / "result_analytic_0.1.json").read_text())
    assert all(sum(c.values()) == 32 for c in counts)
    assert cli.main(["eval", "--results", "result_analytic_0.1.json",
                     "--scale", "0.1", "--res-root", str(tmp_path),
                     "--norm", "32", "--platform", "cpu"]) == 0
    assert "success rate" in capsys.readouterr().out
    cfg.write_text(json.dumps({"shots": 32, "shot_count": 4}))
    with pytest.raises(SystemExit, match="shot_count"):
        cli.main(["run", "--config", str(cfg)])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import qcmrf_tpu_torch.__main__, qcmrf_tpu_torch.runners.eval\n"
            "import qcmrf_tpu_torch.runners.run_experiment\n"
            "import qcmrf_tpu_torch.circuits.params\n"
            "import qcmrf_tpu_torch.sim.planes, qcmrf_tpu_torch.sim.dense\n"
            "import qcmrf_tpu_torch.ops.circuit_kernel\n"
            "import qcmrf_tpu_torch.runners.infer_cli\n"
            "import qcmrf_tpu_torch.models.elimination\n"
            "import qcmrf_tpu_torch.models.moments\n"
            "import qcmrf_tpu_torch.models.sample\n"
            "import qcmrf_tpu_torch.models.capability\n"
            "import qcmrf_tpu_torch.models.train\n"
            "import qcmrf_tpu_torch.models.structure\n"
            "import qcmrf_tpu_torch.evaluation.estimators\n"
            "import qcmrf_tpu_torch.runners.train_cli\n"
            "import qcmrf_tpu_torch.runners.bench\n"
            "import qcmrf_tpu_torch.models.ais\n"
            "import qcmrf_tpu_torch.native.kiopto\n"
            "import qcmrf_tpu_torch.noise.channels\n"
            "import qcmrf_tpu_torch.noise.mitigation\n"
            "import qcmrf_tpu_torch.noise.density\n"
            "import qcmrf_tpu_torch.noise.backends\n"
            "import qcmrf_tpu_torch.noise.physical\n"
            "import qcmrf_tpu_torch.noise.fit\n"
            "import qcmrf_tpu_torch.viz.whisker\n"
            "import qcmrf_tpu_torch.parallel.sharded\n"
            "import qcmrf_tpu_torch.parallel.dryrun\n"
            "import qcmrf_tpu_torch.runners.scaling\n"
            "import qcmrf_tpu_torch.utils.profiling\n"
            "import qcmrf_tpu_torch.utils.config\n"
            "for cmd in ('whisker', 'bench'):\n"
            "    try:\n"
            "        qcmrf_tpu_torch.__main__.main([cmd, '--help'])\n"
            "    except SystemExit:\n"
            "        pass\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'qcmrf_tpu.')) or m == 'qcmrf_tpu']\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


SV_SHOTS = 10_000


@pytest.fixture(scope="module")
def sv_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_sv")
    out = run_experiment.main([
        "--platform", "cpu", "--engine", "statevector", "--shots",
        str(SV_SHOTS), "--scale", "0.1", "--outdir", str(root / "res_0.1")])
    assert out.endswith("result_statevector_0.1.json")
    return root


def test_statevector_run_follows_jax_dense_probabilities(sv_dir):
    """70 counts dicts, drawn from probabilities that equal the JAX
    package's dense engine on every circuit (atol 2e-5)."""
    path = sv_dir / "res_0.1" / "result_statevector_0.1.json"
    counts = json.loads(path.read_text())
    assert len(counts) == 70
    assert all(sum(c.values()) == SV_SHOTS for c in counts)
    suite = jsuite.generate_suite(0.1)
    i = 0
    for j, C in enumerate(suite.graphs):
        width = max(v for c in C for v in c) + 1 + len(C) + 1
        probs = circuit_kernel.batched_circuit_probs(C, suite.thetas[j],
                                                     device="cpu")
        for theta, p in zip(suite.thetas[j], probs.numpy()):
            want = np.asarray(jdense.simulate_probs(
                jcompile(JMRF.create(C, theta=np.float32(theta)))))
            np.testing.assert_allclose(p, want, atol=2e-5)
            assert all(len(k) == width for k in counts[i])
            # the accepted share (all ancillas 0) within 5 binomial sigma
            n = max(v for c in C for v in c) + 1
            delta = want[: 1 << n].sum()
            acc = sum(v for k, v in counts[i].items() if int(k, 2) < 1 << n)
            sigma = np.sqrt(delta * (1 - delta) / SV_SHOTS)
            assert abs(acc / SV_SHOTS - delta) <= 5 * sigma + 1e-9
            i += 1


def test_statevector_run_evaluates(sv_dir):
    results = run_eval.main([
        "--results", "result_statevector_0.1.json", "--scale", "0.1",
        "--res-root", str(sv_dir), "--kl", "--platform", "cpu"])
    assert len(results) == 7
    for r in results:
        assert r.mean_f >= 0.99, (r.graph, r.mean_f)
        assert max(abs(a - b) for a, b in
                   zip(r.successes, r.exact_deltas)) <= 0.02


def test_statevector_run_is_deterministic_per_seed():
    suite = generate_suite(0.1)
    a = run_experiment.run_suite(suite, shots=200, engine="statevector",
                                 seed=5, device="cpu")
    b = run_experiment.run_suite(suite, shots=200, engine="statevector",
                                 seed=5, device="cpu")
    c = run_experiment.run_suite(suite, shots=200, engine="statevector",
                                 seed=6, device="cpu")
    assert a == b and a != c
    assert run_experiment.circuit_seed(5, 3) == 5 * 65536 + 3
