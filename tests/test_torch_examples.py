"""Smoke-run the port's example walkthroughs (``qcmrf_tpu_torch/examples``)
at reduced sizes on the CPU, mirroring tests/test_examples.py: each script
honours ``QCMRF_EXAMPLE_SMOKE`` and exits 0 within 240 s; example 05
writes its whisker PDF into the temporary directory it is given;
``fit_physical.py --help`` runs (the repository holds no hardware tables
to fit); no example imports JAX or the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "qcmrf_tpu_torch",
                         "examples")
SCRIPTS = ["01_build_and_sample.py", "02_reference_suite.py",
           "03_large_scale_sharded.py", "04_training.py",
           "05_hardware_emulation.py", "06_wide_structure_training.py",
           "07_inference_serving.py", "08_structure_learning.py",
           "09_past_caps_ais.py", "fit_physical.py"]


def run(name, *args, smoke=True, tmpdir=None):
    env = dict(os.environ)
    if smoke:
        env["QCMRF_EXAMPLE_SMOKE"] = "1"
    if tmpdir is not None:
        env["TMPDIR"] = str(tmpdir)
    return subprocess.run(
        [sys.executable, os.path.join(_EXAMPLES, name), *args],
        env=env, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize(
    "name,output",
    [
        ("01_build_and_sample.py", None),
        ("02_reference_suite.py", None),
        ("03_large_scale_sharded.py", None),
        ("04_training.py", None),
        ("05_hardware_emulation.py", "torch_success_torino.pdf"),
        ("06_wide_structure_training.py", None),
        ("07_inference_serving.py", None),
        ("08_structure_learning.py", None),
        ("09_past_caps_ais.py", None),
    ],
)
def test_example_smoke(name, output, tmp_path):
    """Each script in its own temporary directory (``TMPDIR``), where an
    output file named in the case must appear."""
    r = run(name, tmpdir=tmp_path)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    if output:
        assert (tmp_path / output).exists(), f"{name} did not write {output}"


def test_fit_physical_help():
    r = run("fit_physical.py", "--help", smoke=False)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--res-root" in r.stdout


def test_examples_import_neither_jax_nor_the_jax_package():
    """Every script's imports, read from its source: none names ``jax``
    or ``qcmrf_tpu`` (the port's examples run where JAX is not installed),
    and every one of the JAX package's examples has a port."""
    jax_examples = os.path.join(os.path.dirname(__file__), "..", "examples")
    assert sorted(f for f in os.listdir(jax_examples)
                  if f.endswith(".py")) == sorted(SCRIPTS)
    for name in SCRIPTS:
        with open(os.path.join(_EXAMPLES, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "qcmrf_tpu", "optax"), (name, m)


def test_examples_refuse_a_missing_card():
    """Without the smoke mode an example runs on the card: where PyTorch
    sees none it exits non-zero, naming CUDA (no fallback to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    r = run("01_build_and_sample.py", smoke=False)
    assert r.returncode != 0 and "CUDA" in r.stderr
