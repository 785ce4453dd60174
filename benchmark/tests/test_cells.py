"""Every cell is described by its own files: its configuration and traffic
files carry their CPU-test sizes under ``small``, its loop module its
``FAULTS`` and ``control``; the tests' fixtures and ``control.py`` keep no
table keyed by a cell's, configuration's, mix's or loop's name, so that a
cell can come from new files and ``BENCHMARK.json`` entries alone."""

from pathlib import Path

import pytest

from benchmark import control, harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
HERE = Path(__file__).resolve().parent


@pytest.mark.parametrize("workload", CELLS)
def test_each_cells_files_carry_what_its_tests_need(workload):
    _, cfg, mix = harness.cell_inputs(SPEC, workload)
    # each overrides keys its file has, at a CPU test's size
    for data in (cfg, mix):
        assert data["small"] and set(data["small"]) <= set(data)
    assert set(mix.get("small_control", {})) <= set(mix)
    module = harness.load_module("loops", mix["loop"])
    assert callable(module.control)
    assert module.FAULTS
    assert all(callable(f) for f in module.FAULTS.values())


def test_no_table_is_keyed_by_a_cell_or_a_loop():
    names = {mix["loop"] for _, _, mix in
             (harness.cell_inputs(SPEC, w) for w in CELLS)}
    for w in SPEC["workloads"]:
        names |= {w["name"], w["config"], w["traffic"]}
    for path in (HERE / "conftest.py", Path(control.__file__)):
        text = path.read_text()
        for name in names:
            assert f'"{name}"' not in text and f"'{name}'" not in text, \
                (path.name, name)
    assert "SMALL" not in (HERE / "conftest.py").read_text()
    assert "CONTROL_MIX" not in (HERE / "test_control.py").read_text()
    assert not hasattr(control, "FAULTS")
    assert not hasattr(control, "CONTROLS")
