"""Small sizes of the benchmark's cells, for tests on the CPU."""

import pytest

from benchmark import harness

#: each cell's configuration and mix, cut to a size a CPU test holds
SMALL = {
    "chain15.shots": ({"graph": "chain", "n": 6},
                      {"shots_per_call": 1 << 14, "checked_calls": 4}),
    "chain15.circuit": ({"graph": "chain", "n": 6}, {"checked_calls": 4}),
    "k27.infer": ({"graph": "complete", "n": 8},
                  {"checked_per_kind": 3}),
    "k27.train": ({"graph": "complete", "n": 8},
                  {"samples": 100, "steps_per_read": 5}),
    "grid20.shots": ({"graph": "grid", "rows": 2, "cols": 3, "n": 6},
                     {"shots_per_call": 1 << 14, "checked_calls": 4}),
}


@pytest.fixture
def small():
    """``small(workload) -> (config, mix)`` at a CPU test's size."""
    spec = harness.load_spec()

    def make(workload):
        _, cfg, mix = harness.cell_inputs(spec, workload)
        c, m = SMALL[workload]
        return {**cfg, **c}, {**mix, **m}

    return make
