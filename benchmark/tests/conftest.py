"""Small sizes of the benchmark's cells, for tests on the CPU: each
configuration and traffic file carries its own under ``small``."""

import pytest

from benchmark import harness


def small_inputs(spec, workload):
    """A cell's (config, mix), each with its file's ``small`` keys
    merged over it: a size a CPU test holds."""
    _, cfg, mix = harness.cell_inputs(spec, workload)
    return {**cfg, **cfg["small"]}, {**mix, **mix["small"]}


@pytest.fixture
def small():
    """``small(workload) -> (config, mix)`` at a CPU test's size."""
    spec = harness.load_spec()
    return lambda workload: small_inputs(spec, workload)
