"""A configuration's structure: the chain and complete graphs as they
always read, the grid in the program's order, and a stated clique list as
given; and the seeded draws' streams as they always were."""

import hashlib
import json
import time

import pytest

from benchmark import harness, inputs

SPEC = harness.load_spec()

#: the 4x5 grid's edges: for each cell row-major, right, then below
GRID_4X5 = [
    (0, 1), (0, 5), (1, 2), (1, 6), (2, 3), (2, 7), (3, 4), (3, 8), (4, 9),
    (5, 6), (5, 10), (6, 7), (6, 11), (7, 8), (7, 12), (8, 9), (8, 13),
    (9, 14), (10, 11), (10, 15), (11, 12), (11, 16), (12, 13), (12, 17),
    (13, 14), (13, 18), (14, 19), (15, 16), (16, 17), (17, 18), (18, 19)]


def config(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    return harness.load_json(harness.ROOT / entry["file"])


def test_chain15_reads_its_fourteen_edges():
    assert inputs.cliques(config("chain15")) == [
        (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8),
        (8, 9), (9, 10), (10, 11), (11, 12), (12, 13), (13, 14)]


def test_k27_reads_its_351_pairs_in_order():
    cl = inputs.cliques(config("k27"))
    assert len(cl) == 351 and cl[:3] == [(0, 1), (0, 2), (0, 3)]
    assert cl[-2:] == [(24, 26), (25, 26)]
    digest = hashlib.sha256(json.dumps(cl).encode()).hexdigest()
    assert digest == ("55d7973283757d8f7e68e361f34eb6dd"
                      "cec502c9cee3620384d0a5b0489a9133")


def test_grid20_is_the_4x5_grid_in_the_programs_order():
    from qcmrf_tpu_torch.models.mrf import grid_cliques

    cfg = config("grid20")
    cl = inputs.cliques(cfg)
    assert cl == GRID_4X5 and len(cl) == cfg["cliques"]
    assert cl == [tuple(C) for C in grid_cliques(4, 5)]
    assert inputs.dimension(cl) == 124


@pytest.mark.parametrize("rows,cols", [(1, 4), (2, 3), (3, 3)])
def test_small_grids_follow_the_programs_order(rows, cols):
    from qcmrf_tpu_torch.models.mrf import grid_cliques

    cl = inputs.cliques({"graph": "grid", "rows": rows, "cols": cols,
                         "n": rows * cols})
    assert cl == [tuple(C) for C in grid_cliques(rows, cols)]


def test_a_grid_of_another_size_than_n_is_refused():
    with pytest.raises(ValueError):
        inputs.cliques({"graph": "grid", "rows": 4, "cols": 5, "n": 21})


def test_a_stated_clique_list_is_the_structure():
    stated = [[3, 1], [0, 2], [4], [1, 2, 4]]
    cfg = {"graph": "chain", "n": 5, "cliques": stated}
    assert inputs.cliques(cfg) == [(3, 1), (0, 2), (4,), (1, 2, 4)]
    # a number under ``cliques`` is only the count
    assert inputs.cliques({"graph": "chain", "n": 3, "cliques": 9}) == [
        (0, 1), (1, 2)]


@pytest.mark.parametrize("bad", [[[0, 0]], [[1, 5]], [[-1, 2]], [[]],
                                 [[0, 1.0]], [3]])
def test_a_stated_clique_that_is_not_a_set_of_variables_raises(bad):
    with pytest.raises(ValueError):
        inputs.cliques({"n": 5, "cliques": bad})


def test_stated_cliques_run_through_the_shots_loop(small):
    # a structure neither chain, complete nor grid, unary clique included,
    # from the configuration alone
    cfg, mix = small("grid20.shots")
    cfg = {**cfg, "n": 5,
           "cliques": [[0, 1], [1, 2], [0, 2], [2, 3], [3, 4], [4]]}
    out = harness.run_cell(SPEC, "grid20.shots", 2 << 40, 0.3, False, "cpu",
                           time.perf_counter(), config=cfg, mix=mix)
    assert out["correct"] is True, out["checks"]


def test_the_seeded_streams_are_as_they_were():
    assert inputs.PURPOSES == ("theta", "data", "order", "sample", "start",
                               "warm")
    seed = 20260917 + (1 << 33)
    assert [inputs.seed_words(seed, p) for p in inputs.PURPOSES] == [
        6622034225527734259, 858829660132881046, 7756365027577047413,
        5805280326076164726, 4652098595078442166, 2472708395078569977]
