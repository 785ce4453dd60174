"""The port's multi-device dry run (``qcmrf_tpu_torch.parallel.dryrun``)
on meshes of the CPU device, mirroring tests/test_graft_entry.py's
``dryrun_multichip``: every part runs and passes JAX's checks, the
oracle comparison of the sharded outcome distribution included, and the
sharded lnZ within 1e-3 of the JAX package's exact lnZ of the same
model."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models.mrf import MRF as JMRF  # noqa: E402

from qcmrf_tpu_torch.parallel import dryrun, sharded  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("D", [2, 8])
def test_dryrun_multichip(D):
    out = dryrun.dryrun_multichip(sharded.Mesh((CPU,) * D))
    assert out["devices"] == D and math.isfinite(out["train_loss"])
    assert abs(out["lnZ"] - out["lnZ_exact"]) < 1e-3
    # the oracle comparison ran, through at least one qubit exchange
    assert out["outcome_max_abs_err"] <= 1e-5
    assert out["outcome_remaps"] >= 1
    jm = JMRF.create([[i, i + 1] for i in range(7)], theta=jnp.asarray(
        -np.abs(np.random.RandomState(1).randn(28)), jnp.float32))
    assert abs(out["lnZ"] - float(jm.log_partition())) < 1e-3


def test_dryrun_refuses_a_mesh_not_a_power_of_two():
    """Three devices: the training step's amp axis refuses the mesh
    before any part runs (JAX's dry run shards parts 2-5 only over
    power-of-two meshes)."""
    with pytest.raises(ValueError, match="power-of-two"):
        dryrun.dryrun_multichip(sharded.Mesh((CPU,) * 3))
