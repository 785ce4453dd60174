"""The port's scaling runner (``qcmrf_tpu_torch.runners.scaling``) and the
sharded estimates at n = 24 on ``Mesh((cpu,) * 8)``, mirroring
tests/test_scaling.py: the same grid models (theta = -|randn(0)| * 0.1),
JAX's bars, the runner's lnZ against the JAX package's exact lnZ within
1e-4, and a ``--gate-level`` run at n = 14."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from qcmrf_tpu.models.mrf import grid_mrf as jgrid_mrf  # noqa: E402

from qcmrf_tpu_torch.models.mrf import grid_mrf  # noqa: E402
from qcmrf_tpu_torch.parallel import sharded  # noqa: E402
from qcmrf_tpu_torch.runners import scaling  # noqa: E402


def theta_of(template):
    rng = np.random.RandomState(0)
    return -np.abs(rng.randn(template.dimension)).astype(np.float32) * 0.1


@pytest.mark.slow
def test_n24_sharded_estimation():
    mrf = grid_mrf(4, 6, device="cpu")  # n=24, K=38
    mrf = mrf.with_theta(torch.from_numpy(theta_of(mrf)))
    mesh = sharded.make_mesh(8, device="cpu")
    lnZ = float(sharded.sharded_log_partition(mrf, mesh))
    assert np.isfinite(lnZ)
    # shot-based estimate of lnZ via the post-selection success rate
    x, acc = sharded.sharded_sample_postselected(0, mrf, mesh, 1 << 18)
    delta = float(acc.float().mean())
    lnZ_hat = np.log(delta) + mrf.n * np.log(2.0)
    assert abs(lnZ_hat - lnZ) < 0.05
    # accepted samples concentrate on higher-potential states than
    # rejected ones (Gibbs reweighting sanity)
    lp = mrf.log_potential(x.long())
    assert float(lp[acc].mean()) > float(lp[~acc].mean())


def exact_lnz(rows, cols):
    jm = jgrid_mrf(rows, cols)
    return float(jm.with_theta(jnp.asarray(theta_of(jm))).log_partition())


@pytest.mark.parametrize("n,rows,cols,gate_level", [(24, 4, 6, False),
                                                    (14, 2, 7, True)])
def test_scaling_runner_cli(n, rows, cols, gate_level):
    """JAX's runner test (n = 24 on 8 devices, one estimation of 2^16
    shots: lnZ_abs_err < 0.1), the exact lnZ within 1e-4 of the JAX
    package's; at n = 14 with ``--gate-level``: the chain circuit of 14
    qubits through the sharded engine, its norm within 1e-4 and at least
    one exchange."""
    argv = ["--n", str(n), "--devices", "8", "--estimations", "1",
            "--shots", str(1 << 16), "--json", "--platform", "cpu"]
    out = scaling.main(argv + (["--gate-level"] if gate_level else []))
    assert out["n"] == n and out["devices"] == 8
    assert out["backend"] == "cpu"
    assert out["lnZ_abs_err"] < 0.1
    assert abs(out["lnZ"] - exact_lnz(rows, cols)) < 1e-4
    if gate_level:
        assert out["gate_level_qubits"] == 14
        assert out["gate_level_norm_err"] < 1e-4
        assert out["gate_level_remaps"] >= 1


def test_scaling_runner_refuses_a_missing_card():
    """``--platform default`` means the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling.main(["--n", "12", "--json"])
