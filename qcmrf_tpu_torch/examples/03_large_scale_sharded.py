"""Beyond the reference's 10-qubit ceiling: sharded inference at n=24.

The reference caps at 10 qubits (SURVEY.md §5). This example runs a
2^24-state grid MRF with its sweep sharded over every visible card (a
mesh of one card on a single-GPU machine), and estimates ln Z two ways:

* exactly, with the sharded streaming logsumexp (each shard sweeps its
  block range through the lse kernel);
* from circuit shots, with the repeated-estimation sampler (ln Z-hat =
  ln delta-hat + n ln 2, every shot counted in the sampler kernel).

The PyTorch / CUDA port of ``examples/03_large_scale_sharded.py``. Its
smoke mode (``QCMRF_EXAMPLE_SMOKE``) runs an n=12 grid on a mesh of eight
shards of the CPU.

    python qcmrf_tpu_torch/examples/03_large_scale_sharded.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

SMOKE = bool(os.environ.get("QCMRF_EXAMPLE_SMOKE"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qcmrf_tpu_torch.models.mrf import grid_mrf  # noqa: E402
from qcmrf_tpu_torch.parallel import sharded  # noqa: E402

# every visible card, or eight shards of the host in smoke mode
mesh = sharded.make_mesh(8, device="cpu") if SMOKE else sharded.make_mesh()
dev = mesh.devices[0]
template = (grid_mrf(3, 4, device=dev) if SMOKE
            else grid_mrf(4, 6, device=dev))  # n=24, 38 edges
rng = np.random.RandomState(0)
mrf = template.with_theta(torch.from_numpy(
    -np.abs(rng.randn(template.dimension)).astype(np.float32) * 0.1).to(dev))

kind = "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
print(f"n={mrf.n} ({mrf.num_states} states, "
      f"{mrf.num_states * 4 / 1e6:.0f} MB table) on {mesh.size} "
      f"shard(s) of {kind}")

lnZ = float(sharded.sharded_log_partition(mrf, mesh))
print(f"exact   lnZ = {lnZ:.6f}")

shots = 1 << 14 if SMOKE else 1 << 20
deltas = sharded.sharded_estimate_delta(0, mrf, mesh, shots=shots,
                                        iters=5).cpu().numpy()
lnZ_hat = float(np.log(deltas.mean()) + mrf.n * np.log(2.0))
print(f"shot-estimated lnZ = {lnZ_hat:.6f} "
      f"(5 x {shots} shots, |err| = {abs(lnZ_hat - lnZ):.2e})")
assert abs(lnZ_hat - lnZ) < 0.1
