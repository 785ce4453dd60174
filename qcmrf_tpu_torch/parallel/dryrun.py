"""The multi-device dry run on a mesh the caller builds (the PyTorch
counterpart of ``__graft_entry__.py``'s ``_dryrun_impl``).

    from qcmrf_tpu_torch.parallel import dryrun, sharded
    dryrun.dryrun_multichip(sharded.Mesh((torch.device("cuda", 0),) * 4))

One process drives every device of the mesh (a device may repeat:
``Mesh((cpu,) * 8)`` on the host, four shards of one card on a single
GPU). It runs the JAX dry run's five parts and raises where JAX asserts:

1. one sharded exact training step on the 2-D ``(amp, data)`` view of the
   mesh (a finite loss);
2. the sharded lnZ against the exact lnZ (1e-3);
3. the sharded streaming MAP against the table's argmax;
4. AIS over the mesh inside JAX's bracket ``[n ln 2 + sum of the blocks'
   minima, n ln 2]``;
5. ``sharded_outcome_probs`` of a 3-variable chain's QCMRF circuit (6
   qubits: its ancilla gates act on device bits for any mesh up to 8
   shards, so the qubit exchanges run) against the dense engine (1e-5).

The mesh must hold a power-of-two number of devices: the training
step's amp axis and the sweeps refuse any other (JAX's dry run also runs
parts 2-5 on power-of-two meshes only).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def dryrun_multichip(mesh) -> dict:
    """Run the dry run's parts on ``mesh`` (a
    :class:`qcmrf_tpu_torch.parallel.sharded.Mesh`); returns what each
    part measured, raising where a check fails."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.models import ais
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.parallel import sharded
    from qcmrf_tpu_torch.sim import dense

    devs = mesh.devices
    D = len(devs)
    shape = (D // 2, 2) if D >= 4 and D % 2 == 0 else (D, 1)
    mesh2 = sharded.Mesh(devs, ("amp", "data"), shape)
    dev = devs[0]
    out = {"devices": D, "mesh": shape}

    # 1) the sharded training step: lnZ's sweep over the amp axis, the
    #    batch's log-potential over the data axis (a chain of 8: 256
    #    states, divisible by any power-of-two amp axis)
    cliques = [[i, i + 1] for i in range(7)]
    probe = MRF.create(cliques, device="cpu")
    theta = -np.abs(np.random.RandomState(1).randn(probe.dimension))
    mrf = MRF.create(cliques, theta=theta.astype(np.float32), device=dev)
    gen = torch.Generator().manual_seed(2)
    data = torch.randint(0, mrf.num_states, (64,), generator=gen)
    raw = mtrain._from_theta(mrf.theta, True).requires_grad_()
    step = mtrain.make_sharded_train_step(mrf, mtrain.adam([raw], 0.05),
                                          mesh2)
    loss = float(step(data))
    _check(math.isfinite(loss), f"sharded training step loss {loss}")
    out["train_loss"] = loss

    mesh1d = sharded.Mesh(devs, ("amp",))
    # 2) the sharded exact lnZ
    lnz = float(sharded.sharded_log_partition(mrf, mesh1d))
    lnz_ref = float(mrf.log_partition())
    _check(abs(lnz - lnz_ref) < 1e-3, f"sharded lnZ {lnz} vs {lnz_ref}")
    out["lnZ"], out["lnZ_exact"] = lnz, lnz_ref

    # 3) the sharded streaming MAP against the table's argmax
    sid, _ = sharded.sharded_map_state(mrf, mesh1d)
    best = int(torch.argmax(mrf.beta * mrf.all_log_potentials()))
    _check(sid == best, f"sharded MAP id {sid} vs the table's {best}")
    out["map_id"] = sid

    # 4) AIS chains split over the mesh, inside the bracket of theta <= 0
    lnz_ais = float(ais.ais_log_partition(5, mrf, num_chains=8 * D,
                                          num_temps=8, mesh=mesh1d))
    ub = mrf.n * math.log(2.0)
    lb = ub + float(sum(theta[o:o + 4].min() for o in mrf.theta_offsets))
    _check(lb - 1e-3 <= lnz_ais <= ub + 1e-3,
           f"AIS lnZ {lnz_ais} outside [{lb}, {ub}]")
    out["ais_lnZ"] = lnz_ais

    # 5) the gate-level sharded engine through sharded_outcome_probs
    small = MRF.create([[0, 1], [1, 2]], theta=(-np.abs(
        np.random.RandomState(3).randn(8))).astype(np.float32), device=dev)
    circ = compile_qcmrf(small, with_measurements=False)
    _check((1 << (circ.num_qubits - 1)) >= D, "circuit too small")
    probs = sharded.gather(sharded.sharded_outcome_probs(circ, mesh1d),
                           dev)
    remaps = sharded.LAST_REMAP_COUNT
    _check(abs(float(probs.sum()) - 1.0) < 1e-5,
           f"outcome mass {float(probs.sum())}")
    ref = dense.simulate_probs(circ, device=dev)
    err = float((probs - ref).abs().max())
    _check(err <= 1e-5, f"sharded != dense ({err:.2e})")
    out.update(outcome_max_abs_err=err, outcome_remaps=remaps)
    return out
