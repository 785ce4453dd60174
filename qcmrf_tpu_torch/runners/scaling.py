"""Scaling run: synthetic grid MRFs of n = 24-31 variables on a device mesh
(port of :mod:`qcmrf_tpu.runners.scaling`).

Builds a grid MRF beyond the reference's 10-qubit ceiling, shards the
exact-inference sweep over the mesh, and repeatedly estimates the success
rate and ln Z from sharded circuit shots, reporting throughput as JSON.
With ``--gate-level`` it also runs the gate-level sharded engine
(targeted qubit exchanges) on a chain QCMRF circuit of about n qubits.

    python -m qcmrf_tpu_torch.runners.scaling --n 24 [--devices N]
        [--shots S] [--estimations K] [--gate-level] [--json]
        [--platform cpu|gpu|default]

``--devices N`` takes the first N visible cards and raises when fewer are
visible; on the CPU the host stands for any N. ``--platform default``
means the card. Seeds are ints where JAX takes keys; ``backend`` is the
card's name (``cpu`` on the host).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="qcmrf_tpu_torch scaling")
    parser.add_argument("--n", type=int, default=24,
                        help="target qubit count (grid rows*cols)")
    parser.add_argument("--devices", type=int, default=None)
    parser.add_argument("--shots", type=int, default=1 << 20)
    parser.add_argument("--estimations", type=int, default=5,
                        help="repeated-estimation iterations")
    parser.add_argument("--gate-level", action="store_true",
                        help="also run the sharded gate-level statevector "
                             "engine (targeted qubit exchanges) on a QCMRF "
                             "circuit of ~n qubits")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="default: the current CUDA device")
    args = parser.parse_args(argv)

    from qcmrf_tpu_torch.models.mrf import MRF, grid_mrf
    from qcmrf_tpu_torch.parallel import sharded
    from qcmrf_tpu_torch.utils.config import resolve_platform

    device = resolve_platform(args.platform)
    # exact factorization: rows x cols == n (a 1 x n grid is a chain), so
    # --n 25/26/27 really benchmark 25/26/27 qubits
    rows = next(r for r in range(int(np.sqrt(args.n)), 0, -1)
                if args.n % r == 0)
    cols = args.n // rows
    template = grid_mrf(rows, cols, device=device)
    rng = np.random.RandomState(0)
    mrf = template.with_theta(torch.from_numpy(
        -np.abs(rng.randn(template.dimension)).astype(np.float32) * 0.1)
        .to(device))
    mesh = sharded.make_mesh(args.devices, device=device)
    D = mesh.size

    out = {"n": mrf.n, "cliques": template.num_cliques, "devices": D,
           "backend": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
           "states": mrf.num_states,
           "state_table_mb": round(mrf.num_states * 4 / 1e6, 1)}

    # the sharded exact lnZ (one sweep, each shard's lse partials)
    t0 = time.perf_counter()
    lnZ = float(sharded.sharded_log_partition(mrf, mesh))
    out["lnZ"] = round(lnZ, 6)
    out["lnZ_first_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    for _ in range(3):
        sharded.sharded_log_partition(mrf, mesh)
    _sync(device)
    out["lnZ_ms"] = round((time.perf_counter() - t0) / 3 * 1e3, 2)

    # the repeated estimation: every round's shots counted in the sampler
    # kernel, shard d of round i on Philox stream i * D + d
    sharded.sharded_estimate_delta(99, mrf, mesh, args.shots,
                                   args.estimations)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    deltas = sharded.sharded_estimate_delta(
        0, mrf, mesh, args.shots, args.estimations).cpu().numpy()
    dt = (time.perf_counter() - t0) / args.estimations
    out["est_shots_per_sec"] = round(args.shots / dt)
    delta_hat = float(np.mean(deltas))
    out["delta_hat"] = delta_hat
    out["lnZ_hat"] = round(float(np.log(max(delta_hat, 1e-300))
                                 + mrf.n * np.log(2.0)), 6)
    out["lnZ_abs_err"] = round(abs(out["lnZ_hat"] - lnZ), 6)

    if args.gate_level:
        # a chain QCMRF circuit of width 2v == ~n qubits (v variables, v-1
        # ancillas, the workspace): the ancillas' H / X sandwich gates land
        # on device bits, driving the targeted exchanges
        from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf

        v = max(args.n // 2, 2)
        gl_template = MRF.create([[i, i + 1] for i in range(v - 1)],
                                 device=device)
        gl = gl_template.with_theta(torch.from_numpy(
            -np.abs(rng.randn(gl_template.dimension)).astype(np.float32)
            * 0.1).to(device))
        circ = compile_qcmrf(gl, with_measurements=False)
        # the first call includes the planner; the second hits the plan
        # cache (the same first / steady split as lnZ's)
        t0 = time.perf_counter()
        re, im = sharded.run_statevector_sharded(circ, mesh)
        norm = sum(float(r.double().square().sum()
                         + i_.double().square().sum())
                   for r, i_ in zip(re, im))
        out["gate_level_first_s"] = round(time.perf_counter() - t0, 3)
        del re, im
        t0 = time.perf_counter()
        re, im = sharded.run_statevector_sharded(circ, mesh)
        _sync(device)
        out["gate_level_qubits"] = circ.num_qubits
        out["gate_level_gates"] = len(circ.gates)
        out["gate_level_s"] = round(time.perf_counter() - t0, 3)
        out["gate_level_remaps"] = sharded.LAST_REMAP_COUNT
        out["gate_level_norm_err"] = abs(norm - 1.0)
        del re, im
        if abs(norm - 1.0) >= 1e-4:
            raise RuntimeError(f"sharded gate-level norm drifted: {norm}")

    if args.json:
        print(json.dumps(out))
    else:
        for k, val in out.items():
            print(f"{k:>20}: {val}")
    return out


if __name__ == "__main__":
    main()
