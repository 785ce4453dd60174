"""``python -m qcmrf_tpu_torch train``: fit an MRF by exact MLE, with
checkpoint/resume (port of :mod:`qcmrf_tpu.runners.train_cli`, same
flags, errors and output).

    python -m qcmrf_tpu_torch train --graph chain:8 --samples 20000 --steps 500

Loads (or samples) data, fits theta by gradient descent on the exact NLL,
checkpoints ``{raw, optimizer state, step}`` with ``torch.save`` into
numbered step directories ``<outdir>/ckpt/<step>/`` (written under a
temporary name and renamed into place; the newest 2 kept), and writes the
fitted model as ``fitted_model.json`` (``cliques``, ``theta``,
``final_nll``; ``structure`` with ``--learn-structure``) beside
``train_config.json``. ``--resume`` picks up at the newest step.

Routes: state-id data up to n = 30 (``QCMRF_BIG_N_THRESHOLD``) trains the
mean NLL (enumeration to n = 22, then elimination or the streaming fused
sweep), ``--grad shots`` takes the model moments from post-selected
circuit shots (the sampler kernel), bit-array data past the threshold
trains on its sufficient statistics (:func:`models.train.
make_moment_train_step`), ``--grad ais`` takes the model moments from
annealed importance sampling at any size (one launch of the chain
kernel's AIS mode a step, ESS-gated; ``fitted_model.json`` then holds
``final_ess`` and ``ais_skipped_steps`` in place of ``final_nll``), and
``--learn-structure`` selects the clique set by group-lasso MLE first
(:mod:`models.structure`). The shot and AIS gradients draw step s on the
Philox keys ``(data_seed + 1, s)`` and ``(data_seed + 2, s)``: a resumed
run continues their streams.

``--platform default`` means the card, as for ``run`` and ``infer``: the
JAX package's "small fits go to the host" is not carried over.
Without ``--data`` the CLI draws its data from a random ground-truth
model: ``sample_exact`` up to n = 22, one Gibbs chain (thin 10, burn 100,
the chain kernel) past it; past the threshold, as bit arrays, elimination's
perturb-and-MAP, or the chain where the structure is wider than the
elimination cap.

``--mesh AxB`` builds a 2-D ``(amp, data)`` mesh of A * B devices
(``sharded.mesh_from_spec``): the exact NLL step up to the threshold
shards lnZ over ``amp`` and the batch over ``data``
(``make_sharded_train_step``; a batch that does not split over ``data``
loses its tail, with a warning); the wide moment step and structure
learning shard their streaming sweep over every device; ``--grad shots``
its draws and ``--grad ais`` its chains.
Elimination training is single-device and refuses ``--mesh``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
from typing import List, Optional

import numpy as np

from qcmrf_tpu_torch.models.mrf import grid_cliques
from qcmrf_tpu_torch.utils.config import (dump_effective_config,
                                          parse_with_config, resolve_platform)

#: a checkpoint's file in its step directory
CKPT_FILE = "state.pt"
#: step directories kept
CKPT_KEEP = 2


def parse_graph(spec: str):
    """'chain:N' | 'grid:RxC' | path to a JSON [[...], ...] clique list.
    Host-side only: no model and no device is touched."""
    if spec.startswith("chain:"):
        n = int(spec.split(":")[1])
        return [[i, i + 1] for i in range(n - 1)]
    if spec.startswith("grid:"):
        r, c = spec.split(":")[1].split("x")
        return grid_cliques(int(r), int(c))
    with open(spec) as f:
        return json.load(f)


def _steps_saved(ckpt: str) -> List[int]:
    """Numbered step directories under ``ckpt``, ascending."""
    if not os.path.isdir(ckpt):
        return []
    return sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()
                  and os.path.isdir(os.path.join(ckpt, d)))


def _save(ckpt: str, step: int, raw, optimizer) -> None:
    """Write ``<ckpt>/<step>/state.pt`` under a temporary name, rename it
    into place, and keep the newest ``CKPT_KEEP`` step directories of this
    format (another format's directories are never touched)."""
    import torch

    final = os.path.join(ckpt, str(step))
    tmp = os.path.join(ckpt, f".{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)  # and ckpt itself
    torch.save({"raw": raw.detach().cpu(),
                "optimizer": optimizer.state_dict(), "step": step},
               os.path.join(tmp, CKPT_FILE))
    if os.path.isdir(final):
        if not os.path.isfile(os.path.join(final, CKPT_FILE)):
            raise SystemExit(f"{final} holds a checkpoint of another format "
                             "(an orbax step directory of the JAX package); "
                             "move it away or pick another --outdir")
        shutil.rmtree(final)
    os.replace(tmp, final)
    ours = [s for s in _steps_saved(ckpt)
            if os.path.isfile(os.path.join(ckpt, str(s), CKPT_FILE))]
    for s in ours[:-CKPT_KEEP]:
        shutil.rmtree(os.path.join(ckpt, str(s)))


def _restore(ckpt: str, step: int, raw, optimizer) -> int:
    """Load step ``step`` into ``raw`` and ``optimizer``; returns the step.
    A step directory without the port's file is refused."""
    import torch

    path = os.path.join(ckpt, str(step), CKPT_FILE)
    if not os.path.isfile(path):
        raise SystemExit(
            f"{os.path.join(ckpt, str(step))} is not a checkpoint of this "
            f"package (no {CKPT_FILE}: an orbax checkpoint of the JAX "
            "package?); it cannot be resumed here. Resume it with the JAX "
            "package, or delete it to restart from scratch.")
    state = torch.load(path, map_location=raw.device, weights_only=True)
    with torch.no_grad():
        raw.copy_(state["raw"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(prog="qcmrf_tpu_torch train")
    parser.add_argument("--graph", type=str, default="chain:6")
    parser.add_argument("--samples", type=int, default=20_000)
    parser.add_argument("--data", type=str, default=None,
                        help="JSON list of observed state ids, or past the "
                             "big-n threshold of per-sample bit lists (else "
                             "sampled from a random ground-truth model)")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--lr", type=float, default=0.05)
    # dest distinct from the config's suite seed: this seed drives data
    # generation and the shot and AIS gradients only
    parser.add_argument("--data-seed", "--seed",
                        dest="data_seed", type=int, default=0)
    parser.add_argument("--outdir", type=str, default="./train_out")
    parser.add_argument("--checkpoint-every", type=int, default=100)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--grad", type=str, default="exact",
                        choices=["exact", "shots", "ais"],
                        help="model-moment term of the NLL gradient: "
                             "exact inference, post-selected circuit "
                             "shots (quantum-in-the-loop training), or "
                             "annealed-importance-sampling moments, the "
                             "route past both exact backends (induced "
                             "width > elimination cap and n > streaming "
                             "cap)")
    parser.add_argument("--grad-shots", type=int, default=1 << 14,
                        help="shots per step for --grad shots")
    parser.add_argument("--ais-chains", type=int, default=256,
                        help="--grad ais: importance chains per step")
    parser.add_argument("--ais-temps", type=int, default=64,
                        help="--grad ais: annealing rungs per step (raise "
                             "under strong coupling or a low ESS)")
    parser.add_argument("--ais-ess-frac", type=float, default=0.1,
                        help="--grad ais: skip a step whose effective "
                             "sample size falls below this fraction of "
                             "--ais-chains (collapsed weights give "
                             "noise-dominated gradients)")
    parser.add_argument("--mesh", type=str, default=None,
                        help="run on an AxB (amp=A, data=B) device mesh; "
                             "with --grad shots, all A*B devices share the "
                             "shots")
    parser.add_argument("--platform", type=str, default="default",
                        choices=["cpu", "gpu", "default"],
                        help="'default' means 'gpu' at every size (the JAX "
                             "package's default sends small fits to the "
                             "host; the port does not); both raise where "
                             "PyTorch sees no CUDA device")
    parser.add_argument("--learn-structure", action="store_true",
                        help="select the clique structure itself by "
                             "group-lasso MLE over --candidates before "
                             "the final fit (models/structure.py); "
                             "--graph then only sets n and the synthetic "
                             "ground truth")
    parser.add_argument("--candidates", type=str, default="pairs",
                        help="'pairs' (all n*(n-1)/2 edges) or a JSON "
                             "clique-list path; size >= 2 only")
    parser.add_argument("--l1", type=float, default=0.02,
                        help="group-lasso strength for --learn-structure")
    parser.add_argument("--prune-tol", type=float, default=0.05,
                        help="absolute interaction-norm prune cut")
    args = parse_with_config(parser, argv)

    # ---- host-side routing and refusals, before any device -------------
    from qcmrf_tpu_torch.models import capability, elimination

    cliques = parse_graph(args.graph)
    n = 1 + max(v for C in cliques for v in C)
    big = n > capability.big_n_threshold()
    wide = big and (elimination.induced_width(cliques, n)
                    > capability.ELIM_WIDTH_CAP)
    max_n = capability.STREAMING_MAX_N
    if wide and n > max_n and args.grad != "ais":
        raise SystemExit(
            f"n={n} with induced width past the elimination cap needs the "
            f"streaming sweep, which tops out at n={max_n} (the JAX "
            "package's int32 block ids) — pass --grad ais to train on AIS "
            "moment estimates (ESS-gated, no structural cap)")
    if (big and args.mesh and not wide and args.grad != "ais"
            and not args.learn_structure):
        # structure learning is exempt: its width is the candidate
        # template's, whose selection sweep shards when that is wide
        raise SystemExit("--mesh is for the enumerated state table "
                         "(n <= 30), wide structures (streaming sweep), "
                         "or --grad ais (sharded chains); elimination "
                         "training is single-device")
    if big and args.grad == "shots":
        raise SystemExit("--grad shots needs the circuit sampler's int32 "
                         f"state ids (n <= {capability.CIRCUIT_SAMPLER_MAX_N})")
    if args.learn_structure and args.grad != "exact":
        raise SystemExit("--learn-structure selects by the exact NLL "
                         "gradient (--grad exact); shots/ais gradients "
                         "serve fixed structures")

    device = resolve_platform(args.platform)
    import torch

    from qcmrf_tpu_torch.models import sample as msample
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.parallel import sharded

    template = MRF.create(cliques, device=device)
    mesh = (sharded.mesh_from_spec(args.mesh, device) if args.mesh
            else None)
    os.makedirs(args.outdir, exist_ok=True)
    dump_effective_config(args, os.path.join(args.outdir, "train_config.json"))

    rng = np.random.RandomState(args.data_seed)
    if args.data:
        with open(args.data) as f:
            loaded = json.load(f)
        if big:
            data = np.asarray(loaded, np.uint8)
            if data.ndim != 2 or data.shape[1] != n:
                raise SystemExit(
                    f"--data for n={n} > {capability.big_n_threshold()} "
                    f"must be a JSON list of {n}-bit arrays (one list of "
                    f"0/1 per sample); got shape {data.shape}")
        else:
            data = torch.as_tensor(loaded, dtype=torch.int64, device=device)
    elif big:
        # ground truth at large n, as bit arrays: elimination's
        # perturb-and-MAP for bounded width; a wide structure takes the
        # bit-array Gibbs chain (approximate: pass --data where exactness
        # matters)
        true = template.with_theta(
            -np.abs(rng.randn(template.dimension)).astype(np.float32))
        if wide:
            data = msample.sample_gibbs_bits(args.data_seed, true,
                                             args.samples, thin=10, burn=100)
        else:
            data = elimination.sample_pam(args.data_seed, true, args.samples)
        data = data.cpu().numpy().astype(np.uint8)
        with open(os.path.join(args.outdir, "data.json"), "w") as f:
            json.dump(data.tolist(), f)
    else:
        true = template.with_theta(
            -np.abs(rng.randn(template.dimension)).astype(np.float32))
        if n > 22:
            # no 2^n table at this size: one Gibbs chain, thinned by 10
            data = msample.sample_gibbs(args.data_seed, true, args.samples,
                                        thin=10, burn=100)
        else:
            data = msample.sample_exact(args.data_seed, true, args.samples)
        with open(os.path.join(args.outdir, "data.json"), "w") as f:
            json.dump(data.cpu().tolist(), f)

    if args.learn_structure:
        from qcmrf_tpu_torch.models import structure as mstruct

        if args.candidates == "pairs":
            cands = mstruct.candidate_pairs(n)
        else:
            with open(args.candidates) as f:
                cands = json.load(f)
        try:
            fit = mstruct.fit_structure(
                cands, data, n, lam=args.l1, steps=args.steps,
                learning_rate=args.lr, prune_tol=args.prune_tol,
                mesh=mesh, device=device)
        except ValueError as e:
            # the lnZ router's past-both-caps refusal, as a clean CLI error
            raise SystemExit(str(e))
        out_path = os.path.join(args.outdir, "fitted_model.json")
        with open(out_path, "w") as f:
            json.dump(
                {"cliques": [list(C) for C in fit.mrf.cliques],
                 "theta": fit.mrf.theta.cpu().double().tolist(),
                 "final_nll": fit.nll,
                 "structure": {
                     "selected": fit.selected,
                     "candidates": [list(C) for C in cands],
                     "interaction_norm": fit.group_norm.tolist(),
                     "template_cliques": fit.cliques,
                     "threshold": fit.threshold,
                     "l1": args.l1,
                 }},
                f, indent=2)
        print(f"selected {len(fit.selected)}/{len(cands)} candidates "
              f"(cut {fit.threshold:.4g}); wrote {out_path}")
        return out_path

    raw = mtrain._from_theta(
        torch.full((template.dimension,), -0.5, device=device),
        True).requires_grad_()
    opt = mtrain.adam([raw], args.lr)
    start = 0
    ckpt = os.path.abspath(os.path.join(args.outdir, "ckpt"))
    legacy = os.path.join(args.outdir, "checkpoint.npz")
    saved = _steps_saved(ckpt)
    if args.resume and not saved and os.path.isfile(legacy):
        raise SystemExit(
            f"{legacy} is a legacy pickle checkpoint from a previous "
            "version; it cannot be resumed by this format. Delete it "
            "(restarting from scratch) or re-run the old version to "
            "completion.")
    if args.resume and saved:
        start = _restore(ckpt, saved[-1], raw, opt)
        print(f"resumed from step {start}")

    loss_label = "nll"
    ais_skips = 0
    if args.grad == "ais":
        # the model moments from AIS: the one gradient with no structural
        # cap; the data term is the data's sufficient statistics
        from qcmrf_tpu_torch.evaluation.estimators import (
            clique_marginals_from_samples)

        mu_hat = (mtrain.empirical_moments_from_bits(template, data) if big
                  else clique_marginals_from_samples(template, data))
        ais_step = mtrain.make_ais_train_step(
            template, opt, mu_hat, num_chains=args.ais_chains,
            num_temps=args.ais_temps, ess_min_frac=args.ais_ess_frac,
            mesh=mesh)
        loss_label = "ess"

        def step_fn(batch, s):
            nonlocal ais_skips
            # step s on the Philox key (data_seed + 2, s): a resumed run
            # continues the stream
            info = ais_step(args.data_seed + 2, s)
            if info["skipped"]:
                ais_skips += 1
                print(f"warning: AIS ESS {info['ess']:.1f} < "
                      f"{args.ais_ess_frac:.2f} * {args.ais_chains} — step "
                      "skipped (collapsed importance weights; raise "
                      "--ais-temps)", file=sys.stderr)
            return info["ess"]
    elif big:
        # a wide structure's streaming sweep shards over the flattened
        # mesh
        moment_step = mtrain.make_moment_train_step(
            template, opt, mtrain.empirical_moments_from_bits(template, data),
            mesh=mesh)

        def step_fn(batch, s):
            return moment_step()
    elif mesh is not None and args.grad != "shots":
        if data.shape[0] % mesh.shape["data"]:
            kept = data.shape[0] - data.shape[0] % mesh.shape["data"]
            print(f"warning: --mesh data axis {mesh.shape['data']} does not "
                  f"divide the {data.shape[0]} samples; training on the "
                  f"first {kept} (the dropped tail changes the objective "
                  "slightly vs a single-device fit)", file=sys.stderr)
            data = data[:kept]
            # the provenance records what was trained on
            args.effective_samples = kept
            dump_effective_config(
                args, os.path.join(args.outdir, "train_config.json"))
        train_step = mtrain.make_sharded_train_step(template, opt, mesh)

        def step_fn(batch, s):
            return train_step(batch)
    elif args.grad == "shots":
        from qcmrf_tpu_torch.evaluation.estimators import (
            clique_marginals_from_samples)

        if mesh is not None and args.grad_shots % mesh.size:
            raise SystemExit(f"--grad-shots ({args.grad_shots}) must be "
                             f"divisible by the mesh size ({mesh.size})")
        shots_step = mtrain.make_shots_train_step(
            template, opt, args.grad_shots,
            clique_marginals_from_samples(template, data), mesh=mesh)
        log2 = n * math.log(2.0)

        def step_fn(batch, s):
            with torch.no_grad():
                # the data term at the pre-update theta the shots use
                pre = template.with_theta(mtrain._to_theta(raw, True))
                data_term = float(template.beta
                                  * pre.log_potential(batch).mean())
            # step s draws on the Philox key (data_seed + 1, s): a resumed
            # run continues the stream instead of replaying it
            delta = shots_step(args.data_seed + 1, s)
            return math.log(max(delta, 1e-300)) + log2 - data_term
    else:
        train_step = mtrain.make_train_step(template, opt)

        def step_fn(batch, s):
            return train_step(batch)

    loss = float("nan")
    for s in range(start, args.steps):
        loss = step_fn(data, s)
        if (s + 1) % args.checkpoint_every == 0 or s + 1 == args.steps:
            _save(ckpt, s + 1, raw, opt)
            print(f"step {s + 1}: {loss_label}={float(loss):.4f} "
                  "(checkpointed)")

    theta = mtrain._to_theta(raw, True).detach()
    out_path = os.path.join(args.outdir, "fitted_model.json")
    out_doc = {"cliques": cliques, "theta": theta.cpu().double().tolist()}
    if args.grad == "ais":
        # no exact NLL exists in this regime: the estimator's health instead
        out_doc["final_ess"] = float(loss)
        out_doc["ais_skipped_steps"] = ais_skips
    else:
        out_doc["final_nll"] = float(loss)
    with open(out_path, "w") as f:
        json.dump(out_doc, f, indent=2)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main(sys.argv[1:])
