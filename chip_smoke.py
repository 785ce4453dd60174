"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``qcmrf_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version on the card at the main paths'
shapes, times both, and drives the port's main paths, each with the
kernels' launch counters reset just before it and read just after:

* ``run`` (analytic engine) samples the 70-circuit suite (scale 0.1,
  10 000 shots) and ``eval`` scores it, both on the GPU;
* ``run --engine statevector`` runs the 70 gate-level circuits through the
  whole-circuit kernel (one launch for the suite's 7 structures) and
  ``eval`` scores them;
* ``infer`` answers a batch of lnz, prob, map, mmap and marginals queries,
  with and without evidence, on bench.py's K27 complete graph (every
  query through the streaming lse, map and fused lnz_moments kernels, no
  moments launch), checked against the chain's log-potential table (the
  plain version on the card, independent of the table kernel), which
  also holds the table kernel's K27 table;
  a 32-variable chain's streaming MAP and lnZ (ids past 2^31) are held
  against elimination;
* the plane engine runs the 16-variable QCMRF chain at 32 qubits (three
  fused sandwich passes over 32 GiB of planes, in place), checked against
  the post-selected amplitudes of the log-potential kernel;
* the plane engine runs bench.py's 14-variable chain at 28 qubits lowered
  to the ``[cx, id, rz, sx, x]`` basis (``QCMRF.lowered``): about 2500
  diag, lane, row and sandwich passes, checked against the unlowered
  chain's state, global phase included; the unfused per-gate path and
  random circuits over the whole gate set are held against the fused
  stream and the dense engine at 20 qubits;
* ``train`` fits bench.py's K27 model for 5 steps through ``train_cli``
  on 20 000 ids drawn by ``sample_exact`` on the card, every gradient
  through the fused lnZ + moments kernel (one launch a step, each loss
  held against lnZ of the lse kernel); the K27 step is timed beside the
  lse + moments sweeps it replaces, the gradient held against the two
  sweeps' moments, and the table and elimination routes driven too;
* the copy and gate-pass rates at 28 qubits and the float32 FMA peak
  (``runners/bench.py``);
* AIS (phase ais) on the past-both-caps flagship of tests/test_ais.py, K27
  beside a disjoint 21-variable chain (n = 48): the chain kernel's AIS
  mode against its plain version at 256 chains x 96 rungs, lnZ, pooled
  marginals and 100 training steps at JAX's slow-pin bars against the
  blocks' exact targets, then ``infer --method ais`` (lnz, marginals,
  prob: one AIS launch each), ``train --grad ais`` with ``--resume`` (one
  a step) and ``eval --mode gibbs|pam --native`` (the C++ engine);
* noise emulation (phase noise): the density engine on the card against
  the same code on CPU tensors (1e-5), its batch of a graph's 10 reps
  against 10 single evolutions (1e-6) and its noiseless diagonal against
  the circuit kernel (1e-5), on every suite graph; ``run --engine
  noisy:torino`` and ``calibrated:torino`` (scale 0.1, 10 000 shots) then
  ``eval``, each graph's mean delta-hat within 0.02 of its expected mean
  acceptance, the logpot and lse launches of the calibrated path counted;
  ``whisker`` from the noisy files of the three scales; the width-10
  evolution timed alone and as a batch of 10 reps;
* the state-id offset of rows 2-7 (phase offset): on K27 and the n=28
  grid the table, lse, map, moments and fused sweeps split into 2 and 4
  ``x0_blocks`` ranges, the pieces concatenated ``torch.equal`` to the
  single sweep's outputs and the combined lnZ, MAP id and moments equal
  to its; each kernel against its plain version at a nonzero offset; a
  34-variable chain's lse and map over 2 and 4 ranges, ids past 2^33;
* the sharded sweeps (phase sharded, launches counted): every sweep and
  shot path of ``parallel/sharded.py`` on ``Mesh((cuda:0,) * 4)``, four
  shards on the one card, against the same call without a mesh (MAP ids
  equal, lnZ within 1e-5, moments 1e-6, PAM and AIS equal, shot
  estimates within 5 binomial sigma), then ``infer --mesh 2x2`` and
  ``train --mesh 2x2`` at the JAX pins' bars; times of one device and of
  the four shards, labelled as shards on one card;
* the gate-level sharded engine (phase gate sharded, launches counted):
  bench.py's qcmrf28 chain through ``run_statevector_sharded`` on one
  shard and on ``Mesh((cuda:0,) * 4)``, equal to the single-card plane
  engine within 1e-6; ``sharded_outcome_probs`` of a 14-qubit permuted
  wiring and a measured subset on four shards against
  ``planes.simulate_probs`` (1e-6); the 16-variable chain at 32 qubits on
  four shards (32 GiB of planes): norm 1e-4, accepted mass Z/2^n 1e-5,
  2^20 sampled amplitudes within 1e-6 of the single-card engine's; then
  ``parallel.dryrun.dryrun_multichip`` on the four shards, the times of
  both engines and of one exchange, and every port example at full size
  and ``scaling --n 28 --devices 1 --gate-level`` as subprocesses;
* ``python -m qcmrf_tpu_torch bench --json --trace`` in a subprocess and
  ``runners.bench.record()`` (phase bench), each printed as one JSON
  line, every key finite and record()'s keys BENCH_r05.json's less the
  ones the port leaves out (the two ``qcmrf{24,28}_sharded_gate_level_ms``
  printed beside ``qcmrf{24,28}_gate_level_ms`` as a ratio); the device
  busy and idle share
  (``profiling.device_busy``) of the headline sampler call, the K27 infer
  batch, a K27 ``train_cli`` step and the calibrated noise run.

The dense lane kernel (three TF32 products a term on the tensor cores)
is held to the float64 product of its input at widths 8, 24 and 28: a
relative 2-norm error of at most 2e-6 and at most 4x that of one float32
``torch.matmul`` on the same input, a check one TF32 pass fails.

The table, lse and both moments kernels evaluate states through the
block-invariant split: their bounds come from the split's operation
count (and for the table, its bytes), printed beside the per-state
chain's count; the table kernel equals its split plain version bit for
bit and lies within ``kernels.split_gap`` of the chain's table. The map kernel screens
states through the split and evaluates the chain at its candidates: its
bound counts both, beside the chain at every state. The sampler reads its
keep probabilities from a table: its bound counts Philox's integer
operations at the float32 rate (printed beside the chain design's
count, which left Philox out), and the phase counts the ancilla bits that
differ from the chain arithmetic of the JAX kernel on the same random
words.

Every failed check raises, so the exit code is non-zero. The
second-to-last line is a JSON object with one entry per kernel (its time,
its plain version's time and the least time the card could take for the
same work); the last line is ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where PyTorch sees no CUDA device.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SAMPLE_SEED = 1234
N_SHOTS_CHECK = 1 << 20      # kernel vs plain version, all four modes
N_SHOTS_RATE = 1 << 27       # bench.py's operating point: 1 GiB of outputs

# NVIDIA's data sheet, H100 SXM at its 700 W limit: device memory rate,
# float32 rate outside the tensor cores, dense TF32 rate of the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12
H100_TF32_PER_S = 494.7e12

GATE_WIDTHS = (20, 24, 26, 28, 30, 32)   # bench.py's chains, and 32
SANDWICH_WIDTH = 24
INFER_N = 27                             # bench.py's wide model, K27
GATE_PASS_WIDTH = 24     # the generic gate kernels against plain versions
LOWERED_WIDTH = 28       # bench.py's qcmrf28 chain, lowered: the main run
SMALL_WIDTH = 20         # the per-gate path and the random-circuit fuzz


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float operations over the float32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_PER_S * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def chain_flops(cliques) -> int:
    """Float operations of one Moebius-chain evaluation of every clique:
    the constant, then one product and one sum per non-empty subset."""
    return sum(1 + 2 * ((1 << len(C)) - 1) for C in cliques)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events
    around ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    print(f"  ok: {what}")


def grid_model(rows: int, cols: int, seed: int, dev):
    from qcmrf_tpu_torch.models.mrf import grid_mrf

    template = grid_mrf(rows, cols, device=dev)
    rng = np.random.RandomState(seed)
    theta = -np.abs(rng.randn(template.dimension)).astype(np.float32) * 0.3
    return template.with_theta(theta)


def philox_ops(K: int) -> int:
    """Integer operations of Philox4x32-10 a shot: 1 + K // 4 calls, each
    10 rounds of two 32x32 -> 64-bit products (low and high word, 4
    operations) and four XORs, and the key additions of rounds 1-9 (2
    each)."""
    return (1 + K // 4) * (10 * (4 + 4) + 9 * 2)


def lookup_ops(cliques) -> int:
    """Operations of the keep-probability lookup a shot, Philox aside: x's
    mask, then per clique the slot word (a shift, a mask and a merge a
    slot), the uniform's shift, the compare with the table's entry and the
    ancilla bit."""
    return 1 + sum(3 * len(C) + 3 for C in cliques)


def sass_instructions(path, kernel: str) -> dict:
    """Instructions of ``kernel`` (a mangled-name fragment) in the built
    library, from ``cuobjdump -sass``: its Philox loop (the innermost loop
    with wide multiplies: one call and four cliques an iteration) and the
    loop over shots around it, by opcode. Philox's share is its products
    (IMAD.WIDE.U32) and three-input XORs (LOP3.LUT 0x96); the rest is the
    lookup, the loop and the stores."""
    from qcmrf_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    body = text.split("Function : ")
    sass = next(f for f in body[1:] if kernel in f.splitlines()[0])
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loops = [(int(m.group(1), 16), a) for a, t in ins
             for m in [re.search(r"BRA (0x[0-9a-f]+)", t)]
             if m and int(m.group(1), 16) < a]

    def span(lo, hi):
        return [t for a, t in ins if lo <= a <= hi]

    def philox(ts):
        return sum("IMAD.WIDE.U32" in t or ("LOP3.LUT" in t and "0x96" in t)
                   for t in ts)

    def wide(ts):
        return sum("IMAD.WIDE.U32" in t for t in ts)

    inner = min((lp for lp in loops if wide(span(*lp)) >= 16),
                key=lambda lp: lp[1] - lp[0])
    outer = min((lp for lp in loops if lp[0] < inner[0]
                 and lp[1] > inner[1]), key=lambda lp: lp[1] - lp[0])
    a, b = span(*inner), span(*outer)
    return dict(inner=len(a), inner_philox=philox(a), outer=len(b),
                outer_philox=philox(b), inner_wide=wide(a))


def plain_sampler_shots(cliques, n, keep) -> int:
    """Largest power of two <= N_SHOTS_RATE whose plain-version run fits
    in 80% of the free device memory, scaled from a 2^20-shot run."""
    from qcmrf_tpu_torch.ops import sampler_kernel as sk

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sk.sample_call_reference(SAMPLE_SEED, cliques, n, keep,
                                   N_SHOTS_CHECK, "parts")
    del out
    per_shot = (torch.cuda.max_memory_allocated() - base) / N_SHOTS_CHECK
    free = torch.cuda.mem_get_info()[0]
    shots = N_SHOTS_RATE
    while shots > N_SHOTS_CHECK and per_shot * shots > 0.8 * free:
        shots //= 2
    return shots


def chain_flips(mrf, x, a, chunk=1 << 21) -> int:
    """Shots whose ancilla bits differ from the JAX kernel's arithmetic (c2
    as a Moebius chain, ``analytic.clique_keep_probs_fast``) on the same
    Philox words; every x must be the words' own and every differing bit
    must lie within 2 ulp of the chain's c2."""
    from qcmrf_tpu_torch.ops import sampler_kernel as sk
    from qcmrf_tpu_torch.sim import analytic

    flips, same_x, near = 0, True, True
    for lo in range(0, x.shape[1], chunk):
        xs, uniforms = sk.shot_uniforms(SAMPLE_SEED, mrf.n, len(mrf.cliques),
                                        chunk, device=x.device, first=lo)
        same_x &= torch.equal(xs[0].to(torch.int32), x[0, lo:lo + chunk])
        c2 = analytic.clique_keep_probs_fast(mrf, xs[0])
        bits = a[0, lo:lo + chunk]
        differ = torch.zeros(chunk, dtype=torch.bool, device=x.device)
        for k, u in enumerate(uniforms):
            c = c2[:, k]
            d = ((bits >> k) & 1).bool() != (u[0] >= c)
            ulp = torch.nextafter(c, torch.full_like(c, 2.0)) - c
            near &= bool(((u[0] - c).abs() <= 2 * ulp)[d].all())
            differ |= d
        flips += int(differ.sum())
    require(same_x, "every x == the Philox words' own")
    require(near, f"{flips} shots with an ancilla bit unlike the chain's, "
                  "each within 2 ulp of its c2")
    return flips


def phase_sampler(dev, report, lib):
    from qcmrf_tpu_torch.ops import kernels, sampler_kernel as sk

    print("[sampler] n=20 grid 4x5, theta = -|randn(RandomState(0))| * 0.3")
    mrf = grid_model(4, 5, 0, dev)
    cl, n = mrf.cliques, mrf.n
    keep = sk.keep_prob_values(cl, n, mrf.theta, mrf.beta)[None]
    err = 0
    for shots in (N_SHOTS_CHECK, N_SHOTS_CHECK + 77):
        for mode in sk.MODES:
            got = sk.sample_call(SAMPLE_SEED, cl, n, keep, shots, mode)
            want = sk.sample_call_reference(SAMPLE_SEED, cl, n, keep, shots,
                                            mode)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            mode_err = max(int((g.long() - w.long()).abs().max())
                           for g, w in zip(got, want))
            err = max(err, mode_err)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"kernel == plain version, mode {mode}, {shots} shots "
                    f"(max |kernel - plain| = {mode_err})")
        flags = sk.sample_call(SAMPLE_SEED, cl, n, keep, shots, "flags")
        count = sk.sample_call(SAMPLE_SEED, cl, n, keep, shots, "count")
        require(int(count[0]) == int(flags.sum()),
                f"count {int(count[0])} == flags.sum(), {shots} shots")

    delta = math.exp(float(kernels.log_partition(mrf)) - n * math.log(2.0))
    x, a = sk.sample_call(SAMPLE_SEED, cl, n, keep, N_SHOTS_RATE, "parts")
    acc = int((a == 0).sum())
    sigma = math.sqrt(delta * (1 - delta) / N_SHOTS_RATE)
    z = (acc / N_SHOTS_RATE - delta) / sigma
    require(abs(z) <= 5.0,
            f"acceptance {acc}/{N_SHOTS_RATE} = {acc / N_SHOTS_RATE:.6e} vs "
            f"delta {delta:.6e} from the lse kernel: {z:+.2f} sigma")
    require(int(x.min()) >= 0 and int(x.max()) < (1 << n), "x in [0, 2^n)")
    flips = chain_flips(mrf, x, a)
    print(f"  against the chain's c2 on the same words: every x equal, "
          f"{flips} of {N_SHOTS_RATE} shots with an ancilla bit flipped "
          "(each within 2 ulp of c2)")
    del x, a

    ms = {}
    for mode in ("parts", "flags", "count"):
        ms[mode] = cuda_ms(lambda: sk.sample_call(
            SAMPLE_SEED, cl, n, keep, N_SHOTS_RATE, mode), reps=10)
        print(f"  kernel {mode}: {ms[mode]:.3f} ms per {N_SHOTS_RATE} shots "
              f"= {N_SHOTS_RATE / ms[mode] / 1e6:.3f} G shots/s")
    plain_shots = plain_sampler_shots(cl, n, keep)
    plain_ms = cuda_ms(lambda: sk.sample_call_reference(
        SAMPLE_SEED, cl, n, keep, plain_shots, "parts"), reps=2)
    print(f"  plain parts: {plain_ms:.3f} ms per {plain_shots} shots = "
          f"{plain_shots / plain_ms / 1e6:.3f} G shots/s")
    torch.cuda.empty_cache()
    # per shot: 8 bytes of outputs; Philox's integer operations charged at
    # the float32 rate (the card issues at most 128 lane operations a clock
    # an SM, the float rate counts 256: a lower bound) and the lookup's;
    # the chain design's count beside it: the chain, the uniform's scaling
    # and the comparison a clique, Philox left out
    K = len(cl)
    b = bound(8 * N_SHOTS_RATE,
              N_SHOTS_RATE * (philox_ops(K) + lookup_ops(cl)))
    old = bound(8 * N_SHOTS_RATE,
                N_SHOTS_RATE * (chain_flops(cl) + 2 * K))
    print(f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}): Philox "
          f"{philox_ops(K)} + lookup {lookup_ops(cl)} operations a shot; "
          f"without Philox (the chain design's count, "
          f"{chain_flops(cl) + 2 * K} a shot) {old['bound_ms']:.4f} ms")
    sass = sass_instructions(lib, "14sampler_kernelILi2E")
    calls = 1 + K // 4
    per_shot = sass["outer"] - sass["inner"] + sass["inner"] * (calls - 1)
    philox = (sass["outer_philox"] - sass["inner_philox"]
              + sass["inner_philox"] * (calls - 1))
    print(f"  SASS of sampler_kernel<2> (cuobjdump): {sass['inner']} "
          f"instructions a Philox call and 4 cliques ({sass['inner_philox']} "
          f"Philox: {sass['inner_wide']} IMAD.WIDE.U32 and the 3-input "
          f"XORs), {sass['outer']} in the loop over shots; about {per_shot} "
          f"a shot at K={K} ({calls} calls), {philox} of them Philox")
    report["sampler"] = dict(
        **b, max_abs_err=float(err),
        err_shape=f"(1, {N_SHOTS_CHECK}) and (1, {N_SHOTS_CHECK + 77}) "
                  f"shots, all modes {list(sk.MODES)}, n=20 K=31",
        ms=ms["parts"], plain_ms=plain_ms,
        bound_ms_without_philox=old["bound_ms"],
        ops_per_shot=dict(philox=philox_ops(K), lookup=lookup_ops(cl),
                          chain_design=chain_flops(cl) + 2 * K),
        sass_per_shot=dict(all=per_shot, philox=philox, **sass),
        chain_flips=flips,
        shape=f"(1, {N_SHOTS_RATE}) shots, parts mode, n=20 K=31",
        plain_shape=f"(1, {plain_shots}) shots, parts mode")


def table_row(what: str, mrf, reps: int) -> dict:
    """The table kernel on one model: its time and its plain versions'
    (the split's, which it equals bit for bit where checked, and the
    chain's), and its bound, the larger of 4 bytes written a state and
    the split's operations (beta a state); the chain's count beside it."""
    from qcmrf_tpu_torch.ops import kernels

    coef = kernels.moebius_coefficients(mrf)[None]
    args = (mrf.cliques, mrf.n, coef, mrf.beta)
    n = mrf.n
    ms = cuda_ms(lambda: kernels.logpot_table(*args), reps=reps)
    plain_ms = cuda_ms(lambda: kernels.logpot_table_split_reference(*args),
                       reps=1)
    chain_ms = cuda_ms(lambda: kernels.logpot_table_reference(*args), reps=1)
    torch.cuda.empty_cache()
    ops = split_ops(mrf.cliques, n, per_state=1)
    chain = (chain_flops(mrf.cliques) + 1) << n
    b = bound(4 << n, ops)
    print(f"  {what}: kernel {ms:.3f} ms, plain (split) {plain_ms:.3f} ms, "
          f"plain (chain) {chain_ms:.3f} ms for 2^{n} states; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {4 << n} bytes, the "
          f"split's {ops:.4e} operations; the chain's {chain:.4e}: "
          f"{bound(4 << n, chain)['bound_ms']:.3f} ms)")
    return dict(**b, ms=ms, plain_ms=plain_ms, chain_plain_ms=chain_ms,
                split_ops=ops, chain_ops=chain,
                chain_bound_ms=bound(4 << n, chain)["bound_ms"])


def phase_logpot(dev, report):
    """The table kernel (the block-invariant split) at n = 20 and 24
    (grids): equal to its split plain version bit for bit, both
    ``fuse_amp`` values; each value within ``split_gap`` of the chain's;
    two launches bit-equal; timed there and on bench.py's K27 (2^27
    states, the table ``sample_exact`` draws from; its values are held
    against the chain's oracle table in the infer phase)."""
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels

    for rows, cols, seed in ((4, 5, 0), (4, 6, 1)):
        mrf = grid_model(rows, cols, seed, dev)
        coef = kernels.moebius_coefficients(mrf)[None]
        args = (mrf.cliques, mrf.n, coef, mrf.beta)
        got = kernels.logpot_table(*args)
        want = kernels.logpot_table_split_reference(*args)
        split_err = float((got - want).abs().max())
        require(torch.equal(got, want)
                and torch.equal(got, kernels.logpot_table(*args)),
                f"[logpot] n={mrf.n} grid {rows}x{cols}: table kernel == "
                "split plain version (torch.equal); two launches bit-equal")
        err = float((got - kernels.logpot_table_reference(*args)).abs().max())
        gap = float(kernels.split_gap(coef, mrf.beta)[0])
        require(err <= gap, f"  each value within split_gap of the chain's "
                            f"table (max |kernel - chain| {err:.3e}, "
                            f"2 e_b {gap:.3e})")
        require(torch.equal(
            kernels.logpot_table(*args, fuse_amp=True),
            kernels.logpot_table_split_reference(*args, fuse_amp=True)),
            f"  amplitude epilogue == split plain version, n={mrf.n} "
            "(torch.equal)")
        total = float(kernels.gibbs_probs(mrf).double().sum())
        require(abs(total - 1.0) <= 1e-5,
                f"gibbs_probs sums to 1 within 1e-5 ({total:.8f})")
        del got, want
        report["logpot"] = dict(
            **table_row(f"n={mrf.n} grid {rows}x{cols}", mrf, reps=10),
            max_abs_err=split_err, chain_max_abs_err=err, split_gap=gap,
            shape=f"(1, 2^{mrf.n}) table, grid {rows}x{cols}")
    k27 = MRF.create(complete_cliques(INFER_N), theta=k27_theta(),
                     device=dev)
    report["logpot"]["k27"] = dict(
        **table_row(f"K{INFER_N}", k27, reps=10),
        shape=f"(1, 2^{INFER_N}) table, K{INFER_N} pairwise")
    torch.cuda.empty_cache()


def split_ops(cliques, n: int, masks: int = 0, per_state: int = None) -> int:
    """Float operations of one split sweep over 2^n states: lse_kernel's,
    or with ``masks`` monomials lnz_moments_kernel's. The monomial
    coefficients once (an add a coefficient entry); per sub-block of 2^L
    states the plan's tests and adds (2 a monomial), the subset-sum
    transform (L 2^(L-1) adds) and, with masks, the superset sums and a
    test and an add a monomial; per state beta, the max, the difference
    and the exp (counted as one), and for lse the sum; or ``per_state``
    (map_kernel's 3: beta, the max and the threshold's compare; the
    table's 1, beta; the given-lnZ moments' 3: beta, the difference and
    the exp)."""
    from qcmrf_tpu_torch.ops import kernels

    cl = tuple(tuple(C) for C in cliques)
    L = kernels.split_bits(n)
    plan = kernels.split_plan(cl, n, L)
    per_sub = (2 * len(plan.hm) + (L << (L - 1)) * (2 if masks else 1)
               + 2 * masks)
    if per_state is None:
        per_state = 4 if masks else 5
    return len(plan.coef_index) + (per_sub << (n - L)) + (per_state << n)


def lse_row(what: str, mrf, reps: int) -> dict:
    """The lse kernel on one model: two launches bit-equal, lnZ within
    1e-4 of the table kernel's logsumexp and of its plain version; its
    time and its plain version's, and its bound from the split's count
    (the per-state chain's count beside it)."""
    from qcmrf_tpu_torch.ops import kernels

    coef = kernels.moebius_coefficients(mrf)[None]
    args = (mrf.cliques, mrf.n, coef, mrf.beta)
    m1, s1 = kernels.lse_partials(*args)
    m2, s2 = kernels.lse_partials(*args)
    require(torch.equal(m1, m2) and torch.equal(s1, s2),
            f"{what}: two lse launches give bit-equal partials")
    lnz = float(kernels.combine_lse(m1, s1)[0])
    table = kernels.logpot_table(*args)[0]
    from_table = float(torch.logsumexp(table, dim=0))
    del table
    torch.cuda.empty_cache()
    print(f"[lnZ] {what}: lse kernel {lnz:.6f}, logsumexp of the table "
          f"kernel {from_table:.6f}")
    require(abs(lnz - from_table) <= 1e-4,
            f"{what}: lse kernel == torch.logsumexp(log-potential table) "
            "within 1e-4")
    plain = float(kernels.combine_lse(
        *kernels.lse_partials_reference(*args))[0])
    err = abs(lnz - plain)
    require(err <= 1e-4, f"{what}: lse kernel == plain version within 1e-4 "
                         f"({err:.3e})")
    ms = cuda_ms(lambda: kernels.lse_partials(*args), reps=reps)
    plain_ms = cuda_ms(lambda: kernels.lse_partials_reference(*args), reps=1)
    torch.cuda.empty_cache()
    # device memory sees only the partials; per state the chains cost
    # chain_flops + 5 (beta, max, difference, exp, sum)
    n = mrf.n
    nbytes = 8 * kernels.lse_geometry(1 << n)[0]
    ops = split_ops(mrf.cliques, n)
    chain = (chain_flops(mrf.cliques) + 5) << n
    b = bound(nbytes, ops)
    print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms for 2^{n} states; "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) from the split's "
          f"{ops:.4e} operations (the chain's {chain:.4e}: "
          f"{bound(nbytes, chain)['bound_ms']:.3f} ms)")
    return dict(**b, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                split_ops=ops, chain_ops=chain,
                chain_bound_ms=bound(nbytes, chain)["bound_ms"])


def phase_lnz(dev, report):
    """The streaming logsumexp (``lse_kernel``, the block-invariant split)
    at n = 28 (grid 4x7) and on bench.py's K27 (2^27 states, K = 351),
    where the infer batch spends its lse sweeps."""
    from qcmrf_tpu_torch.models.mrf import MRF

    row = lse_row("n=28 grid 4x7", grid_model(4, 7, 2, dev), reps=20)
    k27 = MRF.create(complete_cliques(INFER_N), theta=k27_theta(),
                     device=dev)
    report["lse"] = dict(**row, shape="(1, 2^28) states, grid 4x7", k27=dict(
        **lse_row(f"K{INFER_N}, K={len(k27.cliques)}", k27, reps=20),
        shape=f"(1, 2^{INFER_N}) states, K{INFER_N} pairwise"))


def phase_suite_shapes(dev):
    """Kernel vs plain version at the shapes ``run``/``eval`` give them:
    one graph's 10 reps per launch."""
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.ops import kernels, sampler_kernel as sk

    suite = generate_suite(0.1)
    print("[suite shapes] the 7 graphs x 10 reps of scale 0.1")
    for j, C in enumerate(suite.graphs):
        cl = tuple(tuple(c) for c in C)
        n = max(v for c in C for v in c) + 1
        th = torch.tensor(suite.thetas[j], dtype=torch.float32, device=dev)
        kc = sk.keep_prob_values(cl, n, th, 1.0)
        got = sk.sample_call(0, cl, n, kc, 10_000, "parts", 10 * j)
        want = sk.sample_call_reference(0, cl, n, kc, 10_000, "parts", 10 * j)
        mc = kernels.coefficient_table(cl, n, th)
        lp = kernels.logpot_table(cl, n, mc, 1.0)
        lp_want = kernels.logpot_table_split_reference(cl, n, mc, 1.0)
        lp_chain = kernels.logpot_table_reference(cl, n, mc, 1.0)
        gap = kernels.split_gap(mc, 1.0)
        lz = kernels.combine_lse(*kernels.lse_partials(cl, n, mc, 1.0))
        lz_want = kernels.combine_lse(
            *kernels.lse_partials_reference(cl, n, mc, 1.0))
        require(all(torch.equal(g, w) for g, w in zip(got, want))
                and torch.equal(lp, lp_want)
                and bool(((lp - lp_chain).abs().amax(dim=-1) <= gap).all())
                and torch.allclose(lz, lz_want, rtol=0.0, atol=1e-6),
                f"graph {C}: sampler identical, table == split plain "
                "version and within split_gap of the chain's, lnZ within "
                "1e-6")


def counters():
    from qcmrf_tpu_torch.ops import (circuit_kernel, gibbs_kernel, kernels,
                                     sampler_kernel)

    return (sampler_kernel.LAUNCHES, kernels.LAUNCHES, circuit_kernel.LAUNCHES,
            gibbs_kernel.LAUNCHES)


def reset_counts() -> None:
    for c in counters():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def phase_main_path(dev, engine: str, needs):
    """``run --engine <engine>`` then ``eval`` of the 70 circuits on the
    GPU; returns the launch counts of that run."""
    from qcmrf_tpu_torch.runners import eval as run_eval
    from qcmrf_tpu_torch.runners import run_experiment

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        run_experiment.main([
            "--scale", "0.1", "--shots", "10000", "--platform", "gpu",
            "--engine", engine, "--sample-seed", "0",
            "--outdir", os.path.join(tmp, "res_0.1"), "--res-root", tmp])
        results = run_eval.main([
            "--results", f"result_{engine}_0.1.json", "--scale", "0.1",
            "--res-root", tmp, "--platform", "gpu", "--kl"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    print(f"[main path, {engine}] run + eval of 70 circuits on the GPU: "
          f"{seconds:.2f} s; launches {launches}")
    require(len(results) == 7, "7 graphs evaluated")
    for r in results:
        require(r.mean_f >= 0.99, f"graph {r.graph}: mean fidelity "
                                  f"{r.mean_f:.4f} >= 0.99")
        worst = max(abs(a - b) for a, b in zip(r.successes, r.exact_deltas))
        require(worst <= 0.02, f"graph {r.graph}: |delta-hat - delta| "
                               f"<= 0.02 (worst {worst:.4f})")
    for name, want in needs.items():
        count = launches[name]
        require(count > 0 if want is None else count == want,
                f"kernel {name} launched {count} times"
                + ("" if want is None else f" (expected {want})"))
    return launches


def chain_model(nn: int, dev):
    """bench.py's gate-level chain: nn variables, width 2 nn, theta =
    -|randn(RandomState(0))| * 0.3."""
    from qcmrf_tpu_torch.models.mrf import MRF

    theta = -np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3
    return MRF.create([[i, i + 1] for i in range(nn - 1)], theta=theta,
                      device=dev)


def phase_circuit_kernel(dev, report):
    """The whole-circuit kernel against its plain version (the dense
    engine on the card): each suite graph and the 8-variable chain (width
    16, its state in the global scratch) alone, and all eight in one
    launch; then the suite's one call timed on the host's clock and the
    kernel alone by CUDA events."""
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.ops import circuit_kernel as ck

    suite = generate_suite(0.1)
    cases = [(C, np.asarray(suite.thetas[j], np.float32))
             for j, C in enumerate(suite.graphs)]
    chain8 = chain_model(8, "cpu")  # width 16: the kernel's widest
    cases.append((chain8.cliques, np.stack(
        [chain8.theta.numpy(), 0.5 * chain8.theta.numpy()])))
    print("[circuit kernel] the 7 suite graphs x 10 reps (scale 0.1) and "
          "the 8-variable chain (width 16): alone, then all in one launch")
    err = 0.0
    before = ck.LAUNCHES["circuit"]
    mixed = ck.batched_circuits_probs(cases, device=dev)
    require(ck.LAUNCHES["circuit"] == before + 1,
            "the 8 structures' 72 circuits in one launch")
    for (C, thetas), one in zip(cases, mixed):
        got = ck.batched_circuit_probs(C, thetas, device=dev)
        want = ck.batched_circuit_probs_reference(C, thetas, device=dev)
        e = max(float((g - want).abs().max()) for g in (got, one))
        err = max(err, e)
        # 2e-5 at the suite's widths (<= 10, values ~1e-3); at width 16
        # the values average 2^-15 ~ 3e-5, so 1e-6 there
        tol = 2e-5 if got.shape[1] <= 1 << 10 else 1e-6
        require(all(torch.allclose(g, want, rtol=0, atol=tol)
                    for g in (got, one)),
                f"graph {[list(c) for c in C]}: kernel == plain version "
                f"within {tol:.0e}, alone and in the mixed launch (max "
                f"|diff| {e:.2e}), shape {tuple(got.shape)}")

    problems = [(C, suite.thetas[j]) for j, C in enumerate(suite.graphs)]
    ms = cuda_ms(lambda: ck.batched_circuits_probs(problems, device=dev),
                 reps=50)
    t0 = time.perf_counter()
    for _ in range(50):
        pack = ck.pack_circuits([ck._problem(C, t) for C, t in problems])
    pack_ms = (time.perf_counter() - t0) / 50 * 1e3
    buffers = ck.upload(pack, dev)
    device_ms = cuda_ms(lambda: ck.launch(pack, buffers, 1.0, dev),
                        reps=200)
    plain_ms = cuda_ms(lambda: [ck.batched_circuit_probs_reference(
        C, t, device=dev) for C, t in problems], reps=1)
    nbytes = flops = 0
    for j, C in enumerate(suite.graphs):
        n = max(v for c in C for v in c) + 1
        N = 1 << (n + len(C) + 1)
        B = len(suite.thetas[j])
        nbytes += B * (8 * sum(1 << len(c) for c in C) + 4 * N)
        flops += B * N * (6 * len(C) + 3)
    print(f"  suite70_gate_level_ms: {ms:.4f} ms a call (one launch, "
          f"host packing and one copy included); of it the host's "
          f"checks and packing {pack_ms:.4f} ms (host clock); the kernel "
          f"alone {device_ms:.4f} ms (CUDA events); plain {plain_ms:.3f} "
          "ms")
    report["circuit"] = dict(
        **bound(nbytes, flops), max_abs_err=err, ms=ms,
        device_ms=device_ms, pack_ms=pack_ms, plain_ms=plain_ms,
        shape="the 7 suite graphs, (10, 2^w) each, w <= 10: one call, "
              "one launch (suite70_gate_level_ms); device_ms the launch "
              "alone, pack_ms the host's checks and packing")
    torch.cuda.empty_cache()


def random_profiles(nq, a_lo, k, seed, with_mu):
    rng = np.random.RandomState(seed)
    free = [q for q in range(nq) if not a_lo <= q < a_lo + k]
    nts, nas = [], []
    for _ in range(k):
        terms = tuple(
            tuple((int(p), int(rng.randint(2))) for p in
                  rng.choice(free, rng.randint(1, 4), replace=False))
            for _ in range(rng.randint(1, 6)))
        nts.append(terms)
        nas.append(tuple(rng.randn(len(terms))))
    mu = ((((free[0], 1),), ((free[3], 0), (free[5], 1))), (0.4, -0.8), 0.3)
    return (tuple(nts), tuple(nas), tuple(rng.randn(k)),
            mu if with_mu else ((), (), 0.0))


def random_planes(nq, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = ((1 << nq) // 128, 128)
    return (torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))


def phase_sandwich_kernels(dev, report):
    """Each sandwich kernel against its plain version at width 24, with mu
    = 0 and mu != 0; times at that width. The multi kernel is held at k =
    1 (one sandwich on the top ancilla), 2 (the pair) and 7."""
    from qcmrf_tpu_torch.ops import kernels as K

    nq = SANDWICH_WIDTH
    N = 1 << nq
    cases = {
        # name: (kernel, plain, a_lo, k, bytes per value)
        "hdh_single": (K.apply_hdh_sandwich, K.apply_hdh_sandwich_reference,
                       nq - 1, 1, 16),
        "hdh_pair": (K.apply_hdh_sandwich_multi,
                     K.apply_hdh_sandwich_multi_reference, nq - 7, 2, 16),
        "hdh_multi": (K.apply_hdh_sandwich_multi,
                      K.apply_hdh_sandwich_multi_reference, nq - 11, 7, 16),
        "hdh_multi_uniform": (K.apply_hdh_sandwich_multi_uniform,
                              K.apply_hdh_sandwich_multi_uniform_reference,
                              nq - 11, 7, 8),
    }
    folded = tuple(range(nq - 12))  # the variables of the 12-chain
    print(f"[sandwich kernels] width {nq}: kernel vs plain version, "
          "random profiles, mu = 0 and mu != 0")
    for name, (fn, plain, a_lo, k, bpv) in cases.items():
        err = 0.0
        for with_mu in (False, True):
            nts, nas, nbs, mu = random_profiles(nq, a_lo, k, 7 * k + a_lo,
                                                with_mu)
            if name == "hdh_multi_uniform":
                def run(f):
                    return f(nq, folded, a_lo, nts, nas, nbs, *mu,
                             device=dev)
            elif name == "hdh_single":
                def run(f):
                    return f(*random_planes(nq, 5, dev), a_lo, nts[0],
                             nas[0], nbs[0], *mu)
            else:
                def run(f):
                    return f(*random_planes(nq, 5, dev), a_lo, nts, nas,
                             nbs, *mu)
            got, want = run(fn), run(plain)
            e = max(float((g - w).abs().max()) for g, w in zip(got, want))
            err = max(err, e)
            require(all(torch.allclose(g, w, rtol=0, atol=1e-5)
                        for g, w in zip(got, want)),
                    f"{name} (k={k}, ancillas from {a_lo}, mu "
                    f"{'!= 0' if with_mu else '= 0'}): kernel == plain "
                    f"version within 1e-5 (max |diff| {e:.2e})")
            del got, want
        planes = random_planes(nq, 6, dev)
        if name == "hdh_multi_uniform":
            def time_kernel():
                return fn(nq, folded, a_lo, nts, nas, nbs, *mu, out=planes)

            def time_plain():
                return plain(nq, folded, a_lo, nts, nas, nbs, *mu,
                             out=planes)
        elif name == "hdh_single":
            def time_kernel():
                return fn(*planes, a_lo, nts[0], nas[0], nbs[0], *mu)

            def time_plain():
                return plain(*planes, a_lo, nts[0], nas[0], nbs[0], *mu)
        else:
            def time_kernel():
                return fn(*planes, a_lo, nts, nas, nbs, *mu)

            def time_plain():
                return plain(*planes, a_lo, nts, nas, nbs, *mu)
        ms = cuda_ms(time_kernel, reps=20)
        plain_ms = cuda_ms(time_plain, reps=3)
        b = bound(bpv * N, N * (6 * k + 6))
        print(f"  {name}: max |kernel - plain| {err:.2e}; kernel {ms:.4f} "
              f"ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) at 2^{nq} values")
        report.setdefault("sandwich_w24", {})[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
            shape=f"2^{nq} values, k={k}, ancillas from {a_lo}")
        del planes
    torch.cuda.empty_cache()


def plain_ops(ops, nq, dev):
    """The fused stream through the plain versions."""
    from qcmrf_tpu_torch.ops import kernels as K

    re = im = None
    for op in ops:
        if op[0] == "sandwichku":
            _, folded, a, nts, nas, nbs, mt, ma, mb = op
            re, im = K.apply_hdh_sandwich_multi_uniform_reference(
                nq, folded, a, nts, nas, nbs, mt, ma, mb, device=dev)
        elif op[0] == "sandwichk":
            _, a, nts, nas, nbs, mt, ma, mb = op
            K.apply_hdh_sandwich_multi_reference(re, im, a, nts, nas, nbs,
                                                 mt, ma, mb)
        elif op[0] == "sandwich":
            _, a, nt, na, nb, mt, ma, mb = op
            K.apply_hdh_sandwich_reference(re, im, a, nt, na, nb, mt, ma, mb)
        else:
            raise AssertionError(f"unexpected op {op[0]}")
    return re, im


def pass_bytes(ops, nq) -> int:
    """Bytes the fused passes must move: a write-only pass writes both
    planes, a read-write pass reads and writes them."""
    return sum((8 if op[0] == "sandwichku" else 16) << nq for op in ops)


def diag_flops(terms, nq) -> int:
    """A diagonal pass: the phase's complex product per value, and a rotor
    composed (8 operations) at every state where a term holds."""
    total = 6 << nq
    for conds in terms:
        held = {}
        if all(held.setdefault(p, w) == w for p, w in conds):
            total += 8 << (nq - len(held))
    return total


def pass_flops(ops, nq) -> int:
    """Float operations of the fused passes: a complex multiply-add is 8;
    a lane op given with its factors does 2 a value for each factor that
    is not the identity (a 2x2 butterfly, as a rowq pass), a bare lane op
    (the dense product) 128, a row pass 2^K, a sandwich 6 per ancilla
    level plus its phase."""
    from qcmrf_tpu_torch.ops import kernels as K

    total = 0
    for op in ops:
        if op[0] == "lane" and len(op) == 3:
            total += 16 * bin(K.lane_factor_mask(op[2])).count("1") << nq
        elif op[0] == "lane":
            total += 1024 << nq
        elif op[0] in ("rowq", "row2"):
            total += (16 if op[0] == "rowq" else 32) << nq
        elif op[0] == "diag":
            total += diag_flops(op[1], nq)
        else:
            k = (len(op[3]) if op[0] == "sandwichku" else
                 1 if op[0] == "sandwich" else len(op[2]))
            total += (6 * k + 6) << nq
    return total


def dense_lanes(ops) -> list:
    """The stream with each lane op stripped of its factors: the dense
    product's count, the yardstick before the factored pass."""
    return [op[:2] if op[0] == "lane" else op for op in ops]


def stream_bound(ops, nq) -> dict:
    """The least time of a stream of passes: each pass bound by its bytes
    or its operations, summed; ``bound_by`` says which bound them."""
    each = [bound(pass_bytes([op], nq), pass_flops([op], nq)) for op in ops]
    by = {b["bound_by"] for b in each}
    return dict(bound_ms=sum(b["bound_ms"] for b in each),
                bound_by=by.pop() if len(by) == 1 else "bytes and operations")


def plain_gate_width(dev) -> int:
    """Largest gate-level width whose plain run fits in 80% of the free
    device memory, scaled from the peak of a width-20 run."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.sim import planes

    ops = planes.fuse_ops(compile_qcmrf(chain_model(10, "cpu"),
                                        with_measurements=False))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = plain_ops(ops, 20, dev)
    del out
    per_value = (torch.cuda.max_memory_allocated() - base) / (1 << 20)
    free = torch.cuda.mem_get_info()[0]
    width = 20
    for w in GATE_WIDTHS:
        if per_value * (1 << w) <= 0.8 * free:
            width = w
    return width


def norm_float64(re, im, chunk=1 << 27) -> float:
    total = 0.0
    fr, fi = re.view(-1), im.view(-1)
    for s in range(0, fr.numel(), chunk):
        total += float((fr[s:s + chunk].double() ** 2).sum()
                       + (fi[s:s + chunk].double() ** 2).sum())
    return total


def phase_gate_level(dev, report):
    """bench.py's gate-level chains on the plane engine at widths 20-32;
    the width-32 run is this path's counted main run."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.sim import dense, planes

    print("[gate level] QCMRF chains, theta = -|randn(RandomState(0))| * "
          "0.3, planes in place")
    plain_w = plain_gate_width(dev)
    rows = {}
    for w in GATE_WIDTHS:
        nn = w // 2
        mrf = chain_model(nn, dev)
        circ = compile_qcmrf(mrf, with_measurements=False)
        t0 = time.perf_counter()
        ops = planes.fuse_ops(circ)
        plan_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if w == max(GATE_WIDTHS):
            reset_counts()
            re, im = planes.run_statevector(circ, device=dev)
            torch.cuda.synchronize()
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated()
            print(f"  width {w}: main-path run, launches {launches}, peak "
                  f"memory {peak / 2**30:.3f} GiB")
            # sandwichku, then sandwichk (k=7) and sandwich (k=1)
            for name, want in (("hdh_multi_uniform", 1), ("hdh_multi", 2)):
                require(launches[name] == want,
                        f"kernel {name} launched {launches[name]} times in "
                        f"the width-{w} run (expected {want})")
            report["main_gate_level"] = launches
            check_width32(mrf, re, im, dev)
            # each pass alone at the main path's shape, on these planes
            for op in ops:
                ms = cuda_ms(lambda op=op: planes.apply_ops(re, im, [op], w),
                             reps=3)
                b = bound(pass_bytes([op], w), pass_flops([op], w))
                print(f"  width {w} pass {op[0]}: {ms:.3f} ms, bound "
                      f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
                report.setdefault("pass_w32", {})[op[0]] = dict(ms=ms, **b)
            del re, im
        elif w == SANDWICH_WIDTH:
            re, im = planes.run_statevector(circ, device=dev)
            want = dense.run_statevector(circ, device=dev)
            got = torch.complex(re, im).reshape(-1)
            e = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=0, atol=1e-5),
                    f"width {w}: planes == dense oracle on the card within "
                    f"1e-5 (max |diff| {e:.2e})")
            del re, im, want, got
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: planes.run_ops(ops, w, dev),
                     reps=3 if w >= 30 else 5)
        b = bound(pass_bytes(ops, w), pass_flops(ops, w))
        row = dict(ms=ms, passes=len(ops), gates=len(circ.gates),
                   plan_ms=plan_ms, **b)
        if w == plain_w:
            torch.cuda.empty_cache()
            row["plain_ms"] = cuda_ms(lambda: plain_ops(ops, w, dev),
                                      reps=1)
        rows[w] = row
        print(f"  qcmrf{w}_gate_level_ms {ms:.3f} (bound {b['bound_ms']:.3f}"
              f" ms, {b['bound_by']}); passes {len(ops)} "
              f"{[op[0] for op in ops]}; gates {len(circ.gates)}; planner "
              f"{plan_ms:.1f} ms on the host"
              + (f"; plain {row['plain_ms']:.3f} ms" if "plain_ms" in row
                 else ""))
        torch.cuda.empty_cache()
    report["gate_level"] = rows
    report["gate_plain_width"] = plain_w


def check_width32(mrf, re, im, dev) -> None:
    from qcmrf_tpu_torch.ops import kernels as K

    n = mrf.n
    w = re.numel().bit_length() - 1
    amp = K.postselected_amplitudes(mrf)
    got_re = re.view(-1)[: 1 << n]
    got_im = im.view(-1)[: 1 << n]
    rel = float(((got_re - amp).abs() / amp.abs()).max())
    imag = float(got_im.abs().max())
    require(rel <= 1e-4, f"width {w}: the first 2^{n} amplitudes == "
                         f"postselected_amplitudes (max relative error "
                         f"{rel:.2e} <= 1e-4)")
    require(imag <= 1e-6, f"width {w}: their imaginary parts <= 1e-6 "
                          f"(max {imag:.2e})")
    norm = norm_float64(re, im)
    require(abs(norm - 1.0) <= 1e-4, f"width {w}: norm {norm:.8f} within "
                                      "1e-4 of 1 (float64 over chunks)")


def complete_cliques(n: int):
    return [[i, j] for i in range(n) for j in range(i + 1, n)]


def k27_theta() -> np.ndarray:
    """bench.py's wide model: theta = -|randn(RandomState(11))| * 0.02,
    in float32 as bench.py rounds it."""
    d = 4 * len(complete_cliques(INFER_N))
    return -np.abs(np.random.RandomState(11).randn(d)).astype(
        np.float32) * np.float32(0.02)


def mixed_cliques(n: int):
    """A ring of 3-, 4- and 5-variable cliques over n variables."""
    cl, v, i = [], 0, 0
    while v < n - 1:
        c = (3, 4, 5)[i % 3]
        cl.append([u % n for u in range(v, v + c)])
        v, i = v + c - 1, i + 1
    return cl


def random_cliques(n: int, draws: int, size: int, seed: int):
    """Distinct random ``size``-variable cliques over n variables: at n =
    20, 700 draws of 4 give tables past 48 KB of shared memory and about
    1900 monomials."""
    rng = np.random.RandomState(seed)
    return [list(C) for C in sorted(
        {tuple(sorted(rng.choice(n, size, replace=False).tolist()))
         for _ in range(draws)})]


def seeded_model(cliques, seed, scale, dev, n=None):
    from qcmrf_tpu_torch.models.mrf import MRF

    d = sum(1 << len(C) for C in cliques)
    theta = -np.abs(np.random.RandomState(seed).randn(d)) * scale
    return MRF.create(cliques, theta=theta, n=n, device=dev)


def tie_chain(n: int, dev):
    """Chain rewarding unequal neighbours with dyadic theta: the two
    alternating states tie exactly at 0; the earliest is 0101..."""
    from qcmrf_tpu_torch.models.mrf import chain_mrf

    return chain_mrf(n, theta=np.tile([-0.5, 0.0, 0.0, -0.5], n - 1),
                     device=dev)


def infer_kernel_args(mrf):
    """(cliques, n, coef, beta, lnz, masks) of the two sweeps."""
    from qcmrf_tpu_torch.utils import moebius
    from qcmrf_tpu_torch.ops import kernels

    coef = kernels.moebius_coefficients(mrf)[None]
    lnz = kernels.log_partition(mrf).reshape(1)
    masks = torch.from_numpy(moebius.monomial_masks(mrf.cliques, mrf.n)).to(
        mrf.device)
    return mrf.cliques, mrf.n, coef, mrf.beta, lnz, masks


def timed_once(fn):
    """(result, milliseconds) of one call of ``fn``, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_map_and_moments(mrf, what: str, times=None) -> dict:
    """The map and moments kernels against their plain versions on one
    model (map: ids and values equal, two launches bit-equal; moments:
    equal to the split's plain version, within 1e-6 of the chain's plain
    version in float64 on the same float32 coefficients, the distance of
    its float32 run printed beside); returns the largest differences and
    the map kernel's candidates (the states whose chain it evaluated).
    With ``times`` (a dict), also times each kernel (CUDA events over 5
    calls after a warm-up) and each plain version (the one float32 call
    that the check makes)."""
    from qcmrf_tpu_torch.ops import kernels

    args = infer_kernel_args(mrf)
    cl, n, coef, beta, lnz, masks = args
    (wv, wx), plain_map = timed_once(
        lambda: kernels.map_partials_reference(*args[:4]))
    cand = torch.zeros(wx.shape, dtype=torch.int64, device=wx.device)
    v, x = kernels.map_partials(*args[:4], candidates=cand)
    map_err = float((v - wv).abs().max())
    require(torch.equal(x, wx) and torch.equal(v, wv),
            f"{what}: map kernel == plain version: the same ids and values "
            f"in all {x.shape[1]} blocks (torch.equal), "
            f"{int(cand.sum())} candidates")
    v2, x2 = kernels.map_partials(*args[:4])
    require(torch.equal(v, v2) and torch.equal(x, x2),
            f"{what}: two map launches give bit-equal partials")
    want32, plain_mom = timed_once(
        lambda: kernels.monomial_moments_reference(*args))
    want = kernels.monomial_moments_reference(cl, n, coef.double(), beta,
                                              lnz, masks)
    got = kernels.monomial_moments(*args)
    mom_err = float((got - want).abs().max())
    require(mom_err <= 1e-6,
            f"{what}: moments kernel == chain plain version in float64 "
            f"within 1e-6 absolute ({mom_err:.2e}, {masks.numel()} "
            f"monomials; its float32 run lies "
            f"{float((want32 - want).abs().max()):.2e} from it, the kernel "
            f"{float((got - want32).abs().max()):.2e})")
    split = kernels.monomial_moments_split_reference(*args)
    require(torch.equal(got, split),
            f"{what}: moments kernel == split plain version (torch.equal)")
    del wv, wx, got, want, want32, split
    torch.cuda.empty_cache()
    if times is not None:
        times["map"] = (cuda_ms(lambda: kernels.map_partials(*args[:4]),
                                reps=5), plain_map)
        times["moments"] = (cuda_ms(lambda: kernels.monomial_moments(*args),
                                    reps=5), plain_mom)
    return dict(map=map_err, moments=mom_err), int(cand.sum())


def check_small_map_routes(dev) -> None:
    """Below ``MIN_KERNEL_N`` the card's MAP routes (``map_state`` and
    ``map_state_streaming``) take the map kernel, the card's table being
    the split's: the chain's earliest maximum at n = 1, 4, 8 and 9 on the
    tie chain, a random complete graph and theta = 0."""
    from qcmrf_tpu_torch.models import sample
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels

    cases = [MRF.create([[0]], theta=[0.3, 0.3], device=dev),
             MRF.create([[0]], theta=[-0.2, 0.1], device=dev)]
    for n in (4, 8, 9):
        k = seeded_model(complete_cliques(n), n, 0.3, dev)
        cases += [tie_chain(n, dev), k, k.with_theta(torch.zeros_like(
            k.theta))]
    before = kernels.LAUNCHES["map"]
    for m in cases:
        coef = kernels.moebius_coefficients(m)[None]
        chain = kernels.logpot_table_reference(m.cliques, m.n, coef, 1.0)[0]
        sid, val = kernels.map_state_streaming(m)
        require(int(sample.map_state(m)) == int(torch.argmax(chain)) == sid
                and val == float(m.beta * chain[sid]),
                f"n={m.n}, K={len(m.cliques)}: map_state and "
                f"map_state_streaming == the chain's earliest maximum "
                f"({sid})")
    require(kernels.LAUNCHES["map"] - before == 2 * len(cases),
            f"below MIN_KERNEL_N: {2 * len(cases)} map launches")


def oracle_pair_moments(t, lnz, n: int, sel=None, chunk=1 << 20):
    """E[x_i x_j] (E[x_i] on the diagonal) from the float64 table ``t`` by
    masked sums, in chunks of states: the streaming kernels' oracle."""
    dev = t.device
    shifts = (n - 1) - torch.arange(n, device=dev)
    M = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for s in range(0, t.numel(), chunk):
        xs = torch.arange(s, min(s + chunk, t.numel()), device=dev)
        B = ((xs[:, None] >> shifts) & 1).double()
        p = torch.exp(t[s:s + chunk] - lnz)
        if sel is not None:
            p = p * sel[s:s + chunk]
        M += B.T @ (B * p[:, None])
    return M


def pairwise_marginals(M, cliques) -> torch.Tensor:
    """Theta-layout clique marginals of a pairwise model from E[x_i x_j]:
    entries (x_i, x_j) = 00, 01, 10, 11, x_i slowest."""
    rows = []
    for i, j in cliques:
        mi, mj, mij = M[i, i], M[j, j], M[i, j]
        rows.append(torch.stack([1 - mi - mj + mij, mj - mij, mi - mij,
                                 mij]))
    return torch.cat(rows)


INFER_QUERIES = (
    {"query": "lnz"},
    {"query": "lnz", "evidence": "0=1,5=0"},
    {"query": "prob", "of": "3=1", "evidence": "0=1"},
    {"query": "map"},
    {"query": "map", "evidence": "0=1,5=0"},
    {"query": "marginals"},
    {"query": "marginals", "evidence": "0=1"},
    {"query": "mmap", "max_vars": "0,1,2"},
)


def phase_infer(dev, report) -> dict:
    """``infer`` on the K27 complete graph (width 27 > 25: every query goes
    to the streaming sweeps) against the table of the log-potential kernel;
    the kernels against their plain versions at n = 20 and at K27; a
    32-variable chain (state ids past 2^31) against elimination. Returns
    the launch counts of the K27 batch."""
    import contextlib
    import io

    from qcmrf_tpu_torch.utils import moebius
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.runners import infer_cli

    n = INFER_N
    print("[infer] kernels vs plain versions at n=20")
    err = dict(map=0.0, moments=0.0)
    for what, mrf in (
            ("K20", seeded_model(complete_cliques(20), 20, 0.05, dev)),
            ("3/4/5-variable ring n=20",
             seeded_model(mixed_cliques(20), 5, 0.3, dev)),
            ("wide 4-variable cliques n=20",
             seeded_model(random_cliques(20, 700, 4, 4), 5, 0.05, dev)),
            ("tie chain n=20", tie_chain(20, dev))):
        for k, e in check_map_and_moments(mrf, what)[0].items():
            err[k] = max(err[k], e)
    v, x = kernels.combine_map(*kernels.map_partials(
        *infer_kernel_args(tie_chain(20, dev))[:4]))
    require(int(x[0]) == int("01" * 10, 2) and float(v[0]) == 0.0,
            "tie: the earliest of the two maxima (0101...) wins")
    check_small_map_routes(dev)

    cliques = complete_cliques(n)
    theta = k27_theta()
    with tempfile.TemporaryDirectory() as tmp:
        graph = os.path.join(tmp, "k27.json")
        theta_path = os.path.join(tmp, "theta.json")
        queries = os.path.join(tmp, "queries.jsonl")
        with open(graph, "w") as f:
            json.dump(cliques, f)
        with open(theta_path, "w") as f:
            json.dump(theta.tolist(), f)
        with open(queries, "w") as f:
            f.write("\n".join(json.dumps(q) for q in INFER_QUERIES))
        argv = ["--graph", graph, "--theta", theta_path, "--queries",
                queries, "--platform", "gpu"]
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        explain = subprocess.run(
            [sys.executable, "-m", "qcmrf_tpu_torch", "infer", *argv[:4],
             "--query", "marginals", "--explain"], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300, check=True)
        rep = json.loads(explain.stdout.strip().splitlines()[-1])
        require(rep["selected"] == "streaming" and rep["induced_width"] == n,
                "--explain answers with no CUDA device visible: K27, width "
                f"{rep['induced_width']}, selects {rep['selected']}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            results = infer_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        profiled("infer K27 batch (8 queries)", report, lambda: quiet(
            infer_cli.main, argv))
    require(len(out.getvalue().splitlines()) == len(INFER_QUERIES),
            f"{len(INFER_QUERIES)} JSON lines printed")
    print(f"  K27 batch of {len(INFER_QUERIES)} queries through infer_cli: "
          f"{seconds:.3f} s; launches lse {launches['lse']}, map "
          f"{launches['map']}, lnz_moments {launches['lnz_moments']}, "
          f"moments {launches['moments']}")
    for k in ("lse", "map", "lnz_moments"):
        require(launches[k] > 0, f"kernel {k} launched {launches[k]} times "
                                 "in the K27 batch")
    require(launches["moments"] == 0,
            "the marginals went through the fused sweep: moments launched "
            f"{launches['moments']} times in the K27 batch")
    require(all(r["backend"] == "streaming" for r in results),
            "every K27 query went to the streaming sweeps")
    report["logpot"]["k27"].update(
        check_k27_answers(results, cliques, theta, dev))
    report["infer_k27_query_s"] = time_k27_queries(cliques, theta, dev)

    print("[infer] K27 kernels and plain versions at the batch's shape")
    mrf = MRF.create(cliques, theta=theta, device=dev)
    times = {}
    errs, cands = check_map_and_moments(mrf, "K27", times)
    for k, e in errs.items():
        err[k] = max(err[k], e)
    cl = mrf.cliques
    m = moebius.monomial_layout(cl).m
    parts = kernels.lse_geometry(1 << n)[0]
    # map: the split's sweep and the candidates' chains and beta; beside
    # it the chain, beta and a compare at every state.
    # moments: the split's sweep with its superset sums, per state beta,
    # the difference and the exp; beside it the chains and beta, the exp
    # of lp - lnZ and a mask test and an add per monomial at every state.
    # Bytes: the partials written (and the masks and lnZ read)
    map_ops = split_ops(cl, n, per_state=3) + cands * (chain_flops(cl) + 1)
    chain_ops = (chain_flops(cl) + 2) << n
    mom_ops = split_ops(cl, n, m, per_state=3)
    mom_bytes = 4 * parts * m + 8 * m + 4
    mom_chain = (chain_flops(cl) + 3 + 2 * m) << n
    b = dict(map=bound(12 * parts, map_ops),
             moments=bound(mom_bytes, mom_ops))
    chain_b = bound(12 * parts, chain_ops)
    print(f"  map: {cands} candidates of 2^{n} states; the split's "
          f"{split_ops(cl, n, per_state=3):.4e} operations and the "
          f"candidates' chains {cands * (chain_flops(cl) + 1):.4e}, "
          f"against the chain at every state {chain_ops:.4e} "
          f"({chain_b['bound_ms']:.3f} ms)")
    print(f"  moments: the split's {mom_ops:.4e} operations, against the "
          f"chain at every state {mom_chain:.4e} "
          f"({bound(mom_bytes, mom_chain)['bound_ms']:.3f} ms)")
    for k in ("map", "moments"):
        ms, plain_ms = times[k]
        print(f"  {k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b[k]['bound_ms']:.3f} ms ({b[k]['bound_by']}) at 2^{n} "
              f"states, K={len(cl)}" + (f", {m} monomials"
                                        if k == "moments" else ""))
        report[k] = dict(max_abs_err=err[k], ms=ms, plain_ms=plain_ms,
                         **b[k], shape=f"K{n} pairwise, 2^{n} states"
                         + (f", {m} monomials" if k == "moments" else ""))
    report["map"].update(candidates=cands, split_ops=map_ops - cands * (
        chain_flops(cl) + 1), chain_ops=chain_ops,
        chain_bound_ms=chain_b["bound_ms"])
    report["moments"].update(split_ops=mom_ops, chain_ops=mom_chain,
                             chain_bound_ms=bound(mom_bytes,
                                                  mom_chain)["bound_ms"])
    report["infer_k27_batch_s"] = seconds
    phase_chain32(dev)
    return launches


def time_k27_queries(cliques, theta, dev) -> list:
    """Host seconds of each batch query alone (answered as the batch
    answers it, ending in a synchronise): where the batch's time goes."""
    import argparse

    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.runners import infer_cli

    mrf = MRF.create(cliques, theta=theta, device=dev)
    rows = []
    for q in INFER_QUERIES:
        args = argparse.Namespace(query=q["query"],
                                  evidence=q.get("evidence", ""),
                                  of=q.get("of"), max_vars=q.get("max_vars"),
                                  method="exact")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_cli._answer(mrf, args, None, 1.0)
        torch.cuda.synchronize()
        rows.append(dict(query=q, seconds=time.perf_counter() - t0))
        print(f"  {json.dumps(q)}: {rows[-1]['seconds']:.4f} s")
    return rows


#: sub-blocks of the K27 table held against the split's plain version
K27_SPLIT_SUBS = 64


def check_k27_table(oracle, mrf) -> dict:
    """The table kernel at K27 against the chain's oracle table: each value
    within ``split_gap`` (2 e_b), in both directions; and equal to the
    split's plain version (torch.equal) on K27_SPLIT_SUBS sub-blocks
    spread over the 2^15, the first and the last among them."""
    from qcmrf_tpu_torch.ops import kernels

    n = mrf.n
    coef = kernels.moebius_coefficients(mrf)[None]
    table = kernels.logpot_table(mrf.cliques, n, coef, 1.0)[0]
    diff = table - oracle
    gap = float(kernels.split_gap(coef, 1.0)[0])
    over, under = float(diff.max()), float(-diff.min())
    require(max(over, under) <= gap,
            f"K27 table kernel within 2 e_b = {gap:.3e} of the chain's "
            f"oracle table: largest gap {over:.3e} above, {under:.3e} below")
    L = kernels.split_bits(n)
    last = (1 << (n - L)) - 1
    subs = torch.linspace(0, last, K27_SPLIT_SUBS, device=oracle.device
                          ).round().long()
    want = kernels.split_log_potentials_reference(
        kernels.split_plan(mrf.cliques, n, L), coef, 1.0, subs)[0]
    got = table.reshape(-1, 1 << L)[subs]
    require(torch.equal(got, want),
            f"K27 table kernel == split plain version on {len(subs)} "
            f"sub-blocks of 2^{L} states (torch.equal)")
    del table, diff
    return dict(gap_above=over, gap_below=under, split_gap=gap,
                split_max_abs_err=float((got - want).abs().max()))


def check_k27_answers(results, cliques, theta, dev) -> dict:
    """Every K27 answer against the oracle table, the chain's plain
    version (``logpot_table_reference``) on the card, independent of the
    table kernel (2^27 float32, held in float64): lnZ and log masses by
    logsumexp (1e-4), MAP ids by argmax (equal), the probability and the
    marginals by masked sums (1e-5 absolute; evidence-inconsistent rows
    exactly 0). Also holds the table kernel at K27 against the oracle
    (``check_k27_table``)."""
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels

    n = INFER_N
    mrf = MRF.create(cliques, theta=theta, device=dev)
    oracle = kernels.logpot_table_reference(
        mrf.cliques, n, kernels.moebius_coefficients(mrf)[None], 1.0)[0]
    table_check = check_k27_table(oracle, mrf)
    t = oracle.double()
    del oracle
    x = torch.arange(1 << n, device=dev)

    def bit(v):
        return (x >> (n - 1 - v)) & 1

    def lse(sel=None):
        return torch.logsumexp(t if sel is None else
                               torch.where(sel, t, -math.inf), dim=0)

    by = {(r["query"], json.dumps(r["evidence"], sort_keys=True)): r
          for r in results}
    lnz = lse()
    e05 = (bit(0) == 1) & (bit(5) == 0)
    e0 = bit(0) == 1
    cases = [
        (by["lnz", "{}"]["lnz"], float(lnz), "lnZ"),
        (by["lnz", '{"0": 1, "5": 0}']["log_mass"], float(lse(e05)),
         "log mass of 0=1,5=0"),
    ]
    for got, want, what in cases:
        require(abs(got - want) <= 1e-4, f"K27 {what}: {got:.6f} vs table "
                                         f"{want:.6f} (1e-4)")
    p = float(torch.exp(lse(e0 & (bit(3) == 1)) - lse(e0)))
    got = by["prob", '{"0": 1}']["prob"]
    require(abs(got - p) <= 1e-5, f"K27 P(x3=1 | x0=1) {got:.8f} vs table "
                                  f"{p:.8f} (1e-5)")
    for ev, sel in (("{}", None), ('{"0": 1, "5": 0}', e05)):
        r = by["map", ev]
        want = int(torch.argmax(t if sel is None else
                                torch.where(sel, t, -math.inf)))
        require(r["state_id"] == want and abs(r["beta_logpot"]
                                              - float(t[want])) <= 1e-4,
                f"K27 MAP {ev}: state {r['state_id']} == table argmax "
                f"{want}, value within 1e-4")
    for ev, sel, lz in (("{}", None, lnz), ('{"0": 1}', e0, lse(e0))):
        got = torch.tensor(by["marginals", ev]["marginals"],
                           dtype=torch.float64, device=dev)
        want = pairwise_marginals(
            oracle_pair_moments(t, lz, n, None if sel is None
                                else sel.double()), cliques)
        e = float((got - want).abs().max())
        require(e <= 1e-5, f"K27 marginals {ev}: within 1e-5 of the table's "
                           f"masked sums (max |diff| {e:.2e})")
        if sel is not None:
            zero = [4 * k + (2 * a + b) for k, (i, j) in enumerate(cliques)
                    for a in (0, 1) for b in (0, 1)
                    if (i == 0 and a == 0) or (j == 0 and b == 0)]
            require(bool((got[zero] == 0).all()),
                    f"K27 marginals {ev}: the {len(zero)} evidence-"
                    "inconsistent entries are exactly 0")
    masses = []
    for a in range(8):
        sel = ((bit(0) == (a >> 2)) & (bit(1) == ((a >> 1) & 1))
               & (bit(2) == (a & 1)))
        masses.append(float(lse(sel)))
    best = int(np.argmax(masses))
    r = by["mmap", "{}"]
    want = {"0": best >> 2, "1": (best >> 1) & 1, "2": best & 1}
    require(r["max_vars"] == want and abs(r["log_mass"] - masses[best])
            <= 1e-4, f"K27 mmap over 0,1,2: {r['max_vars']} == {want}, "
                     f"log mass within 1e-4")
    del t, x
    torch.cuda.empty_cache()
    return table_check


def phase_chain32(dev) -> None:
    """State ids past 2^31: the streaming MAP and lnZ of a 32-variable
    chain against variable elimination on the card."""
    from qcmrf_tpu_torch.models import elimination
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.runners.infer_cli import _logpot_from_bits

    mrf = seeded_model([[i, i + 1] for i in range(31)], 32, 0.3, dev)
    # clique (0, 1) penalises x_0 = 0: the top id bit of the MAP is 1
    mrf = mrf.with_theta(mrf.theta - torch.tensor(
        [2.0, 2.0] + [0.0] * (mrf.dimension - 2), device=dev))
    t0 = time.perf_counter()
    sid, val = kernels.map_state_streaming(mrf)
    lnz = float(kernels.log_partition(mrf))
    seconds = time.perf_counter() - t0
    bits = [(sid >> (31 - v)) & 1 for v in range(32)]
    want = elimination.map_state_bits(mrf).cpu().tolist()
    lnz_e = float(elimination.log_partition(mrf))
    print(f"[chain32] 2^32 states: MAP id {sid} ({sid / 2**31:.3f} x 2^31), "
          f"lnZ {lnz:.6f} vs elimination {lnz_e:.6f}; both sweeps "
          f"{seconds:.3f} s")
    require(sid >= 1 << 31, "chain32: the MAP id lies past 2^31")
    require(bits == want, "chain32: streaming MAP bits == elimination's")
    host = _logpot_from_bits(mrf, bits)
    require(abs(val - host) <= 1e-4, f"chain32: MAP value {val:.6f} == "
                                     f"theta^T phi of its bits {host:.6f}")
    require(abs(lnz - lnz_e) <= 1e-4, "chain32: lnZ within 1e-4 of "
                                      "elimination")


TRAIN_SAMPLES = 20_000   # the train CLI's default sample count
TRAIN_STEPS = 5


def k27_mu_hat() -> np.ndarray:
    """bench.py's moment target of ``train_wide_k27_step_ms``: uniform(0.1,
    0.5) from RandomState(11) after its theta draw."""
    rs = np.random.RandomState(11)
    d = 4 * len(complete_cliques(INFER_N))
    rs.randn(d)
    return rs.uniform(0.1, 0.5, d)


def two_sweep_moments(mrf) -> torch.Tensor:
    """E_p[phi] of the two sweeps: lnZ by the lse kernel, then the
    moments kernel normalised by it (the fused sweep's yardstick)."""
    from qcmrf_tpu_torch.models import moments
    from qcmrf_tpu_torch.ops import kernels

    return moments.clique_moments_streaming(
        mrf, lnZ=kernels.log_partition(mrf))


def fused_vs_references(mrf, what: str, plain: bool = True) -> dict:
    """The lnz_moments kernel on one model against its plain version and
    against the two sweeps (lse, then moments normalised by it): lnZ
    within 1e-4 and every monomial moment within 1e-5. Returns the
    largest differences and the plain version's milliseconds."""
    from qcmrf_tpu_torch.ops import kernels

    cl, n, coef, beta, lnz2, masks = infer_kernel_args(mrf)
    lnz, mono = kernels.combine_lnz_moments(
        *kernels.lnz_moments_partials(cl, n, coef, beta, masks))
    mono2 = kernels.monomial_moments(cl, n, coef, beta, lnz2, masks)
    out = dict(lnz=abs(float(lnz[0]) - float(lnz2[0])),
               moments=float((mono - mono2).abs().max()), plain_ms=None)
    require(out["lnz"] <= 1e-4 and out["moments"] <= 1e-5,
            f"{what}: lnz_moments kernel == lse + moments kernels (lnZ "
            f"{out['lnz']:.2e}, moments {out['moments']:.2e}; 1e-4, 1e-5)")
    if plain:
        (pm, ps), out["plain_ms"] = timed_once(
            lambda: kernels.lnz_moments_partials_reference(cl, n, coef, beta,
                                                           masks))
        plnz, pmono = kernels.combine_lnz_moments(pm, ps)
        e_lnz = abs(float(lnz[0]) - float(plnz[0]))
        e_mom = float((mono - pmono).abs().max())
        require(e_lnz <= 1e-4 and e_mom <= 1e-5,
                f"{what}: lnz_moments kernel == plain version (lnZ "
                f"{e_lnz:.2e}, moments {e_mom:.2e} over {masks.numel()} "
                "monomials; 1e-4, 1e-5)")
        out["lnz"] = max(out["lnz"], e_lnz)
        out["moments"] = max(out["moments"], e_mom)
        del pm, ps
    torch.cuda.empty_cache()
    return out


def run_train_cli(argv, record=False):
    """``train_cli.main(argv)`` on the card with the launch counts reset
    just before and read just after: ``(fitted doc, launches, seconds,
    steps)``. With ``record``, ``steps`` lists each exact step's theta
    before the update, its loss and its launches (the step function is
    wrapped; the CLI is not changed)."""
    import contextlib
    import io

    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.runners import train_cli

    steps = []
    orig = mtrain.make_train_step

    def recording(template, optimizer, nonpositive=True):
        step = orig(template, optimizer, nonpositive)
        raw = optimizer.param_groups[0]["params"][0]

        def wrapped(batch):
            theta = mtrain._to_theta(raw, nonpositive).detach().clone()
            before = read_counts()
            loss = float(step(batch))
            after = read_counts()
            steps.append(dict(theta=theta, loss=loss, launches={
                k: after[k] - before[k] for k in after}))
            return loss

        return wrapped

    if record:
        mtrain.make_train_step = recording
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = train_cli.main(argv + ["--platform", "gpu"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    finally:
        mtrain.make_train_step = orig
    with open(out) as f:
        return json.load(f), launches, seconds, steps


def phase_train(dev, report) -> dict:
    """Exact-MLE training on bench.py's K27 complete graph (width 27 > 25:
    every gradient goes through the fused lnz_moments kernel): data from
    ``sample_exact`` on the card, ``train_cli.main`` for 5 steps, each
    step's loss held against lnZ of the lse kernel; the K27 step timed
    (``train_wide_k27_step_ms``) beside the two sweeps it replaces; the
    kernel against its plain version and the two-sweep kernels at K27 and
    n = 20; the NLL's gradient against beta (mu - mu_hat) of the two
    sweeps; the table and elimination routes of the CLI, and the
    enumeration route of make_lnz_fn. Returns the launch counts of the
    K27 CLI run."""
    from qcmrf_tpu_torch.evaluation.estimators import (
        clique_marginals_from_samples)
    from qcmrf_tpu_torch.models import sample
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.utils import moebius

    n = INFER_N
    cliques = complete_cliques(n)
    mrf = MRF.create(cliques, theta=k27_theta(), device=dev)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "train_k27")
    os.makedirs(out_dir, exist_ok=True)
    graph = os.path.join(out_dir, "k27.json")
    with open(graph, "w") as f:
        json.dump(cliques, f)

    print("[train] K27 (bench.py's wide model): exact MLE through the fused "
          "lnz_moments kernel")
    reset_counts()
    x, sample_ms = timed_once(lambda: sample.sample_exact(11, mrf,
                                                          TRAIN_SAMPLES))
    k27_tables = read_counts()["logpot"]
    require(k27_tables == 1, "sample_exact K27: one logpot launch (its 2^27 "
                             f"table; {k27_tables} counted)")
    report["logpot"]["launches_by_path"]["sample_exact K27"] = k27_tables
    require(x.shape == (TRAIN_SAMPLES,) and int(x.min()) >= 0
            and int(x.max()) < 1 << n,
            f"sample_exact: {TRAIN_SAMPLES} K27 state ids in [0, 2^27) on "
            f"the card, {sample_ms:.1f} ms (two-stage draw)")
    sample_ms = cuda_ms(lambda: sample.sample_exact(11, mrf, TRAIN_SAMPLES),
                        reps=3)
    table_ms = report["logpot"]["k27"]["ms"]
    print(f"  sample_exact K27, {TRAIN_SAMPLES} draws: {sample_ms:.3f} ms "
          f"(CUDA events, 3 calls), of which its 2^27 table {table_ms:.3f} "
          f"ms (bound {report['logpot']['k27']['bound_ms']:.4f} ms)")
    data = os.path.join(out_dir, "data.json")
    with open(data, "w") as f:
        json.dump(x.cpu().tolist(), f)
    mu_data = clique_marginals_from_samples(mrf, x)
    mu = two_sweep_moments(mrf).double()
    gap = float((mu_data - mu).abs().max())
    require(gap <= 0.02, f"the samples' clique marginals within 0.02 of the "
                         f"exact ones ({gap:.4f}; 20 000 draws)")

    m_mono = moebius.monomial_layout(mrf.cliques).m
    per_launch = kernels.moments_per_launch(mrf.cliques, n)
    print(f"  K27: {m_mono} monomials, moments_per_launch {per_launch}")
    doc, launches, seconds, steps = run_train_cli(
        ["--graph", graph, "--data", data, "--steps", str(TRAIN_STEPS),
         "--checkpoint-every", str(TRAIN_STEPS),
         "--outdir", os.path.join(out_dir, "cli")], record=True)
    print(f"  train_cli K27, {TRAIN_STEPS} steps: {seconds:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    require(len(steps) == TRAIN_STEPS, f"{TRAIN_STEPS} steps recorded")
    for i, s in enumerate(steps):
        lm = s["launches"]
        require(lm["lnz_moments"] == 1 and lm["lse"] == 0
                and lm["moments"] == 0,
                f"step {i + 1}: lnz_moments launched once, lse and moments "
                "never")
        lnz = float(kernels.log_partition(mrf.with_theta(s["theta"])))
        want = lnz - float(mrf.beta * (s["theta"].double() * mu_data).sum())
        require(abs(s["loss"] - want) <= 1e-4,
                f"step {i + 1}: loss {s['loss']:.6f} == lnZ (lse kernel) - "
                f"beta theta^T mu_hat = {want:.6f} (1e-4)")
    require(doc["final_nll"] == steps[-1]["loss"]
            and len(doc["theta"]) == mrf.dimension
            and os.path.isdir(os.path.join(out_dir, "cli", "ckpt",
                                           str(TRAIN_STEPS))),
            "fitted_model.json holds the last step's loss and 1404 thetas; "
            f"ckpt/{TRAIN_STEPS} written")
    profiled("train_cli K27, one step", report, lambda: run_train_cli(
        ["--graph", graph, "--data", data, "--steps", "1",
         "--outdir", os.path.join(out_dir, "one")]))

    # the K27 step in bench.py's meaning, and the two sweeps it replaces
    raw = mtrain._from_theta(mrf.theta, True).requires_grad_()
    step = mtrain.make_moment_train_step(mrf, mtrain.adam([raw], 5e-2),
                                         k27_mu_hat())
    before = kernels.LAUNCHES["lnz_moments"]
    step_ms = cuda_ms(step, reps=5)
    require(kernels.LAUNCHES["lnz_moments"] - before == 6,
            "make_moment_train_step: one lnz_moments launch a step")
    args = infer_kernel_args(mrf)
    cl, _, coef, beta, _, masks = args
    two_ms = cuda_ms(lambda: kernels.monomial_moments(
        cl, n, coef, beta, kernels.combine_lse(*kernels.lse_partials(
            cl, n, coef, beta)).float(), masks), reps=5)
    fused_ms = cuda_ms(lambda: kernels.lnz_moments_partials(
        cl, n, coef, beta, masks), reps=5)
    print(f"  train_wide_k27_step_ms {step_ms:.3f}; lnz_moments kernel "
          f"{fused_ms:.3f} ms; lse + moments kernels {two_ms:.3f} ms")

    err = fused_vs_references(mrf, "K27")
    plain_ms = err["plain_ms"]
    for what, m in (("K20", seeded_model(complete_cliques(20), 20, 0.05,
                                         dev)),
                    ("3/4/5-variable ring n=20",
                     seeded_model(mixed_cliques(20), 5, 0.3, dev))):
        e = fused_vs_references(m, what)
        err = {k: max(err[k], e[k]) for k in ("lnz", "moments")}

    # the NLL's gradient on the card: the fused sweep as the backward
    theta = mrf.theta.clone().requires_grad_()
    (grad,) = torch.autograd.grad(mrf.with_theta(theta).nll(x), theta)
    want = (mrf.beta * (mu - mu_data)).float()
    g_err = float((grad - want).abs().max())
    require(g_err <= 1e-5, f"K27: autograd.grad of MRF.nll == beta (mu - "
                           f"mu_hat) of the two sweeps within 1e-5 "
                           f"({g_err:.2e})")

    # the other routes: the table (n = 20, _nll's enumeration branch and
    # make_lnz_fn's; the CLI draws its own data there, through
    # sample_exact and so one table launch), and elimination on bit-array
    # data (a 32-chain)
    grid = grid_model(4, 5, 0, dev)
    gdoc, glaunch, gsec, _ = run_train_cli(
        ["--graph", "grid:4x5", "--samples", str(TRAIN_SAMPLES),
         "--data-seed", "5", "--steps", "3",
         "--outdir", os.path.join(out_dir, "grid")])
    require(glaunch["lnz_moments"] == 3 and glaunch["logpot"] == 1
            and math.isfinite(gdoc["final_nll"]),
            f"table route (grid 4x5, n=20, the CLI's own data): 3 steps, 3 "
            f"lnz_moments launches, 1 logpot launch (sample_exact's table), "
            f"final nll {gdoc['final_nll']:.4f} ({gsec:.2f} s)")
    report["logpot"]["launches_by_path"]["train_cli grid 4x5"] = glaunch[
        "logpot"]
    gtheta = grid.theta.clone().requires_grad_()
    (g,) = torch.autograd.grad(mtrain.make_lnz_fn(grid)(gtheta), gtheta)
    e = float((g - grid.beta * two_sweep_moments(grid)).abs().max())
    require(e <= 1e-5, f"make_lnz_fn enumeration route (n=20): gradient == "
                       f"beta mu of the two sweeps ({e:.2e})")
    bits = (np.random.RandomState(32).rand(4096, 32) < 0.3).astype(int)
    bpath = os.path.join(out_dir, "chain32_bits.json")
    with open(bpath, "w") as f:
        json.dump(bits.tolist(), f)
    edoc, elaunch, esec, _ = run_train_cli(
        ["--graph", "chain:32", "--data", bpath, "--steps", "3",
         "--outdir", os.path.join(out_dir, "chain32")])
    require(sum(elaunch.values()) == 0 and math.isfinite(edoc["final_nll"]),
            f"elimination route (32-chain, bit-array data): 3 steps, no "
            f"kernel launch, final nll {edoc['final_nll']:.4f} ({esec:.2f} s)")

    # bytes: the partials written and the masks read. Operations: the
    # split's count; the per-state chain's beside it (the chains and beta,
    # a max, the exp of v - M, and a mask test and an add per monomial a
    # state)
    parts = kernels.lse_geometry(1 << n)[0]
    nbytes = 4 * parts * (m_mono + 1) + 8 * m_mono
    ops = split_ops(cliques, n, m_mono)
    chain = (chain_flops(cliques) + 4 + 2 * m_mono) << n
    b = bound(nbytes, ops)
    chain_bound = bound(nbytes, chain)["bound_ms"]
    print(f"  lnz_moments: kernel {fused_ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) from the "
          f"split's {ops:.4e} operations (the chain's {chain:.4e}: "
          f"{chain_bound:.3f} ms) at 2^{n} states, K={len(cliques)}, "
          f"{m_mono} monomials")
    report["lnz_moments"] = dict(
        max_abs_err=max(err["lnz"], err["moments"]),
        lnz_err=err["lnz"], moments_err=err["moments"], ms=fused_ms,
        plain_ms=plain_ms, **b, split_ops=ops, chain_ops=chain,
        chain_bound_ms=chain_bound,
        shape=f"K{n} pairwise, 2^{n} states, {m_mono} monomials")
    report["train"] = dict(
        train_wide_k27_step_ms=step_ms, two_sweep_ms=two_ms,
        cli_seconds=seconds, sample_exact_ms=sample_ms,
        sample_exact_table_ms=table_ms,
        losses=[s["loss"] for s in steps], grad_err=g_err,
        moments_per_launch=per_launch)
    del x, mu, mu_data
    torch.cuda.empty_cache()
    return launches


#: generic gate kernel -> the op kinds of the planner that launch it
GATE_KERNEL_OPS = {"lane_factored": ("lane",),
                   "row_gate": ("rowq", "row2"), "diag": ("diag",),
                   "hdh_multi": ("sandwich", "sandwichk")}


def unit_planes(nq, seed, dev):
    """Random planes of a unit-norm state."""
    re, im = random_planes(nq, seed, dev)
    scale = math.sqrt(norm_float64(re, im))
    return re.div_(scale), im.div_(scale)


def hadamard_wall():
    """The planner's composed lane op of H on qubits 0-6."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.sim.dense import GATES_1Q

    H = np.asarray(GATES_1Q["h"], np.complex64)
    M = np.eye(128, dtype=np.complex64)
    for q in range(7):
        M = K._lane_gate_matrix(H, q) @ M
    return M


def gate_cases(nq):
    """(kernel, label, wrapper, plain version, arguments after the planes)
    of every generic gate case held at width ``nq``."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.sim.dense import GATES_1Q

    rng = np.random.RandomState(nq)
    cases = []
    # a condition on the top bit, and a term with no condition
    special = (((nq - 1, 1), (4, 0)), ())
    for count in (1, 12, 64):
        terms = special[:1] if count == 1 else tuple(
            tuple((int(p), int(rng.randint(2))) for p in
                  rng.choice(nq, rng.randint(1, 4), replace=False))
            for _ in range(count - 2)) + special
        angles = tuple(rng.uniform(-np.pi, np.pi, count))
        cases.append(("diag", f"diag, {count} terms",
                      K.apply_diagonal_profile,
                      K.apply_diagonal_profile_reference,
                      (terms, angles, 0.3)))
    cases.append(("diag", "masked rotation", K.apply_masked_rotation,
                  K.apply_masked_rotation_reference,
                  (((nq - 1, 1), (7, 0)), -0.2, 1.3)))
    U = (rng.randn(2, 2) + 1j * rng.randn(2, 2)).astype(np.complex64) / 2
    for q in (7, 15, nq - 1):
        cases.append(("row_gate", f"rowq q={q}", K.apply_1q,
                      K.apply_1q_reference, (U, q, nq)))
    U4 = (rng.randn(4, 4) + 1j * rng.randn(4, 4)).astype(np.complex64) / 3
    for q_lo in (7, nq - 2):
        cases.append(("row_gate", f"row2 q_lo={q_lo}", K.apply_2q_row_pair,
                      K.apply_2q_row_pair_reference, (U4, q_lo)))
    M = ((rng.randn(128, 128) + 1j * rng.randn(128, 128)) / 16).astype(
        np.complex64)
    H = np.asarray(GATES_1Q["h"], np.complex64)
    for label, lane_op in (("lane, H on qubit 3", K._lane_gate_matrix(H, 3)),
                           ("lane, the 7-H wall", hadamard_wall()),
                           ("lane, random complex M", M)):
        cases.append(("lane", label, K.apply_lane, K.apply_lane_reference,
                      (lane_op,)))
    wall = np.tile(H, (7, 1, 1))
    for label, factors in (
            ("lane_factored, 1 random factor", random_factors(rng, 1)),
            ("lane_factored, 3 random factors", random_factors(rng, 3)),
            ("lane_factored, 7 random factors", random_factors(rng, 7)),
            ("lane_factored, the 7-H wall", wall)):
        cases.append(("lane_factored", label, K.apply_lane_factored,
                      K.apply_lane_factored_reference, (factors,)))
    return cases


def random_factors(rng, count):
    """Lane factors: random unitaries on ``count`` lane qubits, the
    identity on the others."""
    from qcmrf_tpu_torch.ops import kernels as K

    factors = K.identity_factors()
    for q in rng.choice(7, count, replace=False):
        a = rng.randn(2, 2) + 1j * rng.randn(2, 2)
        factors[q] = np.linalg.qr(a)[0].astype(np.complex64)
    return factors


def stream_cases(ops):
    """(kernel, label, wrapper, plain version, arguments after the planes)
    of the lowered width-28 chain's own passes: the first diag pass of
    each term count and the first with a condition on the top bit, the
    rowq passes on the stream's lowest and highest qubit, every row2 pass,
    the first and last lane pass and the one with the most nonzeros."""
    from qcmrf_tpu_torch.ops import kernels as K

    nq = LOWERED_WIDTH
    calls = {
        "diag": ("diag", K.apply_diagonal_profile,
                 K.apply_diagonal_profile_reference, lambda op: op[1:]),
        "rowq": ("row_gate", K.apply_1q, K.apply_1q_reference,
                 lambda op: (op[1], op[2], nq)),
        "row2": ("row_gate", K.apply_2q_row_pair,
                 K.apply_2q_row_pair_reference, lambda op: op[1:]),
        "lane": ("lane_factored", K.apply_lane_factored,
                 K.apply_lane_factored_reference, lambda op: (op[2],)),
    }
    rowq = [op[2] for op in ops if op[0] == "rowq"]
    lanes = [i for i, op in enumerate(ops) if op[0] == "lane"]
    densest = densest_lane(ops)
    picked = {}
    for i, op in enumerate(ops):
        if op[0] == "diag":
            picked.setdefault(f"diag, {len(op[1])} terms", i)
            if any(p == nq - 1 for conds in op[1] for p, _ in conds):
                picked.setdefault(f"diag on bit {nq - 1}", i)
        elif op[0] == "rowq" and op[2] in (min(rowq), max(rowq)):
            picked.setdefault(f"rowq q={op[2]}", i)
        elif op[0] == "row2":
            picked[f"row2 q_lo={op[2]}, pass {i}"] = i
        elif i in (lanes[0], lanes[-1], densest):
            factors = bin(K.lane_factor_mask(op[2])).count("1")
            picked[f"lane, {np.count_nonzero(op[1])} nonzeros, {factors} "
                   f"factors, pass {i}"] = i
    cases = []
    for label, i in picked.items():
        kind, fn, ref, args = calls[ops[i][0]]
        cases.append((kind, f"stream: {label}", fn, ref, args(ops[i])))
    return cases


def densest_lane(ops) -> int:
    """Index of the stream's lane op with the most nonzeros in its M."""
    lanes = [i for i, op in enumerate(ops) if op[0] == "lane"]
    return max(lanes, key=lambda i: np.count_nonzero(ops[i][1]))


#: the case of each kernel whose plain version is timed at width 24
TIMED_CASE = {"diag": "diag, 12 terms", "row_gate": "rowq q=15",
              "lane": "lane, the 7-H wall",
              "lane_factored": "lane_factored, 7 random factors"}


def lane_library(M, nq, dev):
    """One float32 torch.matmul (no TF32) computing the lane op on planes
    stacked as (rows, 256): [re, im] @ [[Mr^T, Mi^T], [-Mi^T, Mr^T]].
    Returns (run, the stacked planes, its output, split): split turns a
    stacked tensor back into a pair of planes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mr = torch.from_numpy(np.ascontiguousarray(M.real)).to(dev)
    mi = torch.from_numpy(np.ascontiguousarray(M.imag)).to(dev)
    W = torch.cat([torch.cat([mr.T, mi.T], 1), torch.cat([-mi.T, mr.T], 1)])
    X = torch.cat(unit_planes(nq, 9, dev), 1)
    out = torch.empty_like(X)

    def split(T):
        return T[:, :128].contiguous(), T[:, 128:].contiguous()
    return (lambda: torch.matmul(X, W, out=out)), X, out, split


def row_library(U, q_lo, k, nq, dev):
    """One float32 torch.matmul (no TF32) computing a row pass on planes
    stacked as (g, [re, im] x 2^k, 2^q_lo): the real block [[Ur, -Ui],
    [Ui, Ur]] times every group. Returns (run, the stacked planes, its
    output, split), as :func:`lane_library`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, S = 1 << k, 1 << q_lo
    U = np.asarray(U, np.complex64)
    W = torch.from_numpy(np.block([[U.real, -U.imag], [U.imag, U.real]])
                         .astype(np.float32)).to(dev)
    re, im = unit_planes(nq, 9, dev)
    shape = re.shape
    X = torch.cat([re.view(-1, n, S), im.view(-1, n, S)], 1)
    del re, im
    out = torch.empty_like(X)

    def split(T):
        return (T[:, :n].contiguous().view(shape),
                T[:, n:].contiguous().view(shape))
    return (lambda: torch.matmul(W, X, out=out)), X, out, split


def rel_diff(got, want, chunk=1 << 26) -> float:
    """``|got - want|_2 / |want|_2`` over pairs of planes, in float64."""
    num = den = 0.0
    for g, w in zip(got, want):
        g, w = g.reshape(-1), w.reshape(-1)
        for lo in range(0, g.numel(), chunk):
            a, b = g[lo:lo + chunk].double(), w[lo:lo + chunk].double()
            num += float(((a - b) ** 2).sum())
            den += float((b ** 2).sum())
    return (num / den) ** 0.5


def hold_library(label, library, apply) -> float:
    """Runs a library call and the kernel (``apply``, in place on the
    same input split into planes) and requires them within 1e-5 and
    within a relative 2-norm of 2e-6; returns the library call's mean
    ms."""
    run, X, out, split = library
    run()
    planes_ = split(X)
    apply(*planes_)
    e = max(float((a - b).abs().max()) for a, b in zip(planes_, split(out)))
    rel = rel_diff(planes_, split(out))
    require(e <= 1e-5 and rel <= 2e-6,
            f"{label}: torch.matmul (float32, no TF32) == kernel within "
            f"1e-5 (max |diff| {e:.2e}) and a relative 2-norm of 2e-6 "
            f"({rel:.2e})")
    del planes_
    return cuda_ms(run, reps=3)


def check_lane_float64(dev, ops, report) -> None:
    """The dense lane kernel against the float64 product of the same
    input at widths 8, 24 and 28, on the random M, the 7-H wall and the
    lowered stream's densest lane op given without its factors: a
    relative 2-norm error of at most 2e-6 and at most 4x that of one
    float32 torch.matmul (no TF32) on the same input (one TF32 pass is
    about 3e-4 off: runners/lane_designs.py)."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.runners import lane_designs as LD

    torch.backends.cuda.matmul.allow_tf32 = False
    M = next(c[4][0] for c in gate_cases(GATE_PASS_WIDTH)
             if c[1] == "lane, random complex M")
    stream = dense_lanes([ops[densest_lane(ops)]])[0]
    lanes = {"random complex M": M, "the 7-H wall": hadamard_wall(),
             f"the stream's densest lane op, bare ({stream[0]}, M)":
             stream[1]}
    worst = {}
    for nq in (8, GATE_PASS_WIDTH, LOWERED_WIDTH):
        for label, lane_op in lanes.items():
            src = unit_planes(nq, 5, dev)
            got = K.apply_lane(src[0].clone(), src[1].clone(), lane_op)
            rel = LD.relative_error(lane_op, src, got)
            del got
            X = torch.cat([p.reshape(-1, 128) for p in src], 1)
            f32 = LD.relative_error(lane_op, src,
                                    X @ LD.stacked_w(lane_op, dev))
            del X, src
            torch.cuda.empty_cache()
            require(LD.accurate(rel, f32),
                    f"lane at width {nq}, {label}: {rel:.3e} from the "
                    f"float64 product, <= {LD.REL_LIMIT:.0e} and <= "
                    f"{LD.F32_FACTOR:.0f} x float32 torch.matmul's "
                    f"{f32:.3e}")
            worst[f"w{nq} {label}"] = dict(rel=rel, f32_rel=f32)
    report["lane_float64"] = worst


def sass_counts(path, kernel: str) -> dict:
    """Instructions of ``kernel`` (a mangled-name fragment) in the built
    library by opcode, from ``cuobjdump -sass``."""
    from qcmrf_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    sass = next(f for f in text.split("Function : ")[1:]
                if kernel in f.splitlines()[0])
    counts = {}
    for t in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", sass):
        op = t.split()[1] if t.startswith("@") else t.split()[0]
        counts[op] = counts.get(op, 0) + 1
    return counts


def phase_library_calls(dev, ops, report) -> None:
    """At the main run's width 28: the factored lane kernel against
    torch.matmul on the stream's densest lane op (the same function), the
    dense lane kernel against torch.matmul on the random M (both timed on
    that M in turns; no main path launches the dense kernel), and the row
    kernel against torch.matmul on every (K, qubit) of the lowered chain's
    row passes; each library call timed, the row call's time weighted by
    the stream's passes."""
    from qcmrf_tpu_torch.ops import kernels as K

    nq = LOWERED_WIDTH
    densest = ops[densest_lane(ops)]
    report["lane_factored_library_ms"] = hold_library(
        f"lane_factored at width {nq}, the stream's densest lane op "
        f"({np.count_nonzero(densest[1])} nonzeros)",
        lane_library(densest[1], nq, dev),
        lambda re, im: K.apply_lane_factored(re, im, densest[2]))
    M = next(c[4][0] for c in gate_cases(GATE_PASS_WIDTH)
             if c[1] == "lane, random complex M")
    library = lane_library(M, nq, dev)
    hold_library(f"lane at width {nq}, random complex M", library,
                 lambda re, im: K.apply_lane(re, im, M))
    re, im = unit_planes(nq, 9, dev)
    # in turns on the same M and the same card: library, kernel, kernel,
    # library (the M is not unitary: four passes grow the state ~4x)
    lib_ms, lane_ms = [], []
    for timed in ("library", "kernel", "kernel", "library"):
        if timed == "library":
            lib_ms.append(cuda_ms(library[0], reps=3))
        else:
            lane_ms.append(cuda_ms(lambda: K.apply_lane(re, im, M), reps=3))
    del re, im, library
    torch.cuda.empty_cache()
    ops_per_value = 1024
    report["lane_library_ms"] = sum(lib_ms) / 2
    report["lane_w28"] = dict(
        ms=sum(lane_ms) / 2, ms_turns=lane_ms, library_ms_turns=lib_ms,
        library_ms=report["lane_library_ms"],
        shape=f"2^{nq} values, a random complex M (the library call on "
              "the same M, in turns)",
        bound_ms=3 * ops_per_value * (1 << nq) / H100_TF32_PER_S * 1e3,
        bound_by="operations",
        bound_note="3xTF32: three TF32 products a float32 one at the "
                   "dense TF32 rate; bound_bytes_ms and bound_f32_ms "
                   "beside it",
        bound_bytes_ms=(16 << nq) / H100_BYTES_PER_S * 1e3,
        bound_f32_ms=ops_per_value * (1 << nq) / H100_F32_PER_S * 1e3)
    row = report["lane_w28"]
    print(f"  dense lane kernel at 2^{nq} values, random M: "
          f"{row['ms']:.4f} ms a pass ({lane_ms}); torch.matmul "
          f"{row['library_ms']:.4f} ms ({lib_ms}); bounds "
          f"{row['bound_ms']:.3f} (3xTF32 operations), "
          f"{row['bound_bytes_ms']:.3f} (bytes), {row['bound_f32_ms']:.3f} "
          f"(float32 FMA); the densest lane op's torch.matmul "
          f"{report['lane_factored_library_ms']:.4f} ms")
    require(max(lane_ms) < min(lib_ms),
            f"dense lane kernel faster than torch.matmul on the same M "
            f"at width {nq} ({max(lane_ms):.3f} < {min(lib_ms):.3f} ms)")
    rows = [op for op in ops if op[0] in ("rowq", "row2")]
    by_key = {}
    for op in rows:
        key = (1 if op[0] == "rowq" else 2, op[2])
        if key not in by_key:
            k, q = key
            by_key[key] = hold_library(
                f"row K={k} at qubit {q}, width {nq}",
                row_library(op[1], q, k, nq, dev),
                lambda re, im: (K.apply_1q(re, im, op[1], q) if k == 1 else
                                K.apply_2q_row_pair(re, im, op[1], q)))
            torch.cuda.empty_cache()
    lib = sum(by_key[(1 if op[0] == "rowq" else 2, op[2])]
              for op in rows) / len(rows)
    print(f"  library calls at 2^{nq} values: row {lib:.4f} ms a pass "
          f"(mean over the stream's "
          f"{len(rows)} row passes; by (K, qubit): "
          + ", ".join(f"{k}:{ms:.3f}" for k, ms in sorted(by_key.items()))
          + ")")
    report["row_gate_library_ms"] = lib
    report["row_library_by_qubit"] = {f"K={k} q={q}": ms for (k, q), ms
                                      in sorted(by_key.items())}
    torch.cuda.empty_cache()


def phase_gate_kernels(dev, report):
    """Each generic gate kernel against its plain version on unit-norm
    planes (copies: the passes work in place), atol 1e-5: at width 24,
    where the plain versions are timed, and at the main run's width 28,
    with the lowered chain's own passes; then the library calls at 28."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.sim import planes

    ops = planes.fuse_ops(lowered_chain(LOWERED_WIDTH // 2)[1])
    err = {w: dict(diag=0.0, row_gate=0.0, lane=0.0, lane_factored=0.0,
                   copy=0.0) for w in (GATE_PASS_WIDTH, LOWERED_WIDTH)}
    err[8] = dict(lane=0.0, lane_factored=0.0)
    plain = {}
    # width 8 (two rows): both lane kernels on every lane case, and the
    # copy at width 7 (one row)
    small = [c for c in gate_cases(GATE_PASS_WIDTH) + stream_cases(ops)
             if c[0] in ("lane", "lane_factored")]
    print(f"[gate kernels] width 8: {len(small)} lane cases; the copy at "
          "width 7")
    for kind, label, fn, ref, args in small:
        got = fn(*unit_planes(8, 2, dev), *args)
        want = ref(*unit_planes(8, 2, dev), *args)
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        err[8][kind] = max(err[8][kind], e)
        require(e <= 1e-5, f"{label}, width 8: kernel == plain version "
                           f"within 1e-5 (max |diff| {e:.2e})")
    src = unit_planes(7, 4, dev)
    out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
    K.copy_planes(*src, out=out)
    require(torch.equal(out[0], src[0]) and torch.equal(out[1], src[1]),
            "copy kernel at width 7: both planes copied exactly")
    for nq in (GATE_PASS_WIDTH, LOWERED_WIDTH):
        cases = gate_cases(nq)
        if nq == LOWERED_WIDTH:
            cases += stream_cases(ops)
        print(f"[gate kernels] width {nq}: {len(cases) + 1} cases, kernel vs "
              "plain version on unit-norm planes")
        for kind, label, fn, ref, args in cases:
            got = fn(*unit_planes(nq, 2, dev), *args)
            want = ref(*unit_planes(nq, 2, dev), *args)
            e = max(float((g - w).abs().max()) for g, w in zip(got, want))
            err[nq][kind] = max(err[nq][kind], e)
            require(e <= 1e-5, f"{label}: kernel == plain version within "
                               f"1e-5 (max |diff| {e:.2e})")
            del got, want
            torch.cuda.empty_cache()
            if nq == GATE_PASS_WIDTH and TIMED_CASE[kind] == label:
                planes_ = unit_planes(nq, 3, dev)
                plain[kind] = dict(
                    plain_ms=cuda_ms(lambda: ref(*planes_, *args), reps=3),
                    ms_at_plain_shape=cuda_ms(lambda: fn(*planes_, *args),
                                              reps=10),
                    plain_shape=f"2^{nq} values, {label}")
                del planes_
        src = unit_planes(nq, 4, dev)
        out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
        K.copy_planes(*src, out=out)
        err[nq]["copy"] = max(float((o - s).abs().max())
                              for o, s in zip(out, src))
        require(torch.equal(out[0], src[0]) and torch.equal(out[1], src[1]),
                f"copy kernel at width {nq}: both planes copied exactly")
        if nq == GATE_PASS_WIDTH:
            plain["copy"] = dict(
                plain_ms=cuda_ms(lambda: K.copy_planes_reference(
                    *src, out=out), reps=10),
                ms_at_plain_shape=cuda_ms(lambda: K.copy_planes(
                    *src, out=out), reps=10),
                plain_shape=f"2^{nq} values, both planes")
        del src, out
        torch.cuda.empty_cache()
    for kind, row in plain.items():
        by_width = {w: e[kind] for w, e in sorted(err.items()) if kind in e}
        print(f"  {kind}: max |kernel - plain| {by_width}; plain "
              f"{row['plain_ms']:.3f} ms, kernel "
              f"{row['ms_at_plain_shape']:.4f} ms ({row['plain_shape']})")
        report.setdefault("gate_w24", {})[kind] = dict(
            max_abs_err=max(by_width.values()),
            err_shape=f"max over widths {sorted(by_width)}: {by_width}",
            **row)
    check_lane_float64(dev, ops, report)
    phase_library_calls(dev, ops, report)


def lowered_chain(nn):
    """bench.py's chain of nn variables as a QCMRF, with its lowering to
    the [cx, id, rz, sx, x] basis (fused style)."""
    from qcmrf_tpu_torch.circuits.compiler import QCMRF

    theta = -np.abs(np.random.RandomState(0).randn(4 * (nn - 1))) * 0.3
    q = QCMRF.build([[i, i + 1] for i in range(nn - 1)], theta=theta,
                    with_measurements=False)
    return q, q.lowered(style="fused")


def diff_norm(a, b, chunk=1 << 26) -> float:
    """2-norm of the difference of two pairs of planes, in float64 over
    chunks."""
    total = 0.0
    for x, y in zip(a, b):
        fx, fy = x.view(-1), y.view(-1)
        for s in range(0, fx.numel(), chunk):
            total += float(((fx[s:s + chunk] - fy[s:s + chunk]).double()
                            ** 2).sum())
    return math.sqrt(total)


def phase_lowered_chain(dev, report) -> dict:
    """The main run: bench.py's width-28 chain lowered to basis gates
    through planes.run_statevector, each kernel's launches equal to its op
    kind's count in the stream, the state against the unlowered chain's.
    Then each kernel's ops of that stream alone, timed. Returns the launch
    counts."""
    from qcmrf_tpu_torch.sim import planes

    nq = LOWERED_WIDTH
    q, low = lowered_chain(nq // 2)
    t0 = time.perf_counter()
    ops = planes.fuse_ops(low)
    plan_ms = (time.perf_counter() - t0) * 1e3
    kinds = {}
    for op in ops:
        kinds[op[0]] = kinds.get(op[0], 0) + 1
    print(f"[lowered chain] qcmrf{nq} lowered: {len(low.gates)} basis gates "
          f"-> {len(ops)} passes {kinds}; planner {plan_ms:.1f} ms")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    re, im = planes.run_statevector(low, device=dev)
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = start.elapsed_time(end)
    b_ms = stream_bound(ops, nq)["bound_ms"]
    dense_ms = stream_bound(dense_lanes(ops), nq)["bound_ms"]
    lane_ms = sum(bound(0, pass_flops([op], nq))["bound_ms"]
                  for op in dense_lanes(ops) if op[0] == "lane")
    print(f"  qcmrf{nq}_lowered_gate_level_ms {ms:.1f} ({seconds:.3f} s on "
          f"the host clock, planner included); {len(ops)} passes; bound "
          f"{b_ms:.1f} ms with the lane passes counted by their factors "
          f"(bytes); counted as dense products, as before the factored "
          f"pass: {dense_ms:.1f} ms ({dense_ms - lane_ms:.1f} of bytes, "
          f"{lane_ms:.1f} of lane operations); peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}")
    for k, op_kinds in GATE_KERNEL_OPS.items():
        want = sum(kinds.get(o, 0) for o in op_kinds)
        require(launches[k] == want,
                f"kernel {k} launched {launches[k]} times, the stream's "
                f"{'+'.join(op_kinds)} ops: {want}")
    require(launches["lane"] == 0, f"the dense lane kernel launched "
                                   f"{launches['lane']} times (expected 0)")
    want = planes.run_statevector(q.circuit, device=dev)
    d = diff_norm((re, im), want)
    norm = norm_float64(re, im)
    require(d <= 1e-4, f"width {nq}: lowered state == unlowered chain's "
                       f"(global phase included) within 1e-4 in 2-norm "
                       f"({d:.2e}); norm {norm:.7f}")
    del want
    torch.cuda.empty_cache()
    per_kind = {}
    for k, op_kinds in GATE_KERNEL_OPS.items():
        sub = [op for op in ops if op[0] in op_kinds]
        total = cuda_ms(lambda: planes.apply_ops(re, im, sub, nq), reps=1)
        b = stream_bound(sub, nq)
        per_kind[k] = dict(ms=total / len(sub),
                           bound_ms=b["bound_ms"] / len(sub),
                           bound_by=b["bound_by"], total_ms=total,
                           passes=len(sub))
        print(f"  {k}: {len(sub)} passes {total:.1f} ms, "
              f"{per_kind[k]['ms']:.4f} ms a pass, bound "
              f"{per_kind[k]['bound_ms']:.4f} ms")
    del re, im
    torch.cuda.empty_cache()
    report["lowered"] = dict(
        qcmrf28_lowered_gate_level_ms=ms, host_seconds=seconds,
        passes=len(ops), kinds=kinds, gates=len(low.gates), plan_ms=plan_ms,
        bound_ms=b_ms, dense_lane_bound_ms=dense_ms,
        dense_lane_op_bound_ms=lane_ms, peak_bytes=peak,
        diff_norm=d, launches=launches, per_kernel=per_kind)
    return launches


def phase_small_circuits(dev) -> None:
    """At width 20: the per-gate path (apply_gate, one launch a gate) over
    the lowered chain against the fused stream within 1e-5, and random
    circuits over the whole gate set (tests/test_engine_fuzz.py's mix)
    through the fused kernels against the dense engine on the card within
    5e-5."""
    from qcmrf_tpu_torch.circuits.ir import Circuit
    from qcmrf_tpu_torch.sim import dense, planes

    nq = SMALL_WIDTH
    _, low = lowered_chain(nq // 2)
    re, im = planes.zero_planes(nq, dev)
    for g in low.gates:
        planes.apply_gate(re, im, g, nq)
    fused = planes.run_ops(planes.fuse_ops(low), nq, dev)
    e = max(float((a - b).abs().max()) for a, b in zip((re, im), fused))
    require(e <= 1e-5, f"width {nq}: apply_gate over the {len(low.gates)} "
                       f"lowered gates == the fused stream within 1e-5 "
                       f"(max |diff| {e:.2e})")
    del re, im, fused
    for seed in range(3):
        rng = np.random.RandomState(400 + seed)
        c = Circuit(nq)
        for _ in range(80):
            kind = rng.randint(0, 8)
            if kind == 0:
                c.h(rng.randint(nq))
            elif kind == 1:
                c.x(rng.randint(nq))
            elif kind == 2:
                c.sx(rng.randint(nq))
            elif kind == 3:
                c.rz(float(rng.uniform(-np.pi, np.pi)), rng.randint(nq))
            elif kind == 4:
                a, b = rng.choice(nq, 2, replace=False)
                c.cx(int(a), int(b))
            elif kind == 5:
                a, b = rng.choice(nq, 2, replace=False)
                c.cp(float(rng.uniform(-np.pi, np.pi)), int(a), int(b))
            elif kind == 6:
                c.sxdg(rng.randint(nq))
            else:
                m = rng.randint(1, 4)
                qs = rng.choice(nq, m + 1, replace=False)
                flags = [int(f) * 2 - 1 for f in rng.randint(0, 2, m)]
                c.flags_phase([int(x) for x in qs[:m]], flags,
                              float(rng.uniform(-np.pi, np.pi)), int(qs[m]))
        kinds = sorted({op[0] for op in planes.fuse_ops(c)})
        got = torch.complex(*planes.run_statevector(c, device=dev))
        want = dense.run_statevector(c, device=dev)
        e = float((got.reshape(-1) - want).abs().max())
        require(e <= 5e-5, f"fuzz seed {400 + seed} (width {nq}, 80 gates, "
                           f"passes {kinds}): fused kernels == dense engine "
                           f"within 5e-5 (max |diff| {e:.2e})")
    torch.cuda.empty_cache()


#: short chains of x -> x * x - 1.5 held value by value against float64
FMA_CHECK_STEPS = (1, 15, 16)
FMA_CHECK_TOL = 1e-3


def check_fma_chain(K, dev) -> float:
    """fma_peak_kernel against its plain version on inputs whose result
    depends on the number of FMAs. x -> x * x - 1.5 is chaotic on [-1.5,
    0.75]: on 2^20 random x in [-1, 1] a chain of s steps stays within
    1e-3 of the float64 plain version (float32 rounding grows about 1.6x
    a step) while s - 1 or s + 1 steps lie O(1) away, which the check
    asserts of the oracle itself. At the rate run's length the chain on x
    = 0, b = -1 alternates 0 and -1 exactly, so its parity is checked too.
    Returns the largest |kernel - float64| of the short chains."""
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.rand(1 << 20, generator=g, device=dev) * 2 - 1
    out = torch.empty_like(x)
    oracle = [x.double()]
    for _ in range(max(FMA_CHECK_STEPS) + 1):
        oracle.append(oracle[-1] * oracle[-1] - 1.5)
    worst = 0.0
    for s in FMA_CHECK_STEPS:
        top = K.fma_chain_max(x, -1.5, steps=s, out=out)
        err = float((out.double() - oracle[s]).abs().max())
        sep = min(float((oracle[s + d] - oracle[s]).abs().max())
                  for d in (-1, 1))
        require(err <= FMA_CHECK_TOL < sep / 100 and float(top) == float(
            out.max()), f"fma_peak kernel, {s} steps of x*x - 1.5: "
                        f"max |kernel - float64| {err:.2e} (tolerance "
                        f"{FMA_CHECK_TOL}; a step more or fewer moves "
                        f"{sep:.2f}), block max {float(top)}")
        worst = max(worst, err)
    z = torch.zeros(1 << 20, device=dev)
    for s, want in ((K.FMA_CHAIN, 0.0), (K.FMA_CHAIN - 1, -1.0)):
        K.fma_chain_max(z, -1.0, steps=s, out=out)
        require(bool((out == want).all()),
                f"fma_peak kernel, {s} steps from 0 at b = -1: "
                f"all {want}")
    print(f"  fma_peak: chains of {FMA_CHECK_STEPS} steps within "
          f"{worst:.2e} of float64; {K.FMA_CHAIN} and {K.FMA_CHAIN - 1} "
          "steps from 0 at b = -1 give 0 and -1")
    return worst


def phase_rates(dev, report) -> dict:
    """copy_kernel_gbps and gate_apply_gbps at n = 28: the copy kernel's
    path. Returns the launch counts of these chains."""
    from qcmrf_tpu_torch.ops import kernels as K
    from qcmrf_tpu_torch.runners import bench

    n = LOWERED_WIDTH
    reset_counts()
    copy = bench.copy_kernel_gbps(n, dev)
    lane, row = bench.gate_apply_gbps(n, dev)
    tflops = bench.fma_peak_tflops(dev)
    torch.cuda.synchronize()
    launches = read_counts()
    for k, fn in (("copy", "copy_kernel_gbps"), ("fma_peak",
                                                 "fma_peak_tflops")):
        require(launches[k] > 0, f"kernel {k} launched {launches[k]} times "
                                 f"by {fn}")
    rates = dict(copy_kernel_gbps=copy, gate_lane_gbps=lane,
                 gate_row_gbps=row, gate_row_copy_ratio=row / copy,
                 gate_lane_copy_ratio=lane / copy, fma_peak_tflops=tflops)
    print(f"[rates] n={n}: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in rates.items()))
    # the copy kernel and its library call at the rates' shape, in turns
    # (kernel, copy_, copy_, kernel)
    src = unit_planes(n, 5, dev)
    out = (torch.empty_like(src[0]), torch.empty_like(src[1]))
    runs = {"kernel": lambda: K.copy_planes(*src, out=out),
            "copy_": lambda: (out[0].copy_(src[0]), out[1].copy_(src[1]))}
    times = {"kernel": [], "copy_": []}
    for name in ("kernel", "copy_", "copy_", "kernel"):
        times[name].append(cuda_ms(runs[name], reps=10))
    ms, lib = (sum(times[k]) / 2 for k in ("kernel", "copy_"))
    del src, out, runs
    torch.cuda.empty_cache()
    print(f"  copy kernel {ms:.4f} ms, planes' copy_ {lib:.4f} ms at 2^{n} "
          f"values (in turns: {times})")
    report["rates"] = rates
    report["copy_w28"] = dict(ms=ms, library_ms=lib,
                              shape=f"2^{n} values, both planes",
                              **bound(16 << n, 0))
    err = check_fma_chain(K, dev)
    # the rate run's chain on bench.py's array of ones, and its plain time
    x = torch.ones(bench.FMA_VALUES, dtype=torch.float32, device=dev)
    got = float(K.fma_chain_max(x))
    want, plain_ms = timed_once(lambda: K.fma_chain_max_reference(x))
    require(got == float(want) == 1.0,
            f"fma_peak kernel on ones: max {got}, plain {float(want)}")
    ms = cuda_ms(lambda: K.fma_chain_max(x), reps=10)
    flops = 2 * K.FMA_CHAIN * bench.FMA_VALUES
    print(f"  fma_peak: {tflops:.3f} TFLOP/s float32 (data sheet 67); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms for {bench.FMA_VALUES} "
          f"values")
    report["fma_peak"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              tflops=flops / (ms * 1e-3) / 1e12,
                              **bound(4 * bench.FMA_VALUES, flops),
                              shape=f"({512 * 512}, 128) float32 ones, "
                                    f"{K.FMA_CHAIN} FMAs a value",
                              err_shape=f"2^20 values in [-1, 1], "
                                        f"{FMA_CHECK_STEPS} steps of "
                                        "x*x - 1.5 against float64")
    del x
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The classical samplers: perturb-and-MAP on the map kernel, the Gibbs chain
# kernel, elimination's FFBS and PAM, the estimators, and the sampling CLIs
# ---------------------------------------------------------------------------

PAM_ROWS = 16              # perturbed models a launch, as bench.py times PAM
FFBS_DRAWS = 65536         # bench.py's exact_sample_n40_per_sec draws
EVAL_SAMPLES = 10_000      # eval --mode gibbs|pam: the reference's count
K27_CHAIN = (2000, 10, 100)  # samples, thin, burn: the train CLI's chain
SUITE_CHAIN_CHECK = (30, 10, 10)  # samples, thin, burn: eval --mode gibbs's
K27_CHAIN_CHECK = (5, 10, 100)    # K27_CHAIN's thin and burn, fewer samples


def pam_n24(dev):
    """bench.py's PAM model: the 24-chain with 6 triangles, theta =
    -|randn(RandomState(7))| * 0.5."""
    cl = ([[i, i + 1] for i in range(23)]
          + [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(6)])
    return seeded_model(cl, 7, 0.5, dev)


def pam_rows(mrf, seed: int):
    """The PAM_ROWS perturbed coefficient rows that ``sample_pam*`` draws
    from a generator seeded ``seed`` (one chunk of rows)."""
    from qcmrf_tpu_torch.models import sample
    from qcmrf_tpu_torch.ops import kernels

    g = torch.Generator(device=mrf.device).manual_seed(seed)
    th = sample._gumbel(g, (PAM_ROWS, mrf.dimension), mrf.device)
    return kernels.coefficient_table(mrf.cliques, mrf.n,
                                     th.add_(mrf.beta * mrf.theta))


def check_pam_rows(mrf, what: str, seed: int) -> dict:
    """The map kernel with PAM_ROWS perturbed models in one launch equal to
    its single-row launches (torch.equal); the launch and one row timed."""
    from qcmrf_tpu_torch.ops import kernels

    coef = pam_rows(mrf, seed)
    cl, n = mrf.cliques, mrf.n
    v, x = kernels.map_partials(cl, n, coef, 1.0)
    same = all(
        torch.equal(v1[0], v[r]) and torch.equal(x1[0], x[r])
        for r in range(PAM_ROWS)
        for v1, x1 in [kernels.map_partials(cl, n, coef[r:r + 1], 1.0)])
    require(same, f"{what}: map kernel, {PAM_ROWS} perturbed models in one "
                  f"launch == {PAM_ROWS} single-row launches (torch.equal)")
    ms = cuda_ms(lambda: kernels.map_partials(cl, n, coef, 1.0), reps=5)
    one = cuda_ms(lambda: kernels.map_partials(cl, n, coef[:1], 1.0), reps=5)
    print(f"  {what}: the {PAM_ROWS}-row launch {ms:.3f} ms "
          f"({ms / PAM_ROWS:.4f} ms a row), one row {one:.3f} ms")
    return dict(rows_ms=ms, one_row_ms=one)


def gibbs_ops(cliques, n: int) -> float:
    """Operations one sweep of the chain needs, whatever decides its bits:
    per item of a site, a product and a sum per other slot, a subtraction
    and an addition; per site the butterfly's 5 additions, the product with
    beta, exp, the addition, the division and the compare (10), the
    uniform's conversion and scaling (2), and a quarter of a Philox call
    (philox_ops(0) operations). The kernel's threshold (two float64
    logarithms a site) is its way of deciding, not work the function
    needs, and stays out."""
    items = sum(2 * (len(C) - 1) + 2 for C in cliques for _ in C)
    return items + n * (12 + philox_ops(0) / 4)


def site_latency(dev) -> dict:
    """The latency a site update's dependent path implies, from the card's
    own step latencies (``gibbs_kernel.latency_cycles``). This design, for
    a site of I <= 2^k <= 32 items: the decision and the next slot word
    from the register state (decide_slot_word: the product with beta, the
    compare, the state's select, the shifts and masks), the D load
    (shared_load: the address and the load) and k butterfly levels
    (shuffle_add); ``floor_k`` for k = 0..5 (K27: 5; the suite: 0-2).
    For comparison, a design that decides by p1 and keeps the state in
    shared memory: the bit stored and read back, the theta load, 5 levels,
    p1 from delta and 5 operations (``p1_design_floor_ns``), and with
    three dependent table loads (``p1_design_as_written_ns``). The
    producer warp's latency for a pass (philox_threshold: a ring group,
    at most 32 site updates, one a lane) is printed beside it."""
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk

    c = gk.latency_cycles(dev)
    ghz = c.pop("sm_ghz")
    floor = {k: c["decide_slot_word"] + c["shared_load"]
             + k * c["shuffle_add"] for k in range(6)}
    p1 = (c["bit_round_trip"] + c["ldg_l1"] + 5 * c["shuffle_add"]
          + c["p1_tail"] + 5 * c["fadd"])
    return dict(cycles=c, sm_ghz=ghz, floor_cycles=floor,
                floor_ns={k: v / ghz for k, v in floor.items()},
                p1_design_floor_ns=p1 / ghz,
                p1_design_as_written_ns=(p1 + 3 * c["shared_load"]) / ghz)


def wide_model(n: int, extra, dev):
    """An n-chain with triangles every 5 variables and ``extra`` cliques,
    theta = -|randn(RandomState(6))| * 0.4."""
    cl = ([[i, i + 1] for i in range(n - 1)]
          + [[i, i + 1, i + 2] for i in range(0, n - 2, 5)] + list(extra))
    return seeded_model(cl, 6, 0.4, dev)


def wide_evidence(n: int, dev):
    ev = torch.full((n,), -1, dtype=torch.int8, device=dev)
    ev[1], ev[n - 3] = 1, 0
    return ev


def check_gibbs_chains(what, mrf, thetas, seed, num, thin, burn,
                       evidence_mask=None, chain_ids=None) -> dict:
    """The chain kernel against its plain version at the main path's own
    ``thin`` and ``burn``: the sampled rows equal (torch.equal), or where
    two chains part, the first differing decision within 2 ulp of its p1
    (both rerun at every sweep: ``gibbs_kernel.partings``, which also holds
    each run's rows to its states after sweeps burn + i * thin); both
    timed. ``thetas`` None: 3 chains, the model's theta less 0.3 |randn|
    (RandomState(4)) each."""
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk

    if thetas is None:
        rng = np.random.RandomState(4)
        thetas = (mrf.theta[None] - torch.from_numpy(np.abs(rng.randn(
            3, mrf.dimension)).astype(np.float32)).to(mrf.device)
            * 0.3).contiguous()
    args = (seed, mrf.cliques, mrf.n, thetas, mrf.beta, num, thin, burn)
    kw = dict(evidence_mask=evidence_mask, chain_ids=chain_ids)
    got, ms = timed_once(lambda: gk.gibbs_chains(*args, **kw))
    want, plain_ms = timed_once(lambda: gk.gibbs_chains_reference(*args,
                                                                  **kw))
    parts = gk.partings(*args, got, want, **kw)
    if evidence_mask is not None:
        for v in torch.nonzero(evidence_mask >= 0)[:, 0].tolist():
            require(bool((got[..., v] == evidence_mask[v]).all()),
                    f"{what}: clamped site {v} keeps its bit")
    sweeps = burn + (num - 1) * thin + 1
    require(all(gk.within_ulps(u, p1) for _, _, _, u, p1 in parts),
            f"{what}: {thetas.shape[0]} chains, {num} samples at thin {thin}, "
            f"burn {burn}: the kernel's rows are its states after sweeps "
            f"{burn} + i * {thin}, equal to the plain version's on "
            f"{thetas.shape[0] - len(parts)} chains; {len(parts)} part, each "
            f"first at a decision within 2 ulp of p1 "
            f"{[(c, s, v) for c, s, v, _, _ in parts]}")
    return dict(ms=ms, plain_ms=plain_ms, parted=len(parts),
                max_abs_err=float((got.float() - want.float()).abs().max()),
                shape=f"{thetas.shape[0]} chains x {num} samples at thin "
                      f"{thin}, burn {burn} ({sweeps} sweeps), n={mrf.n}, "
                      f"{what}")


def samplers_main_path(dev, k27_graph, k27_theta_path, tmp) -> dict:
    """The slice's entry points on the card, the counts reset just before
    and read just after: eval --mode gibbs and --mode pam on the suite,
    infer --query sample (exact, gibbs, pam) on K27, the estimators on the
    n=20 grid, and train's synthetic data on K27 (one Gibbs chain)."""
    import contextlib
    import io

    from qcmrf_tpu_torch.evaluation import estimators
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.runners import eval as run_eval
    from qcmrf_tpu_torch.runners import infer_cli, train_cli

    queries = os.path.join(tmp, "samples.jsonl")
    with open(queries, "w") as f:
        f.write("\n".join(json.dumps(q) for q in (
            {"query": "sample", "method": "exact", "evidence": "0=1",
             "num_samples": 64},
            {"query": "sample", "method": "gibbs", "num_samples": 100},
            {"query": "sample", "method": "pam", "num_samples": PAM_ROWS})))
    grid = grid_model(4, 5, 2, dev)
    grid = grid.with_theta(grid.theta / 3)
    torch.cuda.synchronize()
    reset_counts()
    t = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for mode in ("gibbs", "pam"):
            before = gk.LAUNCHES["gibbs"]
            t0 = time.perf_counter()
            res = run_eval.main(["--mode", mode, "--scale", "0.1",
                                 "--num-samples", str(EVAL_SAMPLES),
                                 "--platform", "gpu", "--kl"])
            torch.cuda.synchronize()
            t[mode] = (time.perf_counter() - t0, res)
            t[mode + "_chain_launches"] = gk.LAUNCHES["gibbs"] - before
        t0 = time.perf_counter()
        answers = infer_cli.main(["--graph", k27_graph, "--theta",
                                  k27_theta_path, "--queries", queries,
                                  "--platform", "gpu"])
        mu = estimators.clique_marginals_exact(grid)
        lnz_hat, marg, delta = estimators.estimate_from_circuit(
            SAMPLE_SEED, grid, 1 << 22)
        torch.cuda.synchronize()
        t["infer+estimators"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_cli.main(["--graph", k27_graph, "--samples",
                        str(K27_CHAIN[0]), "--steps", "2", "--outdir",
                        os.path.join(tmp, "train"), "--platform", "gpu"])
        torch.cuda.synchronize()
        t["train"] = time.perf_counter() - t0
    launches = read_counts()
    print(f"  main path: eval --mode gibbs {t['gibbs'][0]:.2f} s, --mode pam "
          f"{t['pam'][0]:.2f} s ({EVAL_SAMPLES} samples a model, 70 models), "
          f"infer + estimators {t['infer+estimators']:.2f} s, train K27 "
          f"(synthetic data, 2 steps) {t['train']:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    require(t["gibbs_chain_launches"] == 1,
            f"eval --mode gibbs: the suite's 70 chains in "
            f"{t['gibbs_chain_launches']} chain launch (1)")
    for r in t["gibbs"][1]:
        require(r.mean_f >= 0.99, f"eval --mode gibbs, graph {r.graph}: mean "
                                  f"fidelity {r.mean_f:.4f} >= 0.99")
        require(r.successes == [EVAL_SAMPLES / 10_000] * 10,
                "  delta-hat keeps the reference's fixed norm")
    for r in t["pam"][1]:
        print(f"  eval --mode pam, graph {r.graph}: mean fidelity "
              f"{r.mean_f:.4f} (approximate: no limit)")
    methods = [a["method"] for a in answers]
    require(methods == ["exact", "gibbs", "pam"]
            and [len(a["samples"]) for a in answers] == [64, 100, PAM_ROWS]
            and all(s[0] == 1 for s in answers[0]["samples"]),
            f"infer --query sample on K27: methods {methods}, shapes and the "
            "evidence column")
    lnz = float(kernels.log_partition(grid))
    err = float((torch.from_numpy(marg).to(dev) - mu.double()).abs().max())
    require(abs(lnz_hat - lnz) <= 0.01 and err <= 0.01,
            f"estimate_from_circuit on the n=20 grid (2^22 shots, delta-hat "
            f"{delta:.4f}): lnZ-hat {lnz_hat:.5f} vs lnZ {lnz:.5f}; marginals "
            f"within {err:.4f} of clique_marginals_exact")
    for k in ("gibbs", "map", "logpot", "lnz_moments", "sampler"):
        require(launches[k] > 0, f"kernel {k} launched {launches[k]} times "
                                 "on the samplers' main path")
    return dict(launches=launches, eval_gibbs_s=t["gibbs"][0],
                eval_gibbs_chain_launches=t["gibbs_chain_launches"],
                eval_pam_s=t["pam"][0],
                eval_gibbs_f=[r.mean_f for r in t["gibbs"][1]],
                eval_pam_f=[r.mean_f for r in t["pam"][1]],
                infer_estimators_s=t["infer+estimators"],
                train_k27_s=t["train"])


def phase_samplers(dev, report) -> dict:
    """Slice 3b on the card. The map kernel with PAM_ROWS perturbed models a
    launch against its single-row launches (bench.py's n=24 PAM model and
    K27), each K27 PAM draw the argmax of its own perturbed model; the
    chain kernel against its plain version (a suite graph's 10 reps, and
    K27); FFBS on the 40-chain and elimination PAM on the 30-chain; the
    main path (samplers_main_path); the rates. Returns the main path's
    launch counts."""
    from qcmrf_tpu_torch.models import elimination, sample
    from qcmrf_tpu_torch.models.mrf import MRF, chain_mrf
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk
    from qcmrf_tpu_torch.ops import kernels

    out = {}
    print(f"[samplers] perturb-and-MAP: {PAM_ROWS} perturbed models a "
          "map-kernel launch")
    m24 = pam_n24(dev)
    k27 = MRF.create(complete_cliques(INFER_N), theta=k27_theta(), device=dev)
    out["pam_n24_rows"] = check_pam_rows(m24, "n=24 chain + 6 triangles", 1)
    out["pam_k27_rows"] = check_pam_rows(k27, "K27", 2)
    gen = torch.Generator(device=dev).manual_seed(3)
    ms = cuda_ms(lambda: sample.sample_pam_streaming(gen, m24, PAM_ROWS),
                 reps=5)
    out["pam_n24_ms_per_sample"] = ms / PAM_ROWS
    print(f"  pam_n24_ms_per_sample: {ms / PAM_ROWS:.4f} ms "
          f"(sample_pam_streaming, {PAM_ROWS} samples in {ms:.3f} ms)")
    launches_before = kernels.LAUNCHES["map"]
    bits = sample.sample_conditional(4, k27, PAM_ROWS, {}, method="pam")
    require(kernels.LAUNCHES["map"] - launches_before == 1,
            f"K27 PAM (width {INFER_N} > {sample._PAM_ELIM_WIDTH}) through "
            f"sample_conditional: the streaming sweep, {PAM_ROWS} samples in "
            "one map launch")
    coef = pam_rows(k27, 4)
    ids = gk.ids_from_bits(bits)
    worst = 0.0
    for r in range(PAM_ROWS):
        table = kernels.logpot_table(k27.cliques, INFER_N, coef[r:r + 1],
                                     1.0)
        top = float(table.max())
        del table
        chain = float(kernels._clique_sum(k27.cliques, INFER_N,
                                          coef[r:r + 1], ids[r:r + 1])[0, 0])
        gap = float(kernels.split_gap(coef[r:r + 1], 1.0)[0])
        worst = max(worst, abs(chain - top) / gap)
        require(abs(chain - top) <= gap,
                f"  K27 PAM draw {r}: its chain value {chain:.6f} is the "
                f"maximum of its perturbed model within split_gap "
                f"({top:.6f}, gap {gap:.2e})")
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: sample.sample_conditional(gen, k27, PAM_ROWS, {},
                                                   method="pam"), reps=3)
    out["pam_k27_ms_per_sample"] = ms / PAM_ROWS
    print(f"  K27 PAM through sample_conditional: {ms / PAM_ROWS:.4f} ms a "
          f"sample ({PAM_ROWS} a launch), one row's sweep "
          f"{out['pam_k27_rows']['one_row_ms']:.3f} ms")

    print("[samplers] exact FFBS on the 40-chain, elimination PAM on the "
          "30-chain")
    ce = seeded_model([[i, i + 1] for i in range(39)], 9, 1.0, dev)
    elimination.sample_exact_elim(0, ce, FFBS_DRAWS)
    best = math.inf
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S = elimination.sample_exact_elim(i + 1, ce, FFBS_DRAWS)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    out["exact_sample_n40_per_sec"] = FFBS_DRAWS / best
    for v in (0, 19, 39):
        mean = float(S[:, v].double().mean())
        true = float(elimination.conditional_prob(ce, v, 1))
        require(abs(mean - true) <= 0.02,
                f"FFBS n=40, variable {v}: mean {mean:.4f} vs "
                f"conditional_prob {true:.4f} within 0.02")
    print(f"  exact_sample_n40_per_sec: {FFBS_DRAWS / best:.0f} "
          f"({FFBS_DRAWS} draws in {best * 1e3:.3f} ms, best of 3)")
    c30 = seeded_model([[i, i + 1] for i in range(29)], 8, 2.0, dev)
    P, ms = timed_once(lambda: elimination.sample_pam(1, c30, 200))
    require(tuple(P.shape) == (200, 30) and bool(((P == 0) | (P == 1)).all()),
            f"elimination PAM on the 30-chain: 200 samples of 30 bits "
            f"({ms:.2f} ms)")
    out["elim_pam_n30_ms"] = ms

    print("[samplers] the chain kernel against its plain version")
    suite = generate_suite(0.1)
    g5 = MRF.create(suite.graphs[5], theta=suite.thetas[5][0], device=dev)
    th5 = torch.tensor(np.asarray(suite.thetas[5], np.float32), device=dev)
    suite_models, alone, idx = [], [], 0
    for j, C in enumerate(suite.graphs):
        g = MRF.create(C, theta=suite.thetas[j][0], device=dev)
        th = torch.tensor(np.asarray(suite.thetas[j], np.float32),
                          device=dev)
        ids = range(idx, idx + th.shape[0])
        idx += th.shape[0]
        suite_models.append((g.cliques, g.n, th))
        alone.append(gk.gibbs_chains(7, g.cliques, g.n, th, 1.0,
                                     *SUITE_CHAIN_CHECK, chain_ids=ids))
        one = check_gibbs_chains(f"suite graph {C}, its 10 reps", g, th, 7,
                                 *SUITE_CHAIN_CHECK, chain_ids=ids)
        if j == 5:
            chk = one
    launches = gk.LAUNCHES["gibbs"]
    rows, ms_multi = timed_once(lambda: gk.gibbs_chains_multi(
        7, suite_models, 1.0, *SUITE_CHAIN_CHECK))
    require(gk.LAUNCHES["gibbs"] - launches == 1
            and all(torch.equal(a, b) for a, b in zip(alone, rows)),
            f"the suite's {idx} chains of 7 structures in one launch "
            f"({ms_multi:.3f} ms cold) == the 7 per-graph launches "
            "(torch.equal), each held to its plain version above")
    wide = check_gibbs_chains(
        "an 80-variable chain with triangles (the state in shared memory), "
        "2 clamped sites", wide_model(80, [], dev), None, 8,
        *SUITE_CHAIN_CHECK, evidence_mask=wide_evidence(80, dev))
    deep = check_gibbs_chains(
        "a 20-variable chain and a 16-variable clique (its differences in "
        "device memory)", wide_model(20, [list(range(2, 18))], dev), None,
        8, *SUITE_CHAIN_CHECK, evidence_mask=wide_evidence(20, dev))
    thr = gk.device_thresholds(dev)
    k24 = torch.arange(1 << 24, dtype=torch.int64)
    thr_cpu = gk.thresholds_of(k24)
    cpu_parts = int((thr.cpu() != thr_cpu).sum())
    lo = torch.minimum(thr.cpu(), thr_cpu)
    hi = torch.maximum(thr.cpu(), thr_cpu)
    require(torch.equal(thr, gk.thresholds_of(k24.to(dev)))
            and torch.equal(torch.nextafter(lo, hi), hi),
            f"the kernel's threshold of every u = k 2^-24 (2^24 of them) == "
            f"the plain version's on the card; on the CPU {cpu_parts} differ, "
            f"each by one float32 step")
    del thr, thr_cpu, lo, hi
    rng = np.random.RandomState(3)
    th27 = (k27.theta[None] - torch.from_numpy(np.abs(rng.randn(
        4, k27.dimension)).astype(np.float32)).to(dev) * 0.05).contiguous()
    chk27 = check_gibbs_chains("K27, 4 perturbed thetas", k27, th27, 8,
                               *K27_CHAIN_CHECK)
    print(f"  plain version {chk['plain_ms']:.1f} ms, kernel "
          f"{chk['ms']:.3f} ms at {chk['shape']}; K27: plain "
          f"{chk27['plain_ms']:.1f} ms, kernel {chk27['ms']:.3f} ms")
    num, thin, burn = K27_CHAIN
    sweeps = burn + (num - 1) * thin + 1
    args = (9, k27.cliques, INFER_N, k27.theta[None].contiguous(), 1.0, num,
            thin, burn)
    chain = gk.gibbs_chains(*args)
    ms = cuda_ms(lambda: gk.gibbs_chains(*args), reps=3)
    sites = sweeps * INFER_N
    mu = kernels.lnz_and_moments(k27.cliques, INFER_N, k27.theta, 1.0)[1]
    # P(x_0 = 1) and P(x_v = 1) from the first clique (0, 1)'s block
    p0, p1 = float(mu[2] + mu[3]), float(mu[1] + mu[3])
    means = chain[0].double().mean(dim=0)
    require(abs(float(means[0]) - p0) <= 0.05
            and abs(float(means[1]) - p1) <= 0.05,
            f"K27 chain ({num} samples, thin {thin}, burn {burn}): means of "
            f"x0, x1 {float(means[0]):.4f}, {float(means[1]):.4f} vs the "
            f"exact {p0:.4f}, {p1:.4f} within 0.05")
    ops = gibbs_ops(k27.cliques, INFER_N)
    b = bound(4 * k27.dimension + num * INFER_N, sweeps * ops)
    n_chk, thin_chk, burn_chk = SUITE_CHAIN_CHECK
    sweeps_chk = burn_chk + (n_chk - 1) * thin_chk + 1
    b_plain = bound(4 * th5.numel() + th5.shape[0] * n_chk * 5,
                    th5.shape[0] * sweeps_chk * gibbs_ops(g5.cliques, 5))
    lat = site_latency(dev)
    ns_site = ms * 1e6 / sites
    ms_suite = cuda_ms(lambda: gk.gibbs_chains(
        7, g5.cliques, 5, th5, g5.beta, *SUITE_CHAIN_CHECK), reps=5)
    ns_site_suite = ms_suite * 1e6 / (sweeps_chk * 5)
    e_sweeps = 10 + (EVAL_SAMPLES - 1) * 10 + 1
    ms_eval = cuda_ms(lambda: gk.gibbs_chains_multi(
        0, suite_models, 1.0, EVAL_SAMPLES, 10, 10), reps=2)
    ns_site_eval = ms_eval * 1e6 / (e_sweeps * 5)
    fl = lat["floor_ns"]
    print(f"  K27 chain, {num} samples thin {thin} burn {burn} ({sweeps} "
          f"sweeps, one chain): {ms:.3f} ms, {ns_site:.1f} ns a site update "
          f"({ns_site * lat['sm_ghz']:.0f} cycles at the probe's "
          f"{lat['sm_ghz']:.3f} GHz); the suite graph's 10 chains "
          f"{ms_suite:.3f} ms warm, {ns_site_suite:.1f} ns a site update "
          f"(its cold call {chk['ms']:.3f} ms); eval --mode gibbs's one "
          f"launch (70 chains, {e_sweeps} sweeps, n <= 5) {ms_eval:.3f} ms, "
          f"{ns_site_eval:.1f} ns a site of its 5-variable graphs; "
          f"{ops / INFER_N:.1f} operations a site update; the card's rate "
          f"bounds the K27 run at {b['bound_ms']:.4f} ms ({b['bound_by']}), "
          f"but one chain is bound by its dependent latency: this design's "
          f"floor {lat['floor_cycles'][5]:.0f} cycles = {fl[5]:.1f} ns a K27 "
          f"site (5 levels), {fl[1]:.1f} ns a suite site of 2 items, "
          f"{fl[0]:.1f} of one; the producer "
          f"{lat['cycles']['philox_threshold'] / lat['sm_ghz']:.1f} ns a "
          f"pass (deciding by p1 with the state in shared memory: "
          f"{lat['p1_design_floor_ns']:.1f} by data dependence, "
          f"{lat['p1_design_as_written_ns']:.1f} with three table loads; "
          f"probe: {({k: round(v, 1) for k, v in lat['cycles'].items()})})")
    report["gibbs"] = dict(
        max_abs_err=max(chk["max_abs_err"], chk27["max_abs_err"],
                        wide["max_abs_err"], deep["max_abs_err"]),
        parted_chains=chk["parted"] + chk27["parted"] + wide["parted"]
        + deep["parted"],
        ms=ms, plain_ms=chk["plain_ms"], **b,
        shape=f"one K27 chain, {num} samples at thin {thin}, burn {burn}: "
              f"{sweeps} sweeps, {sites} site updates",
        ns_per_site_update=ns_site,
        latency_bound_ns_per_site_update=lat["floor_ns"][5],
        latency_bound_ns_by_levels=lat["floor_ns"],
        p1_design_latency_bound_ns=lat["p1_design_floor_ns"],
        p1_design_as_written_ns=lat["p1_design_as_written_ns"],
        latency_cycles=lat["cycles"], sm_ghz=lat["sm_ghz"],
        ns_per_site_update_suite=ns_site_suite,
        eval_launch_ms=ms_eval, ns_per_site_update_eval=ns_site_eval,
        suite_one_launch_cold_ms=ms_multi,
        wide_check=dict(ms=wide["ms"], plain_ms=wide["plain_ms"],
                        parted=wide["parted"], shape=wide["shape"]),
        device_delta_check=dict(ms=deep["ms"], plain_ms=deep["plain_ms"],
                                parted=deep["parted"], shape=deep["shape"]),
        thresholds_cpu_parts=cpu_parts,
        ops_per_site_update=ops / INFER_N,
        plain_shape=chk["shape"], ms_at_plain_shape=ms_suite,
        cold_ms_at_plain_shape=chk["ms"],
        bound_ms_at_plain_shape=b_plain["bound_ms"],
        k27_check=dict(plain_ms=chk27["plain_ms"], ms=chk27["ms"],
                       shape=chk27["shape"]))
    with tempfile.TemporaryDirectory() as tmp:
        graph = os.path.join(tmp, "k27.json")
        theta_path = os.path.join(tmp, "theta.json")
        with open(graph, "w") as f:
            json.dump(complete_cliques(INFER_N), f)
        with open(theta_path, "w") as f:
            json.dump(k27_theta().tolist(), f)
        print("[samplers] main path")
        main = samplers_main_path(dev, graph, theta_path, tmp)
    out.update({k: v for k, v in main.items() if k != "launches"})
    out["k27_chain_ms_per_site_update"] = ms / sites
    report["samplers"] = out
    return main["launches"]


AIS_CHAINS, AIS_TEMPS = 256, 96   # the slow pin's settings: 256 x 96
AIS_POOL_SEEDS = (1, 2, 3, 4)     # marginals pooled over 4 runs
AIS_TRAIN_STEPS = 100             # Adam 0.08, x 0.25 after 60 updates
AIS_CHECK_WIDE = (32, 16, 2)      # chains, rungs, sweeps a rung: n = 80


def disjoint_blocks(dev):
    """The past-both-caps flagship (tests/test_ais.py::_disjoint_blocks):
    block A the complete pairwise graph on 27 variables, block B a disjoint
    21-variable chain; n = 48, 371 cliques, dimension 1484, theta =
    -|randn(RandomState(1))| * 0.3. Returns (joint, A, B, dim A)."""
    from qcmrf_tpu_torch.models.mrf import MRF

    A = complete_cliques(27)
    B = [[i, i + 1] for i in range(20)]
    d = 4 * (len(A) + len(B))
    theta = (-np.abs(np.random.RandomState(1).randn(d)) * 0.3).astype(
        np.float32)
    dA = 4 * len(A)
    joint = MRF.create(A + [[i + 27, j + 27] for i, j in B], theta=theta,
                       device=dev)
    mA = MRF.create(A, theta=theta[:dA], device=dev)
    mB = MRF.create(B, theta=theta[dA:], device=dev)
    return joint, mA, mB, dA


def ais_ops(cliques, n: int, chains: int, temps: int, spt: int) -> float:
    """Operations the AIS chains need: per sweep a Gibbs sweep's
    (gibbs_ops), per rung theta^T phi(x) (a shift and an or a slot, a
    load's index and an addition a clique) and the weight step (2)."""
    rung = sum(2 * len(C) + 2 for C in cliques) + 2
    return chains * temps * (spt * gibbs_ops(cliques, n) + rung)


def check_ais_mode(what, mrf, chains, temps, spt, seed) -> dict:
    """The AIS mode against its plain version on the card at (chains,
    temps, spt): final states equal row for row (or, where a chain parts,
    a decision of the plain run within 2 ulp of p1) and log-weights within
    1e-5 relative; both timed once."""
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk

    args = (seed, mrf.cliques, mrf.n, mrf.theta, mrf.beta, chains, temps,
            spt)
    (w, b), ms = timed_once(lambda: gk.ais_chains(*args))
    (w0, b0), plain_ms = timed_once(lambda: gk.ais_chains_reference(*args))
    parts = gk.ais_partings(seed, mrf.cliques, mrf.n, mrf.theta, mrf.beta,
                            temps, spt, b, b0)
    same = (b == b0).all(dim=1)
    rel = float(((w - w0).abs() / w0.abs().clamp(min=1.0))[same].max())
    require(all(gk.within_ulps(u, p1) for _, _, _, u, p1 in parts)
            and rel <= 1e-5,
            f"{what}: AIS mode, {chains} chains x {temps} rungs x {spt} "
            f"sweeps in one launch ({ms:.3f} ms cold; plain version "
            f"{plain_ms:.1f} ms): final states equal on "
            f"{chains - len(parts)} chains, {len(parts)} part (each at a "
            f"decision within 2 ulp of p1); log-weights within {rel:.2e} "
            "relative (<= 1e-5)")
    return dict(ms=ms, plain_ms=plain_ms, parted=len(parts),
                max_abs_err=float((w - w0).abs()[same].max()),
                shape=f"{chains} chains x {temps} rungs x {spt} sweeps, "
                      f"n={mrf.n}, {what}")


def ais_main_path(dev, joint, tmp, lnz_exact, mu_seed, p_exact) -> dict:
    """The slice's entry points through ``__main__``, the counts reset just
    before and read just after: infer --method ais (lnz, marginals, prob),
    each one AIS launch; train --grad ais, 3 steps then --resume to 5, one
    AIS launch a step; eval --mode gibbs|pam --native on the suite. The
    answers against the exact ones: lnZ within max(4 stderr, 5e-3); the
    marginals (at --sample-seed AIS_POOL_SEEDS[0]) within 1e-5 of
    ``mu_seed``, the library's marginals at that seed, which the slow pin
    pools and holds to its bars; P(x47 = 1 | x0 = 1) (x0 in block A, x47 in the
    disjoint block B) within max(4 sqrt(p (1 - p) / ESS), 5e-3) of
    ``p_exact``, block B's elimination answer."""
    import contextlib
    import io

    from qcmrf_tpu_torch import __main__ as cli
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk

    model = os.path.join(tmp, "blocks48.json")
    with open(model, "w") as f:
        json.dump({"cliques": [list(C) for C in joint.cliques],
                   "theta": joint.theta.cpu().double().tolist()}, f)
    graph = os.path.join(tmp, "blocks48_graph.json")
    with open(graph, "w") as f:
        json.dump([list(C) for C in joint.cliques], f)
    torch.cuda.synchronize()
    reset_counts()
    t, answers, per_query = {}, {}, {}
    with contextlib.redirect_stdout(io.StringIO()):
        for q, extra in (("lnz", []),
                         ("marginals", ["--sample-seed",
                                        str(AIS_POOL_SEEDS[0])]),
                         ("prob", ["--of", f"{joint.n - 1}=1",
                                   "--evidence", "0=1"])):
            out = os.path.join(tmp, f"{q}.json")
            before = gk.LAUNCHES["gibbs_ais"]
            t0 = time.perf_counter()
            rc = cli.main(["infer", "--model", model, "--query", q,
                           "--method", "ais", "--ais-chains",
                           str(AIS_CHAINS), "--ais-temps", str(AIS_TEMPS),
                           "--platform", "gpu", "--out", out] + extra)
            torch.cuda.synchronize()
            t["infer_" + q] = time.perf_counter() - t0
            per_query[q] = gk.LAUNCHES["gibbs_ais"] - before
            require(rc == 0, f"infer --method ais --query {q} exits 0")
            with open(out) as f:
                answers[q] = json.load(f)
        train_dir = os.path.join(tmp, "train")
        steps = {}
        for n_steps, extra in ((3, []), (5, ["--resume"])):
            before = gk.LAUNCHES["gibbs_ais"]
            t0 = time.perf_counter()
            rc = cli.main(["train", "--graph", graph, "--samples", "2000",
                           "--steps", str(n_steps), "--grad", "ais",
                           "--ais-chains", str(AIS_CHAINS), "--ais-temps",
                           str(AIS_TEMPS), "--lr", "0.05", "--outdir",
                           train_dir, "--checkpoint-every", "3",
                           "--platform", "gpu"] + extra)
            torch.cuda.synchronize()
            t[f"train_{n_steps}"] = time.perf_counter() - t0
            steps[n_steps] = gk.LAUNCHES["gibbs_ais"] - before
            require(rc == 0, f"train --grad ais --steps {n_steps} "
                             f"{' '.join(extra)} exits 0")
        with open(os.path.join(train_dir, "fitted_model.json")) as f:
            fitted = json.load(f)
        evals = {}
        for mode in ("gibbs", "pam"):
            before = gk.LAUNCHES["gibbs"]
            t0 = time.perf_counter()
            from qcmrf_tpu_torch.runners import eval as run_eval

            evals[mode] = run_eval.main(["--mode", mode, "--native",
                                         "--scale", "0.1", "--platform",
                                         "gpu"])
            torch.cuda.synchronize()
            t["eval_native_" + mode] = time.perf_counter() - t0
            require(gk.LAUNCHES["gibbs"] == before,
                    f"eval --mode {mode} --native: no chain launch (the C++ "
                    "engine samples)")
    launches = read_counts()
    print(f"  main path: infer --method ais lnz {t['infer_lnz']:.3f} s, "
          f"marginals {t['infer_marginals']:.3f} s, prob "
          f"{t['infer_prob']:.3f} s; train --grad ais 3 steps "
          f"{t['train_3']:.2f} s (its data: one Gibbs chain), --resume to 5 "
          f"{t['train_5']:.2f} s; eval --native gibbs "
          f"{t['eval_native_gibbs']:.2f} s, pam {t['eval_native_pam']:.2f} "
          f"s; launches { {k: v for k, v in launches.items() if v} }")
    for q, count in per_query.items():
        require(count == 1 and answers[q]["backend"] == "ais",
                f"infer --method ais --query {q}: {count} AIS launch (1), "
                f"ESS {answers[q]['ais']['ess']:.1f}")
    lnz, se = answers["lnz"]["lnz"], answers["lnz"]["ais"]["stderr"]
    require(set(answers["lnz"]["ais"]) == {"chains", "temps", "seed", "ess",
                                           "stderr"}
            and abs(lnz - lnz_exact) <= max(4 * se, 5e-3),
            f"infer --query lnz: {lnz:.5f} vs exact {lnz_exact:.5f}, |diff| "
            f"{abs(lnz - lnz_exact):.5f} <= max(4 stderr, 5e-3) = "
            f"{max(4 * se, 5e-3):.5f}")
    mu = torch.tensor(answers["marginals"]["marginals"], dtype=torch.float64)
    gap = float((mu - mu_seed.double().cpu()).abs().max())
    # the same draws; the scatter's atomic adds may sum in another order
    require(mu.shape == (joint.dimension,) and gap <= 1e-5,
            f"infer --query marginals --sample-seed {AIS_POOL_SEEDS[0]}: "
            f"{joint.dimension} marginals within {gap:.1e} (<= 1e-5) of "
            "ais_clique_marginals at that seed (pooled in the slow pin)")
    p, ess_p = answers["prob"]["prob"], answers["prob"]["ais"]["ess"]
    bar = max(4 * math.sqrt(p_exact * (1 - p_exact) / ess_p), 5e-3)
    require(abs(p - p_exact) <= bar,
            f"infer --query prob: P(x{joint.n - 1} = 1 | x0 = 1) {p:.4f} vs "
            f"block B's elimination {p_exact:.4f}, |diff| "
            f"{abs(p - p_exact):.4f} <= max(4 sqrt(p (1 - p) / ESS), 5e-3) "
            f"= {bar:.4f} (ESS {ess_p:.1f})")
    require(steps == {3: 3, 5: 2} and fitted["ais_skipped_steps"] == 0
            and fitted["final_ess"] > 0.1 * AIS_CHAINS
            and "final_nll" not in fitted,
            f"train --grad ais: one AIS launch a step (3, then 2 resumed), "
            f"final ESS {fitted['final_ess']:.1f}, "
            f"{fitted['ais_skipped_steps']} skipped")
    for r in evals["gibbs"]:
        require(r.mean_f >= 0.99, f"eval --mode gibbs --native, graph "
                                  f"{r.graph}: mean fidelity {r.mean_f:.4f}")
    for r in evals["pam"]:
        print(f"  eval --mode pam --native, graph {r.graph}: mean fidelity "
              f"{r.mean_f:.4f}")
    require(launches["gibbs_ais"] == 8,
            f"AIS mode launched {launches['gibbs_ais']} times on the main "
            "path (3 queries + 5 steps)")
    return dict(launches=launches, seconds=t,
                eval_native_gibbs_f=[r.mean_f for r in evals["gibbs"]],
                eval_native_pam_f=[r.mean_f for r in evals["pam"]],
                lnz_query=answers["lnz"], prob_query=answers["prob"],
                prob_exact=p_exact)


def phase_ais(dev, report) -> dict:
    """Slice 3c on the card: the AIS mode against its plain version (the
    n = 48 blocks at the main path's 256 x 96, the word state's fast loop;
    an 80-variable chain, the state in shared memory), timed beside the
    dependent-path floor; the slow pin of tests/test_ais.py (lnZ,
    marginals pooled over 4 seeds, 100 training steps) against the
    blocks' exact targets (lse and lnz_moments kernels on block A,
    elimination on block B); then the main path (ais_main_path)."""
    from qcmrf_tpu_torch.models import ais, elimination
    from qcmrf_tpu_torch.models import train as mtrain
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import gibbs_kernel as gk
    from qcmrf_tpu_torch.ops import kernels

    out = {}
    joint, mA, mB, dA = disjoint_blocks(dev)
    n, M, T = joint.n, AIS_CHAINS, AIS_TEMPS
    print(f"[ais] the n={n} blocks (K27 and a 21-chain, "
          f"{len(joint.cliques)} cliques), {M} chains x {T} rungs")
    lnz_exact = (float(kernels.log_partition(mA))
                 + float(elimination.log_partition(mB)))
    muA = kernels.lnz_and_moments(mA.cliques, mA.n, mA.theta, 1.0)[1]
    muB = elimination.clique_marginals(mB)
    mu_exact = torch.cat([muA.float(), muB.float()])
    require(48 * math.log(2.0) - lnz_exact > 10.0,
            f"exact lnZ {lnz_exact:.4f} (lse kernel on A + elimination on "
            f"B) lies {48 * math.log(2.0) - lnz_exact:.2f} nats below n ln 2")
    pack = gk.chain_pack(((joint.cliques, n, None),))
    smem, _, packed = gk.ais_shared_bytes(joint.cliques, n)
    # the runtime's occupancy of the launched instantiation at its shared
    # memory (registers, shared memory and the block limit together)
    per_sm = gk.ais_resident_blocks(joint.cliques, n, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    require(pack.reg_state and bool(pack.structs[0, 8]) and packed
            and sms * per_sm >= M,
            f"word state, fast loop (K | C << 4 = {pack.structs[0, 8] & 255}),"
            f" packed cliques, {smem} bytes of shared memory a block: "
            f"{per_sm} blocks an SM by cudaOccupancyMaxActiveBlocksPer"
            f"Multiprocessor, {sms * per_sm} resident >= {M} chains")
    main = check_ais_mode("the n=48 blocks", joint, M, T, 1, 7)
    wide = check_ais_mode("an 80-variable chain with triangles (the state "
                          "in shared memory)", wide_model(80, [], dev),
                          *AIS_CHECK_WIDE, 8)
    ms = cuda_ms(lambda: gk.ais_chains(0, joint.cliques, n, joint.theta,
                                       1.0, M, T, 1), reps=5)
    lat = site_latency(dev)
    sites = T * n
    ns_site = ms * 1e6 / sites
    floor_ms = sites * lat["floor_ns"][5] * 1e-6
    b = bound(4 * joint.dimension + M * (n + 4),
              ais_ops(joint.cliques, n, M, T, 1))
    print(f"  AIS launch {ms:.3f} ms by CUDA events ({M} chains in "
          f"parallel, {sites} site updates each): {ns_site:.1f} ns a site "
          f"update against this design's floor {lat['floor_ns'][5]:.1f} ns "
          f"(5 levels, every site of the fast loop; {floor_ms:.3f} ms a "
          f"chain); rate bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
          f"plain version {main['plain_ms']:.1f} ms")
    report["gibbs_ais"] = dict(
        ms=ms, plain_ms=main["plain_ms"], **b,
        max_abs_err=max(main["max_abs_err"], wide["max_abs_err"]),
        parted_chains=main["parted"] + wide["parted"],
        shape=main["shape"], ns_per_site_update=ns_site,
        latency_bound_ns_per_site_update=lat["floor_ns"][5],
        latency_bound_ms=floor_ms, shared_bytes=smem,
        resident_blocks=sms * per_sm, cold_ms=main["ms"],
        wide_check=wide)

    print("[ais] the slow pin: lnZ, pooled marginals, training")
    (lnz, d), lnz_ms = timed_once(lambda: ais.ais_log_partition(
        0, joint, M, T, return_diagnostics=True))
    ess, se = float(d["ess"]), float(d["stderr"])
    require(ess > 25.6 and abs(float(lnz) - lnz_exact) <= max(4 * se, 5e-3),
            f"lnZ-hat {float(lnz):.5f} vs exact {lnz_exact:.5f}: |diff| "
            f"{abs(float(lnz) - lnz_exact):.5f} <= max(4 stderr, 5e-3) = "
            f"{max(4 * se, 5e-3):.5f}; ESS {ess:.1f} > 25.6 ({lnz_ms:.3f} ms)")
    mus = []
    for k in AIS_POOL_SEEDS:
        mu, dm = ais.ais_clique_marginals(k, joint, M, T,
                                          return_diagnostics=True)
        require(float(dm["ess"]) > 25.6,
                f"  marginals seed {k}: ESS {float(dm['ess']):.1f} > 25.6")
        mus.append(mu)
    err = (torch.stack(mus).mean(dim=0) - mu_exact).abs()
    require(float(err.max()) < 0.06 and float(err.mean()) < 0.015,
            f"marginals pooled over {len(mus)} seeds: max error "
            f"{float(err.max()):.4f} < 0.06, mean {float(err.mean()):.5f} < "
            "0.015")
    template = MRF.create([list(C) for C in joint.cliques], device=dev)
    raw = mtrain._from_theta(torch.full((template.dimension,), -0.5,
                                        device=dev), True).requires_grad_()
    opt = mtrain.adam([raw], 0.08)
    step = mtrain.make_ais_train_step(template, opt, mu_exact, M, T)
    skips, applied, tail = 0, 0, []
    t0 = time.perf_counter()
    for i in range(AIS_TRAIN_STEPS):
        info = step(2, i)
        skips += int(info["skipped"])
        applied += int(not info["skipped"])
        if applied == 60:
            opt.param_groups[0]["lr"] = 0.08 * 0.25
        if i >= AIS_TRAIN_STEPS - 30:
            tail.append(mtrain._to_theta(raw, True).detach())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    theta_fit = torch.stack(tail).mean(dim=0)
    fitA = mA.with_theta(theta_fit[:dA])
    gA = (kernels.lnz_and_moments(fitA.cliques, fitA.n, fitA.theta, 1.0)[1]
          - muA).abs().max()
    tB = MRF.create(mB.cliques, device=dev)
    rawB = mtrain._from_theta(torch.full((tB.dimension,), -0.5, device=dev),
                              True).requires_grad_()
    stepB = mtrain.make_moment_train_step(tB, mtrain.adam([rawB], 0.1), muB)
    for _ in range(250):
        stepB()
    fitB = elimination.clique_marginals(
        tB.with_theta(mtrain._to_theta(rawB, True).detach()))
    gB = (elimination.clique_marginals(tB.with_theta(theta_fit[dA:]))
          - fitB).abs().max()
    require(skips < 20 and float(gA) < 0.08 and float(gB) < 0.08,
            f"{AIS_TRAIN_STEPS} AIS steps at {M} x {T} ({train_s:.2f} s, "
            f"{skips} skipped < 20): block A's exact moment gap at the "
            f"Polyak fit {float(gA):.4f} < 0.08 (lnz_moments kernel); block "
            f"B's marginals vs an elimination fit {float(gB):.4f} < 0.08")
    out.update(lnz_hat=float(lnz), lnz_exact=lnz_exact, ess=ess, stderr=se,
               marg_max_err=float(err.max()), marg_mean_err=float(err.mean()),
               train_skips=skips, train_gap_A=float(gA),
               train_gap_B=float(gB), train_s=train_s,
               ais_lnz_call_ms=lnz_ms)
    pB = float(elimination.conditional_prob(mB, joint.n - 1 - 27, 1))
    with tempfile.TemporaryDirectory() as tmp:
        print("[ais] main path")
        mp = ais_main_path(dev, joint, tmp, lnz_exact, mus[0], pB)
    out.update({k: v for k, v in mp.items() if k != "launches"})
    report["ais"] = out
    return mp["launches"]


NOISE_SCALES = (0.1, 0.25, 0.5)  # whisker's three scales
NOISE_SHOTS = 10_000
NOISE_WIDE = 3                   # graph 3, the chain of 5: width 10


def density_parity(suite, model, dev) -> dict:
    """The density engine on the card against the same code on CPU
    tensors, its batch against single evolutions, and its noiseless
    diagonal against the statevector route (the circuit kernel)."""
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.noise import physical
    from qcmrf_tpu_torch.ops import circuit_kernel

    worst = dict(card_vs_cpu=0.0, batch_vs_single=0.0, noiseless_vs_sv=0.0)
    sv = circuit_kernel.batched_circuits_probs(
        [(C, suite.thetas[g]) for g, C in enumerate(suite.graphs)],
        device=dev)
    for g, C in enumerate(suite.graphs):
        thetas = suite.thetas[g]
        mults = physical.rep_multipliers(model, g, len(thetas))
        lams = [model.lam[g] * u for u in mults]
        mrfs = [MRF.create(C, theta=t, device=dev) for t in thetas]
        one = physical.gate_noisy_probs(mrfs[0], lams[0])
        host = physical.gate_noisy_probs(
            MRF.create(C, theta=thetas[0], device="cpu"), lams[0])
        batch = physical.gate_noisy_probs_batch(mrfs, lams)
        singles = torch.stack([physical.gate_noisy_probs(m, lam)
                               for m, lam in zip(mrfs, lams)])
        clean = physical.gate_noisy_probs_batch(mrfs, [0.0] * len(mrfs))
        errs = dict(
            card_vs_cpu=float((one.cpu() - host).abs().max()),
            batch_vs_single=float((batch - singles).abs().max()),
            noiseless_vs_sv=float((clean - sv[g].double()).abs().max()))
        print(f"  graph {g} (width {int(one.numel()).bit_length() - 1}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        require(one.is_cuda and errs["card_vs_cpu"] <= 1e-5,
                f"graph {g}: card vs CPU {errs['card_vs_cpu']:.2e} <= 1e-5")
        require(errs["batch_vs_single"] <= 1e-6,
                f"graph {g}: batch vs single {errs['batch_vs_single']:.2e} "
                "<= 1e-6")
        require(errs["noiseless_vs_sv"] <= 1e-5,
                f"graph {g}: noiseless vs statevector "
                f"{errs['noiseless_vs_sv']:.2e} <= 1e-5")
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    return worst


def expected_acceptance(engine, suite, dev) -> list:
    """Each graph's mean expected delta of a mitigated engine on the card,
    at the multipliers the run uses: the accepted mass of the mitigated
    quasi-distribution's expectation (mitigation is linear)."""
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.noise import backends, channels, physical

    out = []
    for g, C in enumerate(suite.graphs):
        mrfs = [MRF.create(C, theta=t, device=dev) for t in suite.thetas[g]]
        n = mrfs[0].n
        width = n + len(C) + 1
        bits = backends.measured_bits(mrfs[0])
        if engine == "noisy:torino":
            pre = backends.preset("torino")
            qs = [channels.apply_readout_confusion(
                backends.noisy_outcome_probs(m, pre).double(),
                [pre.readout] * len(bits), width, bits, invert=True)
                for m in mrfs]
        else:
            model = physical.load_physical("torino", suite.scale)
            mults = physical.rep_multipliers(model, g, len(mrfs))
            probs = physical.gate_noisy_probs_batch(
                mrfs, [model.lam[g] * u for u in mults])
            qs = [physical.expected_quasi(m, model, g, probs[r], mults[r])
                  for r, m in enumerate(mrfs)]
        out.append(float(np.mean([float(q[: 1 << n].sum() / q.sum())
                                  for q in qs])))
    return out


def run_noise_engine(engine, scale, root, dev) -> dict:
    """``run --engine <engine>`` of the suite at ``scale`` on the card,
    then ``eval``; the launch counts of the whole path."""
    from qcmrf_tpu_torch.runners import eval as run_eval
    from qcmrf_tpu_torch.runners import run_experiment

    out_dir = os.path.join(root, f"res_{scale:g}")
    reset_counts()
    t0 = time.perf_counter()
    path = run_experiment.main([
        "--scale", f"{scale:g}", "--shots", str(NOISE_SHOTS), "--platform",
        "gpu", "--engine", engine, "--sample-seed", "0", "--outdir",
        out_dir])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = run_eval.main([
        "--results", os.path.basename(path), "--scale", f"{scale:g}",
        "--res-root", root, "--platform", "gpu", "--kl"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = read_counts()
    with open(path) as f:
        d = json.load(f)
    require(set(d) == {"quasi_dists", "metadata"}
            and len(d["quasi_dists"]) == 70,
            f"{engine}: 70 quasi-distributions and their metadata")
    return dict(path=path, run_s=run_s, eval_s=eval_s, results=results,
                launches=launches,
                negatives=sum(v < 0 for q in d["quasi_dists"]
                              for v in q.values()))


def time_wide_evolution(suite, model, dev) -> dict:
    """Graph 3 (width 10) at the torino 0.1 budget: one evolution and its
    10 reps batched by CUDA events, the bytes a gate pass moves, and the
    same single evolution on CPU tensors by the host clock."""
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.noise import physical

    g = NOISE_WIDE
    C, thetas = suite.graphs[g], suite.thetas[g]
    mults = physical.rep_multipliers(model, g, len(thetas))
    lams = [model.lam[g] * u for u in mults]
    mrfs = [MRF.create(C, theta=t, device=dev) for t in thetas]
    lcs = [physical.lowered_for_noise(m) for m in mrfs]
    w = lcs[0].num_qubits
    gates = [x.name for x in lcs[0].gates if x.name not in ("measure",)]
    counts = {k: gates.count(k) for k in sorted(set(gates))}
    single_ms = cuda_ms(lambda: physical.gate_noisy_probs(
        mrfs[0], lams[0], lowered=lcs[0]), 5)
    batch_ms = cuda_ms(lambda: physical.gate_noisy_probs_batch(
        mrfs, lams, lowered=lcs), 5)
    host = MRF.create(C, theta=thetas[0], device="cpu")
    host_lc = physical.lowered_for_noise(host)
    t0 = time.perf_counter()
    physical.gate_noisy_probs(host, lams[0], lowered=host_lc)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    pass_bytes = 2 * (1 << (2 * w)) * 8   # rho read once, written once
    non_diag = sum(v for k, v in counts.items() if k != "rz")
    row = dict(width=w, gates=counts, single_ms=single_ms,
               batch10_ms=batch_ms, batch10_per_rep_ms=batch_ms / 10,
               cpu_tensors_single_ms=cpu_ms, pass_bytes=pass_bytes,
               batch10_pass_bytes=10 * pass_bytes,
               non_diagonal_gates=non_diag,
               single_floor_ms=non_diag * pass_bytes / H100_BYTES_PER_S * 1e3,
               batch10_floor_ms=non_diag * 10 * pass_bytes
               / H100_BYTES_PER_S * 1e3)
    print(f"  width-{w} evolution (graph {g}, {len(gates)} lowered gates "
          f"{counts}): alone {single_ms:.3f} ms, 10 reps batched "
          f"{batch_ms:.3f} ms ({batch_ms / 10:.3f} a rep) by CUDA events; a "
          f"gate pass moves {pass_bytes / 2**20:.0f} MiB alone, "
          f"{10 * pass_bytes / 2**20:.0f} MiB batched: {non_diag} "
          f"non-diagonal gates, one pass each, at least "
          f"{row['single_floor_ms']:.3f} / {row['batch10_floor_ms']:.3f} ms")
    print(f"  (on CPU tensors, host clock, not a card figure: the same single "
          f"evolution {cpu_ms:.1f} ms)")
    return row


def phase_noise(dev, report) -> dict:
    """Slice 5 on the card: the density engine against the same code on
    CPU tensors, its batch against single evolutions and its noiseless
    diagonal against the circuit kernel; then ``run --engine
    noisy:torino`` and ``calibrated:torino`` at scale 0.1 and 10 000 shots,
    each through ``run_experiment.main`` and ``eval`` on the card (the row
    2 and row 4 launches counted), each graph's mean delta-hat within 0.02
    of its expected mean acceptance; ``whisker`` from the three scales'
    noisy files; the width-10 evolution timed alone and batched."""
    from qcmrf_tpu_torch.models.suite import generate_suite
    from qcmrf_tpu_torch.noise import physical
    from qcmrf_tpu_torch.viz import whisker

    out = {}
    suite = generate_suite(0.1)
    model = physical.load_physical("torino", 0.1)
    print("[noise] density engine, first rep of each suite graph at the "
          "torino 0.1 budget: card vs CPU tensors (<= 1e-5), 10 reps batched"
          " vs single (<= 1e-6), noiseless vs the circuit kernel (<= 1e-5)")
    out["parity"] = density_parity(suite, model, dev)
    with tempfile.TemporaryDirectory() as root:
        for engine in ("noisy:torino", "calibrated:torino"):
            r = run_noise_engine(engine, 0.1, root, dev)
            want = expected_acceptance(engine, suite, dev)
            rows = []
            for res, exp in zip(r["results"], want):
                gap = abs(res.mean_delta - exp)
                rows.append(dict(graph=res.graph, mean_f=res.mean_f,
                                 mean_delta=res.mean_delta,
                                 expected_delta=exp, mean_kl=res.mean_kl))
                print(f"  [{engine}] graph {res.graph}: F {res.mean_f:.4f} "
                      f"delta-hat {res.mean_delta:.4f} (expected {exp:.4f}, "
                      f"|gap| {gap:.4f}) KL {res.mean_kl:.4f}")
                require(gap <= 0.02, f"{engine} graph {res.graph}: mean "
                                     f"delta-hat within 0.02 of {exp:.4f}")
            lp, ls = r["launches"]["logpot"], r["launches"]["lse"]
            print(f"  [{engine}] run {r['run_s']:.3f} s, eval {r['eval_s']:.3f}"
                  f" s on the card (host clock, ending in a synchronise); "
                  f"{r['negatives']} negative quasi-probabilities; launches "
                  f"during run -> eval: logpot {lp}, lse {ls}")
            require(lp > 0 and ls > 0, f"{engine}: eval launched the logpot "
                                       f"({lp}) and lse ({ls}) kernels")
            out[engine] = dict(run_s=r["run_s"], eval_s=r["eval_s"],
                               launches={"logpot": lp, "lse": ls},
                               negatives=r["negatives"], graphs=rows)
            if engine == "noisy:torino":
                shutil.copy(r["path"], os.path.join(
                    root, "res_0.1", "result_noisy_torino.json"))
            else:
                profiled("run --engine calibrated:torino -> eval", report,
                         lambda: run_noise_engine(engine, 0.1, root, dev))
        for scale in NOISE_SCALES[1:]:
            r = run_noise_engine("noisy:torino", scale, root, dev)
            shutil.copy(r["path"], os.path.join(
                root, f"res_{scale:g}", "result_noisy_torino.json"))
        pdf = os.path.join(root, "success_noisy_torino.pdf")
        t0 = time.perf_counter()
        whisker.main(["--backend", "noisy_torino", "--res-root", root,
                      "--platform", "gpu", "--out", pdf])
        torch.cuda.synchronize()
        out["whisker_s"] = time.perf_counter() - t0
        size = os.path.getsize(pdf)
        import importlib.util

        out["renderer"] = ("matplotlib" if importlib.util.find_spec(
            "matplotlib") else "plain")
        print(f"  whisker --backend noisy_torino: {out['whisker_s']:.3f} s, "
              f"{size} bytes of PDF ({out['renderer']} renderer)")
        require(size > 1000, "whisker wrote its PDF")
    out["wide"] = time_wide_evolution(suite, model, dev)
    report["noise"] = out
    return out


# ---------------------------------------------------------------------------
# The state-id offset of rows 2-7, the sharded sweeps, bench and profiles
# ---------------------------------------------------------------------------


def profiled(label: str, report, fn):
    """``fn()`` under ``profiling.trace`` (a trace in a temporary
    directory): the CUDA kernels' busy time and the idle share of the
    traced window (``profiling.device_busy``), printed and kept in
    ``report["busy"][label]``. Returns ``fn()``'s result."""
    from qcmrf_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            out = fn()
        b = profiling.device_busy(profiling.trace_files(d)[-1])
    report.setdefault("busy", {})[label] = b
    top = ", ".join(f"{name[:40]} {ms:.3f} ms x{k}"
                    for name, ms, k in b["top"][:3])
    print(f"  [profile] {label}: {b['kernels']} kernels, busy "
          f"{b['busy_ms']:.3f} ms, union {b['union_ms']:.3f} ms of a "
          f"{b['window_ms']:.3f} ms window: idle share "
          f"{b['idle_share']:.4f}; longest gap "
          f"{(b['gaps'] or [[0, 0]])[0][1]:.3f} ms; top: {top} "
          f"({time.perf_counter() - t0:.1f} s, trace written and read)")
    require(b["kernels"] > 0, f"{label}: the trace holds the card's kernels")
    return out


def quiet(fn, *args):
    """``fn(*args)`` with its standard output dropped."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def ranges(n: int, pieces: int) -> list:
    """``pieces`` equal ``(x0_blocks, blocks)`` ranges of an n-variable
    sweep."""
    from qcmrf_tpu_torch.ops import kernels

    per = kernels.lse_geometry(1 << n)[0] // pieces
    return [(i * per, per) for i in range(pieces)]


def offset_outputs(mrf, lnz, rng=(0, None)) -> dict:
    """Rows 2, 4, 5, 6 and 7 over one range (the whole sweep by default):
    the table (n <= 28), the lse, map, moments (for ``lnz``) and fused
    partials, each with its blocks along dimension 1."""
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.utils import moebius

    x0, b = rng
    cl, n, beta = mrf.cliques, mrf.n, mrf.beta
    coef = kernels.moebius_coefficients(mrf)[None]
    masks = moebius.device_masks(cl, n, mrf.device)
    out = dict(zip(("lse_m", "lse_s"), kernels.lse_partials(
        cl, n, coef, beta, x0, b)))
    out.update(zip(("map_v", "map_x"), kernels.map_partials(
        cl, n, coef, beta, None, x0, b)))
    out["moments"] = kernels.monomial_moment_partials(cl, n, coef, beta,
                                                      lnz, masks, x0, b)
    out.update(zip(("fused_m", "fused_s"), kernels.lnz_moments_partials(
        cl, n, coef, beta, masks, x0, b)))
    if n <= 28:
        out["table"] = kernels.logpot_table(cl, n, coef, beta, False, x0, b)
    return out


def combined(o) -> tuple:
    """(lnZ, MAP id, moments, fused lnZ) from a sweep's outputs."""
    from qcmrf_tpu_torch.ops import kernels

    fused = kernels.combine_lnz_moments(o["fused_m"], o["fused_s"])
    return (kernels.combine_lse(o["lse_m"], o["lse_s"]),
            kernels.combine_map(o["map_v"], o["map_x"])[1],
            o["moments"].sum(dim=1, dtype=torch.float64), fused[0],
            fused[1])


def check_offset_plain(mrf, lnz, what: str) -> float:
    """Each kernel against its plain version on one block at a nonzero
    offset (the last block): the table bit for bit against the split's,
    map bit for bit, lse, the moments and the fused sweep within 1e-4 /
    1e-6 of the chain's. Returns the largest lse / moments difference."""
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.utils import moebius

    cl, n, beta = mrf.cliques, mrf.n, mrf.beta
    coef = kernels.moebius_coefficients(mrf)[None]
    masks = moebius.device_masks(cl, n, mrf.device)
    x0 = kernels.lse_geometry(1 << n)[0] - 1
    rng = (x0, 1)
    require(torch.equal(
        kernels.logpot_table(cl, n, coef, beta, False, *rng),
        kernels.logpot_table_split_reference(cl, n, coef, beta, False,
                                             *rng)),
            f"{what}: the table at x0_blocks={x0} == its split plain "
            "version (torch.equal)")
    got = kernels.map_partials(cl, n, coef, beta, None, *rng)
    want = kernels.map_partials_reference(cl, n, coef, beta, *rng)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{what}: map at x0_blocks={x0} == its plain version "
            f"(id {int(got[1][0, 0])})")
    e_lse = abs(float(kernels.combine_lse(*kernels.lse_partials(
        cl, n, coef, beta, *rng))[0]) - float(kernels.combine_lse(
            *kernels.lse_partials_reference(cl, n, coef, beta, *rng))[0]))
    require(e_lse <= 1e-4, f"{what}: lse at x0_blocks={x0} within 1e-4 of "
                           f"its plain version ({e_lse:.2e})")
    e_mom = float((kernels.monomial_moments(cl, n, coef, beta, lnz, masks,
                                            *rng)
                   - kernels.monomial_moments_reference(
                       cl, n, coef.double(), beta, lnz.double(), masks,
                       *rng)).abs().max())
    require(e_mom <= 1e-6, f"{what}: moments at x0_blocks={x0} within 1e-6 "
                           f"of the chain in float64 ({e_mom:.2e})")
    gz, gm = kernels.combine_lnz_moments(*kernels.lnz_moments_partials(
        cl, n, coef, beta, masks, *rng))
    wz, wm = kernels.combine_lnz_moments(
        *kernels.lnz_moments_partials_reference(cl, n, coef, beta, masks,
                                                *rng))
    e_fused = max(abs(float(gz[0] - wz[0])), float((gm - wm).abs().max()))
    require(e_fused <= 1e-5, f"{what}: the fused sweep at x0_blocks={x0} "
                             f"within 1e-5 of its plain version "
                             f"({e_fused:.2e})")
    return max(e_lse, e_mom, e_fused)


def phase_offset(dev, report) -> None:
    """Rows 2, 4, 5, 6 and 7 with the state-id offset: on K27 and the n=28
    grid, the sweep split into 2 and 4 block ranges by ``x0_blocks``, the
    pieces concatenated in range order ``torch.equal`` to the single
    sweep's outputs, and the combined lnZ, MAP id and moments equal to its;
    each kernel against its plain version at a nonzero offset; a
    34-variable chain's map and lse over 2 and 4 ranges (ids past 2^33)."""
    from qcmrf_tpu_torch.models.mrf import MRF
    from qcmrf_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    print("[offset] rows 2, 4, 5, 6, 7 over 2 and 4 x0_blocks ranges")
    models = (("K27", MRF.create(complete_cliques(INFER_N),
                                 theta=k27_theta(), device=dev)),
              ("n=28 grid 4x7", grid_model(4, 7, 2, dev)))
    err = 0.0
    for what, mrf in models:
        lnz = kernels.log_partition(mrf)[None]
        whole = offset_outputs(mrf, lnz)
        want = combined(whole)
        for pieces in (2, 4):
            outs = [offset_outputs(mrf, lnz, r)
                    for r in ranges(mrf.n, pieces)]
            cat = {k: torch.cat([o[k] for o in outs], dim=1) for k in whole}
            same = [k for k in whole if torch.equal(cat[k], whole[k])]
            require(len(same) == len(whole),
                    f"{what}: {pieces} ranges concatenate to the single "
                    f"sweep's {sorted(whole)} (torch.equal; equal: {same})")
            got = combined(cat)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"{what}: {pieces} ranges give the single sweep's lnZ "
                    f"{float(want[0][0]):.6f}, MAP id {int(want[1][0])} and "
                    "moments (equal)")
        err = max(err, check_offset_plain(mrf, lnz, what))
        del whole, outs, cat
        torch.cuda.empty_cache()
    chain = seeded_model([[i, i + 1] for i in range(33)], 5, 0.3, dev)
    whole = [*kernels_lse_map(chain)]
    for pieces in (2, 4):
        rngs = ranges(34, pieces)
        outs = [kernels_lse_map(chain, r) for r in rngs]
        cat = [torch.cat([o[k] for o in outs], dim=1) for k in range(4)]
        require(all(torch.equal(c, w) for c, w in zip(cat, whole)),
                f"34-chain: lse and map over {pieces} ranges == the single "
                "sweep (torch.equal)")
        lo = rngs[-1][0] * kernels.lse_geometry(1 << 34)[1]
        ids = outs[-1][3]
        require(bool((ids >= lo).all()) and lo >= 1 << 31,
                f"34-chain: the upper range's ids start at {lo} (past 2^31) "
                f"and its MAP ids lie in it (max {int(ids.max())})")
    err = max(err, check_offset_plain(
        chain, kernels.log_partition(chain)[None], "34-chain"))
    report["offset"] = dict(max_plain_err=err,
                            seconds=time.perf_counter() - t0)
    print(f"  offset phase {report['offset']['seconds']:.1f} s")


def kernels_lse_map(mrf, rng=(0, None)):
    """(lse m, lse s, map v, map x) of one range."""
    from qcmrf_tpu_torch.ops import kernels

    coef = kernels.moebius_coefficients(mrf)[None]
    args = (mrf.cliques, mrf.n, coef, mrf.beta)
    return (*kernels.lse_partials(*args, *rng),
            *kernels.map_partials(*args, None, *rng))


def binomial_ok(p_hat: float, p: float, shots: int) -> bool:
    return abs(p_hat - p) <= 5 * math.sqrt(p * (1 - p) / shots)


def per_shard(kernel: str, shards: int, what: str, fn):
    """``fn()``, required to launch ``kernel`` a multiple of ``shards``
    times and at least once a shard (every shard's sweep or draw went
    through the kernel). Returns ``fn()``'s result."""
    before = read_counts()[kernel]
    out = fn()
    k = read_counts()[kernel] - before
    require(k >= shards and k % shards == 0,
            f"{what}: {k} {kernel} launches, one or more a shard of "
            f"{shards}")
    return out


@contextlib.contextmanager
def four_shards(dev):
    """``sharded.visible_devices`` as four shards of ``dev`` while the
    block runs, so that the CLIs' ``--mesh 2x2`` builds
    ``Mesh((dev,) * 4)`` (the card is one device to the program)."""
    from qcmrf_tpu_torch.parallel import sharded

    real = sharded.visible_devices
    sharded.visible_devices = lambda device=None: (dev,) * 4
    try:
        yield
    finally:
        sharded.visible_devices = real


def sharded_models(dev) -> dict:
    from qcmrf_tpu_torch.models.mrf import MRF

    return {"K27": MRF.create(complete_cliques(INFER_N), theta=k27_theta(),
                              device=dev),
            "n=28 grid 4x7": grid_model(4, 7, 2, dev),
            "n=24 grid 4x6": grid_model(4, 6, 3, dev),
            "PAM n=24": pam_n24(dev),
            "n=20 grid 4x5": grid_model(4, 5, 0, dev),
            "n=8 blocks": MRF.create(
                complete_cliques(8), theta=np.random.RandomState(4).randn(
                    4 * 28).astype(np.float32) * -0.1, device=dev)}


#: the sharded path's shot count: the n=20 grid's estimates and draws
SHARD_SHOTS = 1 << 24


def sharded_calls(models: dict, mesh) -> dict:
    """Every sweep and shot path of ``parallel/sharded.py`` and the AIS
    chains on ``mesh``, each required to launch its kernel a shard at a
    time (:func:`per_shard`): their answers by name."""
    from qcmrf_tpu_torch.models import ais
    from qcmrf_tpu_torch.parallel import sharded

    D, out = mesh.size, {}
    for what in ("K27", "n=28 grid 4x7"):
        m = models[what]
        out[what, "lnZ"] = per_shard(
            "lse", D, f"{what} sharded lnZ",
            lambda: sharded.sharded_log_partition(m, mesh))
        out[what, "MAP"] = per_shard(
            "map", D, f"{what} sharded MAP",
            lambda: sharded.sharded_map_state(m, mesh))
        out[what, "moments"] = per_shard(
            "moments", D, f"{what} sharded moments",
            lambda: sharded.sharded_clique_moments(m, mesh,
                                                   out[what, "lnZ"]))
        out[what, "fused"] = per_shard(
            "lnz_moments", D, f"{what} sharded lnZ + moments",
            lambda: sharded.sharded_lnz_and_moments(m, mesh))
    m24 = models["n=24 grid 4x6"]
    out["gibbs"] = per_shard("logpot", D, "n=24 sharded Gibbs table",
                             lambda: sharded.sharded_gibbs_probs(m24, mesh))
    out["success"] = per_shard(
        "lse", D, "n=24 sharded success rate",
        lambda: float(sharded.sharded_success_rate(m24, mesh)))
    out["pam"] = per_shard("map", D, "PAM n=24 sharded",
                           lambda: sharded.sharded_sample_pam(
                               3, models["PAM n=24"], mesh, 16))
    m20 = models["n=20 grid 4x5"]
    out["delta"] = per_shard("sampler", D, "n=20 sharded delta estimates",
                             lambda: sharded.sharded_estimate_delta(
                                 11, m20, mesh, SHARD_SHOTS, 3))
    out["shot moments"] = per_shard(
        "sampler", D, "n=20 sharded shot moments",
        lambda: sharded.sharded_shot_moments(11, m20, mesh, SHARD_SHOTS))
    out["postselected"] = per_shard(
        "sampler", D, "n=20 sharded post-selected shots",
        lambda: sharded.sharded_sample_postselected(11, m20, mesh,
                                                    SHARD_SHOTS))
    out["ais"] = per_shard("gibbs_ais", D, "AIS chains over the shards",
                           lambda: ais._run(7, models["n=8 blocks"], 256,
                                            32, 1, 0, mesh))
    torch.cuda.synchronize()
    return out


def k27_files(tmp) -> list:
    """``infer``'s K27 arguments: the graph and theta files in ``tmp``."""
    graph = os.path.join(tmp, "k27.json")
    theta = os.path.join(tmp, "theta.json")
    with open(graph, "w") as f:
        json.dump(complete_cliques(INFER_N), f)
    with open(theta, "w") as f:
        json.dump(k27_theta().tolist(), f)
    return ["--graph", graph, "--theta", theta, "--platform", "gpu"]


#: the sharded path's CLI runs: infer queries on K27, train fits on a
#: 5-chain (exact and shot gradients)
SHARD_QUERIES = (["--query", "lnz"],
                 ["--query", "marginals", "--evidence", "2=1"],
                 ["--query", "map", "--evidence", "0=1"])
SHARD_FITS = (("exact", []),
              ("shots", ["--grad", "shots", "--grad-shots", "8192"]))


def sharded_clis(tmp, mesh_args) -> tuple:
    """``infer`` (:data:`SHARD_QUERIES` on K27) and ``train``
    (:data:`SHARD_FITS`, 60 steps of a 5-chain) with ``mesh_args``
    appended: (answers, fitted docs, seconds of each command)."""
    from qcmrf_tpu_torch.runners import infer_cli, train_cli

    base, answers, fits, secs = k27_files(tmp), [], {}, []
    for q in SHARD_QUERIES:
        t0 = time.perf_counter()
        answers.append(quiet(infer_cli.main, base + q + mesh_args))
        secs.append(time.perf_counter() - t0)
    for label, extra in SHARD_FITS:
        t0 = time.perf_counter()
        out = quiet(train_cli.main, [
            "--graph", "chain:5", "--steps", "60", "--checkpoint-every", "60",
            "--platform", "gpu", "--outdir", os.path.join(
                tmp, label + str(len(mesh_args)))] + extra + mesh_args)
        with open(out) as f:
            fits[label] = json.load(f)
        secs.append(time.perf_counter() - t0)
    return answers, fits, secs


def phase_sharded(dev, report) -> dict:
    """The sharded path (slice 6a) alone, launch counts reset just before
    it and read just after: every sweep and shot path of
    ``parallel/sharded.py`` and the AIS chains on ``Mesh((cuda:0,) * 4)``,
    four shards on the one card, each launching its kernel a shard at a
    time, then ``infer --mesh 2x2`` and ``train --mesh 2x2`` on the same
    four shards. Outside that window, the same calls without a mesh and
    the comparison: MAP ids equal, lnZ within 1e-5, moments within 1e-6,
    PAM and AIS equal (one generator, the same chains), the shot estimates
    within 5 binomial sigma, the CLIs at the JAX pins' bars
    (tests/test_infer_cli.py: lnZ rtol 1e-5, marginals 2e-5;
    tests/test_train_cli.py: theta within 5e-3 exact, 0.35 and NLL under
    3.2 with shots); then one device's and the four shards' times,
    labelled as shards on one card, not as a multi-chip figure. Returns
    the path's launch counts."""
    from qcmrf_tpu_torch.models import ais, moments
    from qcmrf_tpu_torch.models import sample as msample
    from qcmrf_tpu_torch.ops import kernels
    from qcmrf_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    mesh = sharded.Mesh((dev,) * 4)
    models = sharded_models(dev)
    print("[sharded] Mesh((cuda:0,) * 4): four shards on one card")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        reset_counts()
        got = sharded_calls(models, mesh)
        with four_shards(dev):
            answers4, fits4, secs4 = sharded_clis(tmp, ["--mesh", "2x2"])
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"  the sharded path's launches: {launches}")
        answers1, fits1, secs1 = sharded_clis(tmp, [])

    for what in ("K27", "n=28 grid 4x7"):
        m = models[what]
        lnz1 = kernels.log_partition(m)
        e = abs(float(got[what, "lnZ"] - lnz1))
        require(e <= 1e-5, f"{what}: sharded lnZ {float(got[what, 'lnZ']):.6f}"
                           f" within 1e-5 of one device's ({e:.2e})")
        require(got[what, "MAP"] == kernels.map_state_streaming(m),
                f"{what}: sharded MAP id == one device's")
        e_mu = float((got[what, "moments"]
                      - moments.clique_moments_streaming(m, lnz1))
                     .abs().max())
        require(e_mu <= 1e-6, f"{what}: sharded moments within 1e-6 "
                              f"({e_mu:.2e})")
        fz1, fm1 = kernels.lnz_and_moments(m.cliques, m.n, m.theta, m.beta)
        fz4, fm4 = got[what, "fused"]
        e_f = max(abs(float(fz4 - fz1)), float((fm4 - fm1).abs().max()))
        require(e_f <= 1e-6, f"{what}: sharded fused lnZ and moments within "
                             f"1e-6 ({e_f:.2e})")
    m24 = models["n=24 grid 4x6"]
    require(torch.equal(got["gibbs"], m24.gibbs_probs()),
            "n=24: sharded Gibbs table == one device's (torch.equal)")
    d24 = float(m24.success_rate())
    require(abs(got["success"] - d24) <= 1e-6 * d24,
            "n=24: sharded success rate == one device's")
    require(torch.equal(got["pam"], msample.sample_pam_streaming(
        3, models["PAM n=24"], 16)),
            "PAM n=24: 16 sharded samples == one device's from one generator"
            " seed (equal, so equal in distribution)")
    m20 = models["n=20 grid 4x5"]
    delta, shots = float(m20.success_rate()), SHARD_SHOTS
    require(all(binomial_ok(float(e), delta, shots) for e in got["delta"]),
            f"n=20 grid: 3 sharded delta estimates {got['delta'].tolist()} "
            f"within 5 binomial sigma of Z/2^n {delta:.6e}")
    marg, dhat = got["shot moments"]
    mu = kernels.lnz_and_moments(m20.cliques, m20.n, m20.theta,
                                 m20.beta)[1].double()
    sig = torch.sqrt(mu * (1 - mu) / (dhat * shots))
    require(binomial_ok(dhat, delta, shots)
            and bool(((marg - mu).abs() <= 5 * sig + 1e-12).all()),
            f"n=20 grid: sharded shot moments within 5 sigma of the exact "
            f"marginals, delta-hat {dhat:.6e}")
    x, a = got["postselected"]
    require(x.shape == (shots,) and binomial_ok(float(a.float().mean()),
                                                delta, shots),
            "n=20 grid: sharded post-selected shots, acceptance within 5 "
            "sigma")
    lw1, b1 = ais._run(7, models["n=8 blocks"], 256, 32, 1, 0, None)
    require(torch.equal(lw1, got["ais"][0]) and torch.equal(b1,
                                                           got["ais"][1]),
            "AIS: 256 chains over 4 shards == one launch (log-weights and "
            "states equal)")

    for q, g, w, t4, t1 in zip(SHARD_QUERIES, answers4, answers1, secs4,
                               secs1):
        if "lnz" in w:
            ok = abs(g["lnz"] - w["lnz"]) <= 1e-5 * abs(w["lnz"])
        elif "marginals" in w:
            ok = np.allclose(g["marginals"], w["marginals"], rtol=0,
                             atol=2e-5)
        else:
            ok = g["state_bits"] == w["state_bits"]
        require(ok, f"infer {' '.join(q)} --mesh 2x2 on K27 == without a "
                    f"mesh (JAX's bars); {t4:.3f} s on four shards of one "
                    f"card, {t1:.3f} s on one")
    gap = float(np.abs(np.subtract(fits4["exact"]["theta"],
                                   fits1["exact"]["theta"])).max())
    require(gap <= 5e-3, f"train chain:5 --mesh 2x2, 60 exact steps: theta "
                         f"within 5e-3 of one device's ({gap:.2e}); "
                         f"{secs4[3]:.3f} s / {secs1[3]:.3f} s")
    sgap = float(np.abs(np.subtract(fits4["shots"]["theta"],
                                    fits1["shots"]["theta"])).max())
    nll = fits4["shots"]["final_nll"]
    require(sgap <= 0.35 and nll < 3.2,
            f"train --grad shots --mesh 2x2: theta within 0.35 ({sgap:.3f}),"
            f" final NLL {nll:.3f} < 3.2")

    rows = {}
    for what in ("K27", "n=28 grid 4x7"):
        m = models[what]
        t = {"lnZ": (lambda: kernels.log_partition(m),
                     lambda: sharded.sharded_log_partition(m, mesh)),
             "lnZ + moments": (
                 lambda: kernels.lnz_and_moments(m.cliques, m.n, m.theta,
                                                 m.beta),
                 lambda: sharded.sharded_lnz_and_moments(m, mesh)),
             "MAP": (lambda: kernels.map_state_streaming(m),
                     lambda: sharded.sharded_map_state(m, mesh))}
        rows[what] = {k: dict(one_ms=cuda_ms(a, reps=5),
                              shards4_ms=cuda_ms(b, reps=5))
                      for k, (a, b) in t.items()}
        print(f"  {what}: lnZ, MAP and moments as one device's; times, one "
              "device vs four shards on one card: " + "; ".join(
                  f"{k} {r['one_ms']:.3f} / {r['shards4_ms']:.3f} ms"
                  for k, r in rows[what].items()))
    report["sharded"] = dict(times=rows, launches=launches,
                             cli_seconds=dict(shards4=secs4, one=secs1),
                             seconds=time.perf_counter() - t_phase)
    print(f"  sharded phase {report['sharded']['seconds']:.1f} s")
    return launches


def permuted_wiring(n: int):
    """A circuit of ``n`` qubits whose qubits go to clbits in a random
    order: on four shards its rz, cp and cx gates take the fused path's
    diag, lane, row and sandwich passes and an exchange (sx on a device
    qubit)."""
    from qcmrf_tpu_torch.circuits.ir import Circuit

    c = Circuit(n, num_clbits=n)
    rng = np.random.RandomState(2)
    for q in range(n):
        c.h(q)
    for q in (n - 1, n - 2, 3, 9):
        c.rz(float(rng.uniform(-np.pi, np.pi)), q)
    c.cx(n - 1, 0).cp(0.6, n - 2, 1).cx(2, n - 3).sx(n - 2).cx(n - 2, 8)
    for q, k in enumerate(rng.permutation(n)):
        c.measure(q, int(k))
    return c


def measured_subset(n: int):
    """``n`` qubits, a superposed unmeasured qubit and five measured into
    a 5-bit register out of order: the keyed reduce-scatter."""
    from qcmrf_tpu_torch.circuits.ir import Circuit

    c = Circuit(n, num_clbits=5)
    for q in range(n):
        c.h(q)
    c.cx(n - 1, 1).rz(0.4, n - 2).sx(10).cp(0.7, 4, n - 1)
    for q, k in ((n - 1, 0), (1, 2), (3, 1), (n - 2, 4), (10, 3)):
        c.measure(q, k)
    return c


#: the sharded engine's kernels: each must launch in its window
GATE_SHARDED_KERNELS = ("hdh_multi", "hdh_multi_uniform", "diag",
                        "row_gate", "lane_factored")
#: sampled amplitudes of the width-32 sharded state held against the
#: single-card engine's
SAMPLED_AMPLITUDES = 1 << 20


def sharded_max_diff(parts, want) -> float:
    """Max |gather(parts) - want| shard by shard (no gathered copy)."""
    flat, off, worst = want.reshape(-1), 0, 0.0
    for p in parts:
        worst = max(worst, float((p - flat[off:off + p.numel()]).abs()
                                 .max()))
        off += p.numel()
    return worst


def exchange_ms(mesh, re, im, dev_j: int, loc_p: int, local_n: int) -> dict:
    """One targeted exchange on the shards ``re``, ``im`` by CUDA events,
    beside its bound: each pair reads and writes both of its half-shards
    once, per plane (the scratch's third copy is over it)."""
    from qcmrf_tpu_torch.parallel import sharded

    re, im = list(re), list(im)

    def run():
        streams = sharded._shard_streams(mesh)
        sharded._exchange(re, im, streams, dev_j, loc_p, local_n)
        sharded._join(streams, zip(re, im))

    ms = cuda_ms(run, reps=5)
    half = (1 << (local_n - 1)) * 4
    return dict(ms=ms, **bound(2 * mesh.size * half * 2, 0.0))


def example_runs(root) -> dict:
    """Every port example at full size on the card, and ``scaling --n 28
    --devices 1 --gate-level --json``, as subprocesses five at a time, with
    a temporary directory of their own (example 05 writes its figure
    there): seconds and the last output line of each; raises where one
    fails. ``fit_physical.py`` needs the reference's hardware tables, which
    the repository does not hold: its tests run ``--help``."""
    import concurrent.futures

    ex = os.path.join(root, "qcmrf_tpu_torch", "examples")
    tmp = tempfile.mkdtemp()
    env = {k: v for k, v in os.environ.items()
           if k != "QCMRF_EXAMPLE_SMOKE"}
    env["TMPDIR"] = tmp
    cmds = {name: [sys.executable, os.path.join(ex, name)]
            for name in sorted(os.listdir(ex))
            if name.endswith(".py") and name[:2].isdigit()}
    cmds["scaling"] = [sys.executable, "-m", "qcmrf_tpu_torch.runners."
                       "scaling", "--n", "28", "--devices", "1",
                       "--gate-level", "--json"]

    def run(item):
        name, cmd = item
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
        return name, r, time.perf_counter() - t0

    out = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=5) as pool:
            for name, r, secs in pool.map(run, cmds.items()):
                if r.returncode != 0:
                    raise AssertionError(f"{name} exited {r.returncode}: "
                                         f"{r.stderr[-2000:]}")
                last = r.stdout.strip().splitlines()[-1]
                out[name] = dict(seconds=secs, last=last)
                print(f"  {name}: {secs:.1f} s; {last[:150]}")
        pdf = os.path.join(tmp, "torch_success_torino.pdf")
        require(os.path.exists(pdf), "example 05 wrote its whisker figure "
                                     "into its TMPDIR")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_gate_sharded(dev, report) -> dict:
    """The gate-level sharded engine (slice 6b) on the card, its launches
    counted in its own window: bench.py's qcmrf28 chain on one shard and
    on four shards of the card, ``sharded_outcome_probs`` of a 14-qubit
    permuted wiring and a measured subset on four shards, and the full
    16-variable chain (32 qubits, 32 GiB of planes) on four shards. After
    the window: qcmrf28 on 1 and 4 shards equal to the single-card engine
    within 1e-6 (4 shards exchange >= 2 times); the distributions equal to
    ``planes.simulate_probs`` within 1e-6; the width-32 state's norm within
    1e-4, its accepted mass Z / 2^n within 1e-5, and 2^20 amplitudes at
    fixed random global indices within 1e-6 of the single-card engine's
    (read before the shards are freed and that engine runs). Then, each in
    its own window, ``dryrun_multichip(Mesh((dev,) * 4))``; times of the
    engines and of one exchange; the examples at full size and ``scaling
    --gate-level`` as subprocesses. Returns the engine window's launch
    counts and the dry run's."""
    from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
    from qcmrf_tpu_torch.parallel import dryrun, sharded
    from qcmrf_tpu_torch.sim import planes

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mesh1, mesh4 = sharded.Mesh((dev,)), sharded.Mesh((dev,) * 4)
    m28, m32 = chain_model(14, dev), chain_model(16, dev)
    c28 = compile_qcmrf(m28, with_measurements=False)
    c32 = compile_qcmrf(m32, with_measurements=False)
    c_perm, c_sub = permuted_wiring(14), measured_subset(14)
    idx = torch.from_numpy(np.sort(np.random.RandomState(5).randint(
        0, 1 << c32.num_qubits, SAMPLED_AMPLITUDES,
        dtype=np.int64))).to(dev)
    print("[gate sharded] the gate-level sharded engine: Mesh((cuda:0,)) "
          "and Mesh((cuda:0,) * 4), shards on one card")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s28 = {1: sharded.run_statevector_sharded(c28, mesh1)}
    remaps = {"qcmrf28 x1": sharded.LAST_REMAP_COUNT}
    s28[4] = sharded.run_statevector_sharded(c28, mesh4)
    remaps["qcmrf28 x4"] = sharded.LAST_REMAP_COUNT
    probs = {"permuted": sharded.sharded_outcome_probs(c_perm, mesh4)}
    remaps["permuted x4"] = sharded.LAST_REMAP_COUNT
    probs["subset"] = sharded.sharded_outcome_probs(c_sub, mesh4)
    remaps["subset x4"] = sharded.LAST_REMAP_COUNT
    t32 = time.perf_counter()
    re32, im32 = sharded.run_statevector_sharded(c32, mesh4)
    remaps["qcmrf32 x4"] = sharded.LAST_REMAP_COUNT
    torch.cuda.synchronize()
    s32_first = time.perf_counter() - t32
    window_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  the engine's window: {window_s:.3f} s (qcmrf32 on 4 shards, "
          f"planner included, {s32_first:.3f} s); peak {peak:.2f} GiB; "
          f"remaps {remaps}; launches {launches}")
    for k in GATE_SHARDED_KERNELS:
        require(launches[k] > 0, f"kernel {k} launched {launches[k]} times "
                                 "on the gate-level sharded path")
    require(remaps["qcmrf28 x4"] >= 2 and remaps["qcmrf32 x4"] >= 2
            and remaps["qcmrf28 x1"] == 0,
            "qcmrf28 and qcmrf32 on 4 shards exchange >= 2 times, none on "
            "one")

    # qcmrf32: norm, accepted mass, sampled amplitudes; then the shards go
    L = re32[0].numel().bit_length() - 1
    norm = sum(norm_float64(r, i_) for r, i_ in zip(re32, im32))
    acc = norm_float64(re32[0][: 1 << m32.n], im32[0][: 1 << m32.n])
    delta = float(m32.success_rate())
    sh, loc = idx >> L, idx & ((1 << L) - 1)
    got_re = torch.empty(idx.shape, device=dev)
    got_im = torch.empty(idx.shape, device=dev)
    for d in range(4):
        sel = sh == d
        got_re[sel] = re32[d][loc[sel]]
        got_im[sel] = im32[d][loc[sel]]
    del re32, im32
    torch.cuda.empty_cache()
    require(abs(norm - 1.0) <= 1e-4, f"qcmrf32 on 4 shards: norm {norm:.8f}"
                                     " within 1e-4 of 1")
    require(abs(acc - delta) <= 1e-5, f"qcmrf32 on 4 shards: accepted mass "
                                      f"{acc:.8f} within 1e-5 of Z/2^n "
                                      f"{delta:.8f}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wr, wi = planes.run_statevector(c32, device=dev)
    torch.cuda.synchronize()
    one32 = time.perf_counter() - t1
    e32 = max(float((got_re - wr.view(-1)[idx]).abs().max()),
              float((got_im - wi.view(-1)[idx]).abs().max()))
    del wr, wi, got_re, got_im
    torch.cuda.empty_cache()
    require(e32 <= 1e-6, f"qcmrf32: {SAMPLED_AMPLITUDES} amplitudes at "
                         f"fixed random indices within 1e-6 of the single-"
                         f"card engine's ({e32:.2e})")
    # qcmrf32 on 4 shards apart: the planner alone on the host clock, then
    # the cached call by CUDA events (each call frees its 32 GiB on return)
    t1 = time.perf_counter()
    sharded._plan_fused(c32, L, 2)
    plan32_s = time.perf_counter() - t1
    s32_ms = cuda_ms(lambda: sharded.run_statevector_sharded(c32, mesh4),
                     reps=2)

    wr, wi = planes.run_statevector(c28, device=dev)
    for D in (1, 4):
        e = max(sharded_max_diff(s28[D][0], wr), sharded_max_diff(
            s28[D][1], wi))
        require(e <= 1e-6, f"qcmrf28 on {D} shard(s) == the single-card "
                           f"engine within 1e-6 ({e:.2e})")
    del wr, wi
    for what, c in (("permuted", c_perm), ("subset", c_sub)):
        want = planes.simulate_probs(c, device=dev)
        e = float((sharded.gather(probs[what]) - want).abs().max())
        require(e <= 1e-6, f"sharded_outcome_probs, {what} wiring on 4 "
                           f"shards ({len(probs[what])} parts) == "
                           f"planes.simulate_probs within 1e-6 ({e:.2e})")

    # times, outside the window
    ops28 = planes.fuse_ops(c28)
    times = dict(
        single_ms=cuda_ms(lambda: planes.run_ops(ops28, c28.num_qubits,
                                                 dev), reps=5),
        shards1_ms=cuda_ms(lambda: sharded.run_statevector_sharded(
            c28, mesh1), reps=5),
        shards4_ms=cuda_ms(lambda: sharded.run_statevector_sharded(
            c28, mesh4), reps=5))
    local28 = s28[4][0][0].numel().bit_length() - 1
    ex = exchange_ms(mesh4, *s28[4], 0, local28 - 6, local28)
    del s28
    torch.cuda.empty_cache()
    # the mesh of one beside the plane engine at width 24, where a call's
    # passes take ~0.2 ms: ten calls of each traced, the idle share shows
    # the host work between them
    c24 = compile_qcmrf(chain_model(12, dev), with_measurements=False)
    ops24 = planes.fuse_ops(c24)

    def calls(fn):
        def run():
            for _ in range(10):
                out = fn()
            torch.cuda.synchronize()
            return out
        return run

    times["qcmrf24_single_ms"] = cuda_ms(
        lambda: planes.run_ops(ops24, c24.num_qubits, dev), reps=10)
    times["qcmrf24_shards1_ms"] = cuda_ms(
        lambda: sharded.run_statevector_sharded(c24, mesh1), reps=10)
    # the same plan run without the entry point's cache key and lookup
    plan24 = sharded._plan_fused(c24, c24.num_qubits, 0)[0]
    sym24 = [sharded._has_sym(item) for item in plan24]
    times["qcmrf24_shards1_plan_run_ms"] = cuda_ms(
        lambda: sharded._run_plan("fused", plan24, sym24, c24, mesh1),
        reps=10)
    profiled("qcmrf24 plane engine, 10 calls", report, calls(
        lambda: planes.run_ops(ops24, c24.num_qubits, dev)))
    profiled("qcmrf24 sharded engine, mesh of one, 10 calls", report, calls(
        lambda: sharded.run_statevector_sharded(c24, mesh1)))
    print(f"  qcmrf28: single card {times['single_ms']:.3f} ms, one shard "
          f"{times['shards1_ms']:.3f} ms, four shards of the card "
          f"{times['shards4_ms']:.3f} ms ({remaps['qcmrf28 x4']} exchanges);"
          f" qcmrf24: single card {times['qcmrf24_single_ms']:.3f} ms, one "
          f"shard {times['qcmrf24_shards1_ms']:.3f} ms (its cached plan "
          f"run alone {times['qcmrf24_shards1_plan_run_ms']:.3f} ms);"
          f" one exchange on 4 shards {ex['ms']:.3f} ms (bound "
          f"{ex['bound_ms']:.3f} ms, {ex['bound_by']}); qcmrf32 single card "
          f"{one32 * 1e3:.1f} ms, 4 shards {s32_first * 1e3:.1f} ms with "
          f"the planner (host clock), its planner alone {plan32_s:.3f} s, "
          f"its cached call {s32_ms:.3f} ms")

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dr = dryrun.dryrun_multichip(mesh4)
    torch.cuda.synchronize()
    dr_s = time.perf_counter() - t0
    dr_launches = read_counts()
    print(f"  dryrun_multichip(Mesh((cuda:0,) * 4)): {dr_s:.2f} s, {dr}; "
          f"launches {dr_launches}")
    require(dr["outcome_max_abs_err"] <= 1e-5, "dry run: every part passed,"
                                               " the oracle within 1e-5")
    runs = example_runs(root)
    sc = json.loads(runs["scaling"]["last"])
    require(sc["lnZ_abs_err"] < 0.1 and sc["gate_level_norm_err"] < 1e-4,
            f"scaling --n 28 --devices 1 --gate-level: lnZ_abs_err "
            f"{sc['lnZ_abs_err']} < 0.1, gate_level_norm_err "
            f"{sc['gate_level_norm_err']:.2e} < 1e-4")
    report["gate_sharded"] = dict(
        launches=launches, remaps=remaps, window_s=window_s, peak_gib=peak,
        qcmrf32_first_s=s32_first, qcmrf32_single_s=one32,
        qcmrf32_plan_s=plan32_s, qcmrf32_cached_ms=s32_ms,
        sampled_max_abs_err=e32, times=times, exchange=ex,
        dryrun=dict(dr, seconds=dr_s, launches=dr_launches),
        runs={k: v["seconds"] for k, v in runs.items()}, scaling=sc,
        seconds=time.perf_counter() - t_phase)
    print(f"  gate sharded phase {report['gate_sharded']['seconds']:.1f} s")
    return launches, dr_launches


def finite_leaves(v) -> bool:
    if isinstance(v, dict):
        return all(finite_leaves(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(finite_leaves(x) for x in v)
    if isinstance(v, str):
        return True
    return isinstance(v, (int, float)) and math.isfinite(v)


#: the keys of ``python -m qcmrf_tpu_torch bench --json --trace``
BENCH_KEYS = ("n", "cliques", "backend", "power_limit",
              "sampler_shots_per_sec", "trace_dir", "trace", "logpot_ms",
              "logpot_write_gbps", "lnZ_ms", "gate_bw_n", "gate_lane_gbps",
              "gate_row_gbps", "suite70_gate_level_ms")


def phase_bench(dev, report) -> dict:
    """``python -m qcmrf_tpu_torch bench --json --trace <dir>`` in a
    subprocess and ``runners.bench.record()`` in this process, each
    printed as one JSON line: every key present and finite, record()'s
    key set equal to BENCH_r05.json's less the listed exclusions (and
    fma_peak_tflops in place of vpu_peak_tflops); the headline sampler
    call's device busy and idle share from the bench's trace."""
    from qcmrf_tpu_torch.runners import bench

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run(
            [sys.executable, "-m", "qcmrf_tpu_torch", "bench", "--json",
             "--trace", d], cwd=root, capture_output=True, text=True,
            timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"bench exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
    line = r.stdout.strip().splitlines()[-1]
    cmd = json.loads(line)
    print(f"[bench] python -m qcmrf_tpu_torch bench --json --trace "
          f"({time.perf_counter() - t0:.1f} s):")
    print(line)
    require(set(cmd) == set(BENCH_KEYS) and finite_leaves(cmd)
            and cmd["trace"]["kernels"] > 0,
            "bench: JAX's bench keys (with trace_dir, trace and the power "
            "limit), every one finite; the trace holds the sampler's "
            "kernels")
    report.setdefault("busy", {})["sampler headline (bench --trace)"] = \
        cmd["trace"]
    print(f"  [profile] the headline sampler call (bench --trace): busy "
          f"{cmd['trace']['busy_ms']:.3f} ms of a "
          f"{cmd['trace']['window_ms']:.3f} ms window: idle share "
          f"{cmd['trace']['idle_share']:.4f}")
    t0 = time.perf_counter()
    rec = bench.record(dev)
    print(f"[bench] runners.bench.record() ({time.perf_counter() - t0:.1f} "
          "s):")
    print(json.dumps(rec))
    with open(os.path.join(root, "BENCH_r05.json")) as f:
        r05 = set(json.load(f)["parsed"])
    want = (r05 - set(bench.RECORD_LEFT_OUT)) | {"fma_peak_tflops"}
    require(set(rec) == want and finite_leaves(rec),
            f"record(): {len(rec)} keys, BENCH_r05's less "
            f"{len(r05 - want)} left out, with fma_peak_tflops; every one "
            "finite")
    for w in (24, 28):
        sh, one = (rec[f"qcmrf{w}_sharded_gate_level_ms"],
                   rec[f"qcmrf{w}_gate_level_ms"])
        print(f"  qcmrf{w}_sharded_gate_level_ms {sh} against "
              f"qcmrf{w}_gate_level_ms {one}: ratio {sh / one:.3f} (the "
              "root bench.py's bar: ~1.2x)")
    report["bench"] = dict(command=cmd, record=rec)
    return rec


def gate_entry(kind, report, launches) -> dict:
    """A generic gate kernel's line: its mean time and bound per launch in
    the lowered width-28 main run (the copy: at the rates' width 28; the
    dense lane kernel, which the main run no longer launches: at width
    28 on the 7-H wall), its plain version at width 24."""
    w24 = report["gate_w24"][kind]
    if kind == "lane":
        row = report["lane_w28"]
        return dict(launches=launches, **{k: v for k, v in row.items()
                                          if not k.endswith("turns")},
                    sass=report["lane_sass"], **w24)
    if kind == "copy":
        row = report["copy_w28"]
        return dict(launches=launches, ms=row["ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"],
                    shape=row["shape"], **w24)
    run = report["lowered"]["per_kernel"][kind]
    return dict(launches=launches, ms=run["ms"], bound_ms=run["bound_ms"],
                bound_by=run["bound_by"],
                library_ms=report.get(f"{kind}_library_ms"),
                shape=f"mean per launch over the {run['passes']} passes of "
                      f"the lowered width-{LOWERED_WIDTH} chain "
                      f"({run['total_ms']:.1f} ms in all)", **w24)


REPLACES = {
    "sampler": "qcmrf_tpu/ops/sampler_kernel.py:37",
    "logpot": "qcmrf_tpu/ops/kernels.py:239",
    "lse": "qcmrf_tpu/ops/kernels.py:514",
    "map": "qcmrf_tpu/ops/kernels.py:570",
    "moments": "qcmrf_tpu/ops/kernels.py:817",
    "lnz_moments": "qcmrf_tpu/ops/kernels.py:913",
    "hdh_multi": "qcmrf_tpu/ops/kernels.py:1895",
    "hdh_multi_uniform": "qcmrf_tpu/ops/kernels.py:1895",
    "circuit": "qcmrf_tpu/ops/circuit_kernel.py:108",
    "lane_factored": "qcmrf_tpu/ops/kernels.py:1046",
    "lane": "qcmrf_tpu/ops/kernels.py:1046",
    "row_gate": "qcmrf_tpu/ops/kernels.py:1128",
    "diag": "qcmrf_tpu/ops/kernels.py:1340",
    "copy": "qcmrf_tpu/runners/bench.py:177",
    "fma_peak": "bench.py:405",
    "gibbs": "qcmrf_tpu/models/sample.py:77 (sample_gibbs: a lax.scan, "
             "not a TPU kernel)",
    "gibbs_ais": "qcmrf_tpu/models/ais.py:57 (_ais_body, lax.scan; no "
                 "Pallas kernel)",
}
ALSO_REPLACES = {
    "logpot": ["qcmrf_tpu/ops/kernels.py:257 (the split loop kernel)"],
    "hdh_multi": ["qcmrf_tpu/ops/kernels.py:1477 (at k=1)",
                  "qcmrf_tpu/ops/kernels.py:1675 (at k=2)"],
    "row_gate": ["qcmrf_tpu/ops/kernels.py:1176 (at K=2)"],
    "diag": ["qcmrf_tpu/ops/kernels.py:1275 (at one term)"],
    "gibbs": ["qcmrf_tpu/models/sample.py:150 (sample_gibbs_bits: a "
              "lax.scan, not a TPU kernel)"],
}
SOURCES = {
    "sampler": "qcmrf_kernels.cu", "logpot": "qcmrf_kernels.cu",
    "lse": "qcmrf_kernels.cu", "map": "qcmrf_kernels.cu",
    "moments": "qcmrf_kernels.cu", "lnz_moments": "qcmrf_kernels.cu",
    "hdh_multi": "circuit_kernels.cu",
    "hdh_multi_uniform": "circuit_kernels.cu",
    "circuit": "circuit_kernels.cu",
    "lane_factored": "gate_kernels.cu", "lane": "gate_kernels.cu",
    "row_gate": "gate_kernels.cu",
    "diag": "gate_kernels.cu", "copy": "gate_kernels.cu",
    "fma_peak": "gate_kernels.cu", "gibbs": "gibbs_kernels.cu",
    "gibbs_ais": "gibbs_kernels.cu",
}


#: sandwich kernel -> (its passes in the width-32 chain, its width-24
#: cases whose plain versions are timed, its width-24 cases held against
#: their plain versions)
SANDWICH_PARTS = {
    "hdh_multi": (("sandwichk", "sandwich"), ("hdh_multi", "hdh_single"),
                  ("hdh_single", "hdh_pair", "hdh_multi")),
    "hdh_multi_uniform": (("sandwichku",), ("hdh_multi_uniform",),
                          ("hdh_multi_uniform",)),
}


def sandwich_entry(name, report) -> dict:
    """A sandwich kernel's line: the summed time and bound of its passes
    at the width-32 main path's shape; its plain version, held against
    it, at width 24 on the same k."""
    passes, timed, held = SANDWICH_PARTS[name]
    w32 = [report["pass_w32"][p] for p in passes]
    w24 = [report["sandwich_w24"][c] for c in timed]
    by = {e["bound_by"] for e in w32}
    return dict(
        max_abs_err=max(report["sandwich_w24"][c]["max_abs_err"]
                        for c in held),
        ms=sum(e["ms"] for e in w32),
        plain_ms=sum(e["plain_ms"] for e in w24),
        bound_ms=sum(e["bound_ms"] for e in w32),
        bound_by=by.pop() if len(by) == 1 else "bytes and operations",
        shape=f"its passes {list(passes)} of the width-32 chain (2^32 "
              "values), summed",
        plain_shape="; ".join(e["shape"] for e in w24),
        ms_at_plain_shape=sum(e["ms"] for e in w24),
        bound_ms_at_plain_shape=sum(e["bound_ms"] for e in w24))


KERNEL_NAMES = ("sampler_kernel", "logpot_kernel", "lse_kernel",
                "map_kernel", "lnz_moments_kernel",
                "hdh_multi_kernel", "hdh_multi_uniform_kernel",
                "circuit_kernel", "diag_kernel", "row_gate_kernel",
                "lane_kernel", "lane_factored_kernel", "copy_kernel",
                "fma_peak_kernel", "gibbs_kernel")


def print_ptxas(path) -> None:
    """Registers and spills of every kernel, from the build's ptxas
    report (a mangled name carries its length before it)."""
    name = None
    for line in (path.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in KERNEL_NAMES
                         if f"{len(k)}{k}" in line), None)
            g = re.search(r"gibbs_kernelILb([01])ELb([01])ELb([01])E",
                          line)
            m = re.search(r"ILi(\d+)E(?:Lb([01])E)?", line)
            if g:
                name += (f"<{('shared', 'word')[int(g.group(1))]} state, "
                         f"D in {('device', 'shared')[int(g.group(2))]} "
                         f"memory{('', ', AIS')[int(g.group(3))]}>")
            elif name and m:
                given = {"0": ", fused", "1": ", lnZ given"}
                name += f"<{m.group(1)}{given.get(m.group(2), '')}>"
        elif name and ("registers" in line or "spill" in line):
            print(f"  ptxas {name}: "
                  + line.replace("ptxas info    :", "").strip())


#: the script's start on the host clock
T_START = time.perf_counter()
#: (phase, seconds since the start) as each phase ends
CLOCK = []


def clock(phase: str) -> None:
    """Note and print the seconds since the start as ``phase`` ends."""
    CLOCK.append((phase, round(time.perf_counter() - T_START, 1)))
    print(f"[clock] {phase} done at {CLOCK[-1][1]:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    from qcmrf_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    path, build_s = _build.build()
    _build.library()
    root = os.path.dirname(os.path.abspath(__file__))
    print(f"[build] {path.relative_to(root)} in {build_s:.1f} s "
          f"({len(_build.sources())} sources in parallel)")
    print_ptxas(path)
    report = {}
    lane_sass = sass_counts(path, "lane_kernel")
    report["lane_sass"] = dict(
        instructions=sum(lane_sass.values()),
        tensor_core=sum(v for k, v in lane_sass.items()
                        if k.startswith(("HGMMA", "HMMA"))),
        by_opcode=dict(sorted(lane_sass.items(), key=lambda kv: -kv[1])[:8]))
    print(f"  SASS lane_kernel: {report['lane_sass']['instructions']} "
          f"instructions, {report['lane_sass']['tensor_core']} on the tensor "
          f"cores (HGMMA); by opcode {report['lane_sass']['by_opcode']}")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] torch: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)

    clock("build")
    phase_sampler(dev, report, path)
    clock("sampler")
    phase_logpot(dev, report)
    phase_lnz(dev, report)
    clock("logpot, lnZ")
    phase_offset(dev, report)
    clock("offset")
    phase_suite_shapes(dev)
    launches = phase_main_path(dev, "analytic", {
        "sampler": None, "logpot": None, "lse": None})
    phase_circuit_kernel(dev, report)
    sv = phase_main_path(dev, "statevector", {
        "circuit": 1, "logpot": None, "lse": None})
    clock("main paths, circuit kernel")
    # the table kernel's paths: both run engines, and below the train
    # CLI's own data draw and sample_exact's K27 table (phase_train)
    report["logpot"]["launches_by_path"] = {
        "run analytic": launches["logpot"], "run statevector": sv["logpot"]}
    infer = phase_infer(dev, report)
    clock("infer")
    train = phase_train(dev, report)
    clock("train")
    smp = phase_samplers(dev, report)
    clock("samplers")
    ais_path = phase_ais(dev, report)
    clock("ais")
    noise = phase_noise(dev, report)
    clock("noise")
    # the sharded path: every sweep, shot path and CLI of slice 6a
    shard = phase_sharded(dev, report)
    for k in ("logpot", "lse", "map", "moments", "lnz_moments", "sampler",
              "gibbs_ais"):
        require(shard[k] > 0, f"kernel {k} launched {shard[k]} times on the "
                              "sharded path")
    clock("sharded")
    phase_sandwich_kernels(dev, report)
    phase_gate_level(dev, report)
    gate = report["main_gate_level"]
    clock("sandwich kernels, gate level")
    gs, dr = phase_gate_sharded(dev, report)
    clock("gate sharded")
    phase_gate_kernels(dev, report)
    clock("gate kernels")
    lowered = phase_lowered_chain(dev, report)
    phase_small_circuits(dev)
    clock("lowered chain, small circuits")
    rates = phase_rates(dev, report)
    clock("rates")
    phase_bench(dev, report)
    clock("bench")

    kernels_line = []
    report["logpot"]["launches_by_path"]["samplers"] = smp["logpot"]
    # the noise path: run --engine calibrated:torino -> eval
    cal = noise["calibrated:torino"]["launches"]
    report["logpot"]["launches_by_path"]["noise"] = cal["logpot"]
    report["logpot"]["launches_by_path"]["sharded"] = shard["logpot"]
    report["logpot"]["launches_by_path"]["dryrun"] = dr["logpot"]
    report["lse"]["launches_by_path"] = {"run analytic": launches["lse"],
                                         "noise": cal["lse"],
                                         "sharded": shard["lse"],
                                         "dryrun": dr["lse"]}
    launches["logpot"] = sum(report["logpot"]["launches_by_path"].values())
    launches["lse"] = sum(report["lse"]["launches_by_path"].values())
    for k, by in (("sampler", {"run analytic": launches["sampler"]}),
                  ("map", {"infer K27": infer["map"]}),
                  ("lnz_moments", {"train K27": train["lnz_moments"]})):
        by["samplers"] = smp[k]
        by["sharded"] = shard[k]
        by["dryrun"] = dr[k]
        report[k]["launches_by_path"] = by
    report["moments"]["launches_by_path"] = {
        "infer K27": infer["moments"], "sharded": shard["moments"],
        "dryrun": dr["moments"]}
    infer["moments"] = sum(report["moments"]["launches_by_path"].values())
    launches["sampler"] = sum(report["sampler"]["launches_by_path"].values())
    infer["map"] = sum(report["map"]["launches_by_path"].values())
    train["lnz_moments"] = sum(
        report["lnz_moments"]["launches_by_path"].values())
    for k in ("sampler", "logpot", "lse"):
        kernels_line.append(dict(launches=launches[k], library_ms=None,
                                 **report[k]))
    for k in ("hdh_multi", "hdh_multi_uniform"):
        kernels_line.append(dict(launches=gate[k] + gs[k], library_ms=None,
                                 launches_by_path={"width-32 chain": gate[k],
                                                   "gate sharded": gs[k]},
                                 **sandwich_entry(k, report)))
    kernels_line.append(dict(launches=sv["circuit"], library_ms=None,
                             **report["circuit"]))
    for k in ("map", "moments"):
        kernels_line.append(dict(launches=infer[k], library_ms=None,
                                 **report[k]))
    # no single PyTorch call computes the fused sweep or the FMA chain
    kernels_line.append(dict(launches=train["lnz_moments"], library_ms=None,
                             **report["lnz_moments"]))
    for k in ("lane_factored", "lane", "row_gate", "diag"):
        kernels_line.append(gate_entry(k, report, lowered[k] + gs[k]))
        kernels_line[-1]["launches_by_path"] = {
            "lowered chain": lowered[k], "gate sharded": gs[k]}
    kernels_line.append(gate_entry("copy", report, rates["copy"]))
    kernels_line.append(dict(launches=rates["fma_peak"], library_ms=None,
                             **report["fma_peak"]))
    # the chain has no TPU kernel and no one PyTorch call
    kernels_line.append(dict(launches=smp["gibbs"], library_ms=None,
                             **report["gibbs"]))
    # the AIS mode: no TPU kernel and no one PyTorch call either
    kernels_line.append(dict(launches=ais_path["gibbs_ais"]
                             + shard["gibbs_ais"] + dr["gibbs_ais"],
                             library_ms=None, **report["gibbs_ais"]))
    for k, entry in zip(("sampler", "logpot", "lse", "hdh_multi",
                         "hdh_multi_uniform", "circuit", "map", "moments",
                         "lnz_moments", "lane_factored", "lane", "row_gate",
                         "diag", "copy",
                         "fma_peak", "gibbs", "gibbs_ais"), kernels_line):
        entry.update(name=k, route="cuda",
                     source=f"qcmrf_tpu_torch/csrc/{SOURCES[k]}",
                     replaces=REPLACES[k])
        if k in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[k]
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels_line, **{
            k: v for k, v in report.items()
            if k in ("gate_level", "gate_plain_width", "sandwich_w24",
                     "pass_w32", "infer_k27_batch_s",
                     "infer_k27_query_s", "gate_w24", "lowered", "rates",
                     "copy_w28", "lane_w28", "lane_library_ms",
                     "lane_float64", "lane_sass",
                     "lane_factored_library_ms", "row_gate_library_ms",
                     "row_library_by_qubit", "train", "fma_peak",
                     "samplers", "gibbs", "ais", "gibbs_ais", "noise",
                     "offset", "sharded", "gate_sharded", "bench",
                     "busy")}, clock=CLOCK),
                  f, indent=1, default=str)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
