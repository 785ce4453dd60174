"""Outcome shots of a model's QCMRF circuit, one parameter draw a call.

Every call draws a new theta (``-|N(0,1)|`` at the configuration's scales
in turn) and samples ``shots_per_call`` outcomes with the program's
analytic sampler (``sim.analytic.sample_outcome_parts``, Philox key the
run's and stream the call's index). The benchmark's own code reduces the
outcomes on the device to the histogram of (x, accepted): the accepted
shots' states in the first ``2**n`` bins, the rejected ones' in the next
``2**n`` (one bin for every rejected shot would put most of the shots'
atomic adds on one address), and reads it into one page-locked host
buffer made in set-up, which ends the call. As every call reuses that
buffer, a call kept for the comparison keeps its device histogram, which
the copy left equal to it.

Correct: for a seeded sample of the calls, against the reference's
P(x, every ancilla 0) = q(x) and delta = Z / 2**n = sum q: the accepted
count against N delta (a binomial z score, ``count_z``); the histogram
against q(x) and P(x, some ancilla 1) = 2**-n - q(x) (Pearson's chi-square
as a z score, each bin's variance Poisson's, ``hist_z``); and, for each
clique C and each state s of its variables, the accepted shots with
x_C = s against N times q summed over those x (the largest binomial z
score, ``marg_z``). Where most states expect under a shot, the histogram
pools them and sees little of which states are accepted; each clique
state's count holds many shots, so ``marg_z`` sees that law at any n.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import harness, inputs


class Loop:
    def __init__(self, config, mix, seed, device, spans):
        from qcmrf_tpu_torch.models.mrf import MRF
        from qcmrf_tpu_torch.sim import analytic

        self.config, self.mix, self.device, self.spans = (
            config, mix, device, spans)
        self.ref = harness.load_module("reference", config["reference"])
        self.cliques = inputs.cliques(config)
        self.n = int(config["n"])
        self.beta = float(config.get("beta", 1.0))
        self.d = inputs.dimension(self.cliques)
        self.shots = int(mix["shots_per_call"])
        self.scales = config["theta_scales"]
        self.gen = inputs.generator(seed, "theta", device)
        self.key = inputs.seed_words(seed, "sample") & 0xFFFFFFFF
        self.keep = harness.reservoir(int(mix["checked_calls"]),
                                      inputs.rng(seed, "order"))
        template = MRF.create(self.cliques, n=self.n, beta=self.beta,
                              device=device)
        self.host = torch.empty(2 << self.n, dtype=torch.int64,
                                pin_memory=device.type == "cuda")

        def system(key, stream, theta):
            return analytic.sample_outcome_parts(
                key, template.with_theta(theta), self.shots, stream)

        #: the program under test: (Philox key, stream, theta) -> (x, mask)
        self.system = system
        self.kept = {}

    def _call(self, i: int):
        with self.spans("bench.call"):
            scale = self.scales[i % len(self.scales)]
            theta = inputs.neg_half_normal(self.d, scale, self.gen,
                                           self.device)
            x, a = self.system(self.key, i, theta)
            with self.spans("bench.reduce"):
                key = x + (a != 0).to(torch.int32) * (1 << self.n)
                hist = torch.bincount(key, minlength=2 << self.n)
                self.host.copy_(hist)
        return theta, hist

    def warm_up(self):
        # two calls on a stream the window never uses
        for i in range(2):
            self._call(-1 - i)

    def window(self, seconds):
        def done(j, out):
            slot = self.keep(j)
            if slot is not None:
                self.kept[slot] = out

        window = harness.closed_loop(seconds, self._call, done,
                                     work={"cliques": self.cliques,
                                           "n": self.n})
        window.work["shots"] = window.units * self.shots
        return window

    def release(self):
        self.system = None

    def checks(self):
        count_z = hist_z = marg_z = 0.0
        N = self.shots
        for theta, hist in self.kept.values():
            model = self.ref.PairwiseMRF(self.cliques, theta.double(),
                                         self.n, self.beta)
            q, delta = model.postselected(model.table())
            accepted = hist[:1 << self.n]
            count = int(accepted.sum())
            count_z = max(count_z, abs(count - N * delta)
                          / math.sqrt(N * delta * (1 - delta)))
            p = self.clique_states(q)
            seen = self.clique_states(accepted.to(q.device, q.dtype))
            marg_z = max(marg_z, float(((seen - N * p).abs()
                                        / torch.sqrt(N * p * (1 - p))).max()))
            q = q.cpu().numpy()
            law = np.append(q, 2.0 ** -self.n - q)
            hist_z = max(hist_z, chi_square_z(hist.cpu().numpy(), N, law))
        lim = self.mix["limits"]
        return [harness.Check("count_z", count_z, lim["count_z"]),
                harness.Check("hist_z", hist_z, lim["hist_z"]),
                harness.Check("marg_z", marg_z, lim["marg_z"])]

    def clique_states(self, weights: torch.Tensor) -> torch.Tensor:
        """``weights`` (one a state id, variable 0 its most significant
        bit) summed over the states x with x_C = s, for each clique C and
        each s in turn (the variables' bits in the clique's order)."""
        ids = torch.arange(1 << self.n, device=weights.device)
        out = []
        for C in self.cliques:
            s = torch.zeros_like(ids)
            for v in C:
                s = 2 * s + ((ids >> (self.n - 1 - v)) & 1)
            out.append(torch.bincount(s, weights=weights,
                                      minlength=1 << len(C)))
        return torch.cat(out)


def control(loop):
    """The reference in the program's place, in the control's precision:
    draw x uniformly and keep it with the acceptance probability prod_k
    exp(beta theta_k) evaluated in that precision."""
    from benchmark.control import CONTROL_DTYPE

    ref = loop.ref
    gen = torch.Generator(device=loop.device).manual_seed(20260)

    def system(key, stream, theta):
        model = ref.PairwiseMRF(loop.cliques, theta, loop.n,
                                loop.beta, CONTROL_DTYPE)
        keep = torch.exp(model.table()).float()
        x = torch.randint(0, 1 << loop.n, (loop.shots,), generator=gen,
                          device=loop.device, dtype=torch.int32)
        u = torch.rand(loop.shots, generator=gen, device=loop.device)
        return x, (u >= keep[x.long()]).to(torch.int32)

    return system


def half_batch(loop):
    """Half of the outcomes left out."""
    inner = loop.system
    return lambda key, stream, theta: tuple(
        t[:t.shape[0] // 2] for t in inner(key, stream, theta))


def altered(loop):
    """The state of an accepted shot altered where it is produced: the
    first 1/16 of them set to 0, the accepted count kept."""
    inner = loop.system

    def system(key, stream, theta):
        x, a = inner(key, stream, theta)
        hit = torch.nonzero(a == 0).flatten()
        x = x.clone()
        x[hit[: hit.numel() // 16]] = 0
        return x, a

    return system


#: the timed path broken underneath, each way this loop's cells can break
FAULTS = {"half_batch": half_batch, "altered": altered}


def chi_square_z(hist, shots, law) -> float:
    """Pearson's chi-square of the counts ``hist`` against ``shots`` draws
    of ``law``, as a z score: (chi2 - bins + 1) over the square root of
    the sum of each bin's Poisson variance 2 + 1 / E. Bins expecting fewer
    than 5 are pooled into one."""
    expect = shots * np.asarray(law, np.float64)
    seen = hist.astype(np.float64)
    small = expect < 5
    if small.any():
        expect = np.append(expect[~small], expect[small].sum())
        seen = np.append(seen[~small], seen[small].sum())
    chi2 = float((((seen - expect) ** 2) / expect).sum())
    return (chi2 - (len(expect) - 1)) / math.sqrt(float((2 + 1 / expect)
                                                        .sum()))
