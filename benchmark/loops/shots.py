"""Outcome shots of a model's QCMRF circuit, one parameter draw a call.

Every call draws a new theta (``-|N(0,1)|`` at the configuration's scales
in turn) and samples ``shots_per_call`` outcomes with the program's
analytic sampler (``sim.analytic.sample_outcome_parts``, Philox key the
run's and stream the call's index). The benchmark's own code reduces the
outcomes on the device to the histogram of (x, accepted): the accepted
shots' states in the first ``2**n`` bins, the rejected ones' in the next
``2**n`` (one bin for every rejected shot would put most of the shots'
atomic adds on one address), and reads it to the host, which ends the
call.

Correct: for a seeded sample of the calls, the accepted count against the
reference's delta = Z / 2**n (a binomial z score) and the histogram
against the reference's P(x, every ancilla 0) and P(x, some ancilla 1) =
2**-n - P(x, every ancilla 0) (Pearson's chi-square as a z score, each
bin's variance Poisson's).
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
                hist = hist.cpu().numpy()
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
        count_z = hist_z = 0.0
        N = self.shots
        for theta, hist in self.kept.values():
            model = self.ref.PairwiseMRF(self.cliques, theta.double(),
                                         self.n, self.beta)
            q, delta = model.postselected(model.table())
            count = int(hist[:1 << self.n].sum())
            count_z = max(count_z, abs(count - N * delta)
                          / math.sqrt(N * delta * (1 - delta)))
            q = q.cpu().numpy()
            law = np.append(q, 2.0 ** -self.n - q)
            hist_z = max(hist_z, chi_square_z(hist, N, law))
        lim = self.mix["limits"]
        return [harness.Check("count_z", count_z, lim["count_z"]),
                harness.Check("hist_z", hist_z, lim["hist_z"])]


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
