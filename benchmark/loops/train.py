"""Exact-MLE training steps, the route of the program's ``train`` CLI at
n <= 30: ``models.train.make_train_step`` under Adam, theta = -softplus(raw).

Set-up draws the true theta from the configuration's law and, with the
reference's exact law of that model, ``samples`` distinct state ids (the
data: every row differs); it draws the start theta, ``-|N(0,1)| *
start_scale`` (again, from the same stream, while the reference's first
gradient has an entry within ``start_gradient_floor`` of zero), builds
the one training step with its model and Adam state, and drives it
through its first ``reference_steps`` steps on the data, reading each
step's loss, the first gradient from Adam's first moment (``exp_avg /
(1 - beta1)``) and ``raw`` after the last. The window then runs the
same step on the same data in rounds of ``steps_per_read`` steps, reading
the last loss of each round to the host, with ``raw`` as that last step
took it.

Correct: those first steps against the reference's steps from the same
start on the same data: each step's loss (relative gap), and by the worst
clique's block of ``raw`` (its leaves) the gap between the norms of the
first gradient and of the change of ``raw`` over the steps; and the
window's last loss read against the reference's loss at the same ``raw``.
"""

from __future__ import annotations

import torch

from benchmark import harness, inputs


class Loop:
    def __init__(self, config, mix, seed, device, spans):
        from qcmrf_tpu_torch.models import train
        from qcmrf_tpu_torch.models.mrf import MRF

        self.config, self.mix, self.device, self.spans = (
            config, mix, device, spans)
        self.ref = harness.load_module("reference", config["reference"])
        self.cliques = inputs.cliques(config)
        self.n = int(config["n"])
        self.beta = float(config.get("beta", 1.0))
        d = inputs.dimension(self.cliques)
        true = self.ref.PairwiseMRF(
            self.cliques, inputs.neg_half_normal(
                d, config["theta_scales"][0],
                inputs.generator(seed, "theta", device), device).double(),
            self.n, self.beta)
        table = true.table()
        self.data = self.ref.sample_ids(
            table - torch.logsumexp(table, 0), int(mix["samples"]),
            inputs.generator(seed, "data", device))
        del table, true
        self.lr = float(mix["learning_rate"])
        self.theta0, self.start_draws = self._start(d, seed)
        template = MRF.create(self.cliques, n=self.n, beta=self.beta,
                              device=device)
        self.raw = train._from_theta(self.theta0, True).requires_grad_()
        self.raw0 = self.raw.detach().clone()
        self.optimizer = train.adam([self.raw], self.lr)
        #: the program under test: batch of state ids -> loss (on device)
        self.system = train.make_train_step(template, self.optimizer)
        self.losses = []
        #: (raw, the program's loss at it) of the window's last read
        self.last = None

    def _start(self, d, seed):
        """The start theta, drawn again from the same stream while an entry
        of the reference's first gradient (float64) lies within
        ``start_gradient_floor`` of zero: Adam's first step on an entry is
        lr * g / (|g| + 1e-8), a step of the sign of g, and where |g| is
        within float32's rounding of the sweep (a few 1e-7) that sign, and
        every later step with it, is rounding's, on either side."""
        gen = inputs.generator(seed, "start", self.device)
        floor = float(self.mix["start_gradient_floor"])
        for draw in range(1, 65):
            theta0 = inputs.neg_half_normal(
                d, float(self.mix["start_scale"]), gen, self.device)
            g1 = self.ref.train_reference(
                self.cliques, self.n, self.beta, theta0.double(), self.data,
                1, self.lr)["grad1"]
            if float(g1.abs().min()) >= floor:
                return theta0, draw
        raise RuntimeError(f"no start of 64 draws has every first-gradient "
                           f"entry at {floor:g} or more")

    def warm_up(self):
        # the first steps, read for the comparison; the first imports
        # what torch.optim's step needs
        for t in range(int(self.mix["reference_steps"])):
            with self.spans("bench.step"):
                self.losses.append(float(self.system(self.data)))
            if t == 0:
                state = self.optimizer.state[self.raw]
                self.grad1 = (state["exp_avg"] / (1 - 0.9)).detach().clone()
        self.raw_k = self.raw.detach().clone()

    def _round(self, i):
        per = int(self.mix["steps_per_read"])
        for s in range(per):
            if s == per - 1:
                raw = self.raw.detach().clone()
            with self.spans("bench.step"):
                loss = self.system(self.data)
        return raw, float(loss)

    def window(self, seconds):
        def done(j, out):
            self.last = out

        return harness.closed_loop(
            seconds, self._round, done,
            per_call=int(self.mix["steps_per_read"]),
            work={"cliques": self.cliques, "n": self.n})

    def release(self):
        self.system = self.optimizer = None

    def checks(self):
        k = int(self.mix["reference_steps"])
        ref = self.ref.train_reference(self.cliques, self.n, self.beta,
                                       self.theta0.double(), self.data, k,
                                       self.lr)
        loss_rel = max(abs(p - r) / abs(r)
                       for p, r in zip(self.losses, ref["losses"]))
        sizes = [1 << len(C) for C in self.cliques]
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone under Adam
        norms = torch.stack([g.norm() for g in
                             torch.split(ref["grad1"], sizes)])
        skip = norms < 1e-3 * norms.median()
        grad_gap = self.ref.leaf_norm_gap(self.grad1, ref["grad1"], sizes,
                                          skip)
        change_gap = self.ref.leaf_norm_gap(
            self.raw_k - self.raw0, ref["raw"] - ref["raw0"], sizes, skip)
        raw, loss = self.last
        want = self.ref.nll(self.cliques, self.n, self.beta, raw, self.data)
        final_loss_rel = abs(loss - want) / abs(want)
        lim = self.mix["limits"]
        return [harness.Check("loss_rel", loss_rel, lim["loss_rel"]),
                harness.Check("final_loss_rel", final_loss_rel,
                              lim["final_loss_rel"]),
                harness.Check("grad_gap", grad_gap, lim["grad_gap"]),
                harness.Check("change_gap", change_gap, lim["change_gap"])]


def control(loop):
    """Read the reference's own first steps in the control's precision in
    place of the program's, and its loss in that precision where they end
    in place of the window's last: returns ``None`` (no system to
    time)."""
    from benchmark.control import CONTROL_DTYPE

    k = int(loop.mix["reference_steps"])
    ref = loop.ref.train_reference(
        loop.cliques, loop.n, loop.beta, loop.theta0, loop.data,
        k, loop.lr, dtype=CONTROL_DTYPE)
    loop.losses = ref["losses"]
    loop.grad1 = ref["grad1"].float()
    loop.raw0 = ref["raw0"].float()
    loop.raw_k = ref["raw"].float()
    loop.last = (ref["raw"], loop.ref.nll(loop.cliques, loop.n, loop.beta,
                                          ref["raw"], loop.data,
                                          CONTROL_DTYPE))
    return None


def half_batch(loop):
    """Half of the data rows left out, the mean taken over the rest."""
    inner = loop.system
    return lambda batch: inner(batch[:batch.shape[0] // 2])


def altered(loop):
    """Each step's loss altered where it is produced."""
    inner = loop.system
    return lambda batch: inner(batch) * 1.001


def unchanged(loop):
    """A training step that returns its loss and leaves the parameters as
    they were."""
    step, raw = loop.system, loop.raw

    def system(batch):
        before = raw.detach().clone()
        loss = step(batch)
        with torch.no_grad():
            raw.copy_(before)
        return loss

    return system


#: the timed path broken underneath, each way this loop's cells can break
FAULTS = {"half_batch": half_batch, "altered": altered,
          "unchanged": unchanged}
