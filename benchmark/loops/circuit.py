"""Gate-level QCMRF circuits, one parameter draw a call.

Every call draws a new theta (``-|N(0,1)|`` at the configuration's scales
in turn), compiles the model's QCMRF circuit (``circuits.compile_qcmrf``:
unmeasured, as the root bench.py's gate-level record, so that the outcomes
are the basis states of every qubit, unless the mix's ``measurements``
asks for every qubit but the workspace measured), where the mix names a
``lowering`` (``"fused"`` or ``"literal"``) lowers it to the hardware basis
``[cx, id, rz, sx, x]`` (``circuits.lower.lower``, inside the timed call),
and runs it on the plane engine (``sim.planes.simulate_probs``): all
``2**(n + K + 1)`` outcome probabilities. The benchmark's own code keeps
the post-selected ones (workspace and every ancilla 0: the first ``2**n``
keys) and reads their sum, delta, to the host, which ends the call.

Correct: for a seeded sample of the calls, the post-selected probabilities
and delta against the reference's P(x, every ancilla 0) = 2**-n exp(beta
theta^T phi(x)), the law the circuit is built to give.
"""

from __future__ import annotations

import torch

from benchmark import harness, inputs


class Loop:
    def __init__(self, config, mix, seed, device, spans):
        from qcmrf_tpu_torch.circuits.compiler import compile_qcmrf
        from qcmrf_tpu_torch.models.mrf import MRF
        from qcmrf_tpu_torch.sim import planes

        self.config, self.mix, self.device, self.spans = (
            config, mix, device, spans)
        self.ref = harness.load_module("reference", config["reference"])
        self.cliques = inputs.cliques(config)
        self.n = int(config["n"])
        self.width = self.n + len(self.cliques) + 1
        self.beta = float(config.get("beta", 1.0))
        self.d = inputs.dimension(self.cliques)
        self.scales = config["theta_scales"]
        self.gen = inputs.generator(seed, "theta", device)
        self.keep = harness.reservoir(int(mix["checked_calls"]),
                                      inputs.rng(seed, "order"))
        template = MRF.create(self.cliques, n=self.n, beta=self.beta,
                              device=device)
        measured = bool(mix["measurements"])
        lowering = mix.get("lowering")

        if lowering is None:
            def system(theta):
                circuit = compile_qcmrf(template.with_theta(theta),
                                        with_measurements=measured)
                return planes.simulate_probs(circuit, device)
        else:
            from qcmrf_tpu_torch.circuits.lower import lower

            def system(theta):
                circuit = compile_qcmrf(template.with_theta(theta),
                                        with_measurements=measured)
                return planes.simulate_probs(
                    lower(circuit, style=lowering), device)

        #: the program under test: theta -> outcome probabilities
        self.system = system
        self.kept = {}

    def _call(self, i: int):
        with self.spans("bench.call"):
            scale = self.scales[i % len(self.scales)]
            theta = inputs.neg_half_normal(self.d, scale, self.gen,
                                           self.device)
            probs = self.system(theta)
            with self.spans("bench.reduce"):
                post = probs[:1 << self.n].clone()
                del probs
                delta = float(post.sum(dtype=torch.float64))
        return theta, post, delta

    def warm_up(self):
        for i in range(2):
            self._call(i)

    def window(self, seconds):
        def done(j, out):
            slot = self.keep(j)
            if slot is not None:
                self.kept[slot] = out

        return harness.closed_loop(seconds, self._call, done,
                                   work={"width": self.width})

    def release(self):
        self.system = None

    def checks(self):
        post_rel = delta_rel = 0.0
        for theta, post, delta in self.kept.values():
            model = self.ref.PairwiseMRF(self.cliques, theta.double(),
                                         self.n, self.beta)
            q, d = model.postselected(model.table())
            post_rel = max(post_rel, float((post.double() - q).abs().max()
                                           / q.max()))
            delta_rel = max(delta_rel, abs(delta - d) / d)
        lim = self.mix["limits"]
        return [harness.Check("post_rel", post_rel, lim["post_rel"]),
                harness.Check("delta_rel", delta_rel, lim["delta_rel"])]


def control(loop):
    """The reference's post-selected law, in the control's precision, in
    the program's place."""
    from benchmark.control import CONTROL_DTYPE

    ref = loop.ref

    def system(theta):
        model = ref.PairwiseMRF(loop.cliques, theta, loop.n,
                                loop.beta, CONTROL_DTYPE)
        return model.postselected(model.table())[0].float()

    return system


def altered(loop):
    """One outcome's probability altered where it is produced."""
    inner = loop.system

    def system(theta):
        probs = inner(theta).clone()
        probs[0] *= 1.001
        return probs

    return system


#: the timed path broken underneath, each way this loop's cells can break
FAULTS = {"altered": altered}
