"""Gate-level statevector engine on real/imaginary float32 planes (port of
:mod:`qcmrf_tpu.sim.tpu`).

Amplitudes live as two float32 planes of ``2**Q`` values, shaped ``(2**Q
/ 128, 128)`` like the JAX package's; qubit 0 is the least significant bit
of the flat index. A circuit runs as a stream of fused passes:

* **planner** (plain Python, the same op stream as the JAX package's on
  every circuit): :func:`circuit_primitives` lowers the gates with X gates
  deferred, :func:`fuse_primitives` fuses runs into ``diag`` / ``lane`` /
  ``rowq`` / ``row2`` / ``sandwich`` / ``sandwichk`` passes, and
  :func:`plan_stream` folds the leading Hadamard wall into a closed-form
  ``init_uniform`` or into a write-only first sandwich group
  (``sandwichku``). :func:`fuse_ops` keeps the stream per gate skeleton
  and, for a circuit of a kept skeleton, recomputes only its angles;
* **executor** :func:`run_ops` (and :func:`simulate_probs`) first lets a
  leading ``sandwichku`` absorb the sandwich groups after it whose
  ancillas are still |0> (:func:`fold_fresh`: one write-only pass over
  up to 16 ancillas), then :func:`apply_ops` runs the stream as given:
  ``init_uniform`` is plain PyTorch; every other pass goes to a CUDA
  kernel of :mod:`qcmrf_tpu_torch.ops.kernels` (its plain version on the
  CPU), updating the planes in place: the sandwich passes, ``diag`` (the
  diagonal profile), ``lane`` (qubits 0-6: one butterfly a value a factor
  for the planner's ops, which carry their factors; the dense 128x128
  product for a bare ``('lane', M)``), ``rowq`` and ``row2`` (the row
  gates);
* :func:`simulate_probs` runs a stream's last sandwich pass in its
  probability form, which stores ``|amplitude|^2`` in place of the
  amplitudes: the write-only pass where it absorbed the whole stream, else
  the last read-write pass; a stream that ends in any other pass ends with
  ``re * re + im * im`` (:func:`outcome_probs`).

:func:`apply_gate` is the unfused path, one gate at a time (``cx`` as
``H_t · cp(pi) · H_t``, every diagonal gate a masked rotation): the oracle
of the fused stream.

A QCMRF circuit whose ancillas all sit at qubit 7 or above (``n >= 6``)
fuses into sandwich passes only: at 32 qubits, one write-only and two
read-write passes, which run as one write-only pass (its 15 ancillas all
fresh) over 32 GiB of planes, or 16 GiB of probabilities. A lowered
circuit (the ``[cx, id, rz, sx, x]`` basis) runs through all five kinds of
pass. Requires ``Q >= 7``; measurements are deferred as in the dense
engine.
"""

from __future__ import annotations

import collections
import math
from typing import Tuple

import numpy as np
import torch

from qcmrf_tpu_torch.circuits.ir import Circuit, Gate
from qcmrf_tpu_torch.ops import kernels as K
from qcmrf_tpu_torch.sim.dense import GATES_1Q
from qcmrf_tpu_torch.utils import profiling
from qcmrf_tpu_torch.utils.config import resolve_device


def zero_planes(num_qubits: int,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planes of ``|0...0>`` on ``device`` (the current CUDA device unless
    one is named)."""
    shape = K.plane_shape(num_qubits)
    re = torch.zeros(shape, dtype=torch.float32,
                     device=resolve_device(device))
    re.view(-1)[0] = 1.0
    return re, torch.zeros_like(re)


#: the diagonal gates: their first parameter is the one a fused stream takes
_PARAM_GATES = ("rz", "cp", "flags_phase")


def _diag_conds_and_angles(g: Gate):
    """(conds, base, masked) for a diagonal gate."""
    if g.name == "rz":
        lam = g.params[0]
        return ((g.qubits[0], 1),), -lam / 2.0, lam
    if g.name == "cp":
        lam = g.params[0]
        c, t = g.qubits
        return ((c, 1), (t, 1)), 0.0, lam
    if g.name == "flags_phase":
        *pattern, ctrl = g.qubits
        conds = [(ctrl, 1)]
        for q, f in zip(pattern, g.flags):
            conds.append((q, (f + 1) // 2))
        return tuple(conds), 0.0, g.params[0]
    raise ValueError(f"not diagonal: {g.name}")


def apply_gate(re, im, g: Gate, num_qubits: int):
    """One gate on the planes, in place, without fusion; returns them."""
    if g.name in ("barrier", "measure", "id"):
        return re, im
    if g.name in ("h", "x", "sx", "sxdg"):
        return K.apply_1q(re, im, GATES_1Q[g.name], g.qubits[0], num_qubits)
    if g.name in _PARAM_GATES:
        conds, base, masked = _diag_conds_and_angles(g)
        return K.apply_masked_rotation(re, im, conds, base, masked)
    if g.name == "cx":
        c, t = g.qubits
        K.apply_1q(re, im, GATES_1Q["h"], t, num_qubits)
        K.apply_masked_rotation(re, im, ((c, 1), (t, 1)), 0.0, math.pi)
        return K.apply_1q(re, im, GATES_1Q["h"], t, num_qubits)
    raise ValueError(f"unsupported gate {g.name}")


_MAX_DIAG_TERMS = 64  # cap per fused diagonal pass


def _try_sandwich(h1, dg, h2):
    """Recognize [rowq H on a] [diag] [rowq H on a] and rewrite it as one
    ('sandwich', a, nu_terms, nu_angles, nu_base, mu_terms, mu_angles,
    mu_base) op (see kernels.apply_hdh_sandwich for the algebra). Returns
    None when the triple does not match (non-H matrices, lane-qubit
    ancilla a < 7, or a term conditioning on a twice)."""
    if h1[0] != "rowq" or h2[0] != "rowq" or dg[0] != "diag":
        return None
    _, U1, q1 = h1
    _, U2, q2 = h2
    if q1 != q2 or q1 < 7:
        return None
    H = np.asarray(GATES_1Q["h"], np.complex64)
    if not (np.allclose(U1, H, atol=1e-6)
            and np.allclose(U2, H, atol=1e-6)):
        return None
    _, terms, angles, base = dg
    mu = {}
    nu = {}

    def add(d, conds, val):
        d[conds] = d.get(conds, 0.0) + val

    for conds, t in zip(terms, angles):
        want_a = [w for p, w in conds if p == q1]
        if len(want_a) > 1:
            return None  # inconsistent / duplicated anc condition
        rest = tuple(sorted((p, w) for p, w in conds if p != q1))
        if not want_a:
            add(mu, rest, t)  # phases both anc branches equally
        else:
            add(mu, rest, t / 2.0)
            add(nu, rest, t / 2.0 if want_a[0] else -t / 2.0)

    mu_base = base + mu.pop((), 0.0)
    nu_base = nu.pop((), 0.0)
    mu = {k: v for k, v in mu.items() if abs(v) > 1e-12}
    nu = {k: v for k, v in nu.items() if abs(v) > 1e-12}
    return ("sandwich", q1, tuple(nu.keys()), tuple(nu.values()),
            nu_base, tuple(mu.keys()), tuple(mu.values()), mu_base)


def circuit_primitives(circuit: Circuit) -> list:
    """Lower the gate stream to ('1q', U, q) / ('diag', conds, base, angle)
    primitives with X gates DEFERRED (X·D·X is D with the bit condition
    flipped, so a clique's whole H·cU·X·cU†·X·H sandwich collapses to
    H · [one fused diagonal] · H); cx decomposes as H_t · cp(pi) · H_t so
    the sandwich post-pass of :func:`fuse_primitives` later collapses it
    to one pass too."""
    X = np.asarray(GATES_1Q["x"], np.complex64)
    flips = {}  # qubit -> pending deferred X (0/1)

    prim = []

    def push_1q(name, q):
        U = np.asarray(GATES_1Q[name], np.complex64)
        if name == "x":
            flips[q] = flips.get(q, 0) ^ 1
            return
        if flips.get(q):
            U = U @ X  # the deferred X acted first
            flips[q] = 0
        prim.append(("1q", U, q))

    def push_diag(conds, base, masked):
        conds = tuple(
            (pos, want ^ flips.get(pos, 0)) for pos, want in conds
        )
        prim.append(("diag", conds, base, masked))

    for g in circuit.gates:
        if g.name in ("barrier", "measure", "id"):
            continue
        if g.name == "cx":
            c, t = g.qubits
            push_1q("h", t)
            push_diag(((c, 1), (t, 1)), 0.0, math.pi)
            push_1q("h", t)
        elif g.name in ("h", "x", "sx", "sxdg"):
            push_1q(g.name, g.qubits[0])
        elif g.name in _PARAM_GATES:
            conds, base, masked = _diag_conds_and_angles(g)
            push_diag(conds, base, masked)
        else:
            raise ValueError(f"unsupported gate {g.name}")
    for q in sorted(flips):
        if flips[q]:
            flips[q] = 0
            prim.append(("1q", X, q))
    return prim


def fuse_primitives(prim: list) -> list:
    """Peephole fusion of a primitive stream into few full-plane passes.

    * a RUN of consecutive diagonal primitives (rz/cp/flags_phase, incl.
      the cp inside the cx decomposition) -> ONE ``('diag', terms, angles,
      base)`` pass;
    * consecutive non-diagonal 1q gates on LANE qubits (q < 7) compose
      into one 128x128 matrix -> ONE ``('lane', M, factors)`` pass: ``M``
      is composed as the JAX planner composes it, and ``factors`` (7, 2,
      2) holds each lane qubit's composed 2x2 (identity where no gate
      touched it), so that ``M = F6 ⊗ ... ⊗ F0``;
    * consecutive 1q gates on the SAME row qubit compose their 2x2s, and
      consecutive 1q gates on ADJACENT row qubits merge into one 4x4
      two-qubit ``row2`` pass;
    * H(a)·[diag]·H(a) triples collapse into ONE sandwich pass, and runs
      of adjacent-ancilla sandwiches into one ``sandwichk`` pass.

    Angles are handled generically (only +, unary -, /, and abs are
    used).
    """
    ops = []
    for p in prim:
        if p[0] == "diag":
            _, conds, base, a = p
            if (ops and ops[-1][0] == "diag"
                    and len(ops[-1][1]) < _MAX_DIAG_TERMS):
                _, terms, angles, b0 = ops[-1]
                ops[-1] = ("diag", terms + (conds,), angles + (a,),
                           b0 + base)
            else:
                ops.append(("diag", (conds,), (a,), base))
        else:
            _, U, q = p
            if q < 7:
                M = K._lane_gate_matrix(U, q)
                if ops and ops[-1][0] == "lane":
                    _, M_prev, factors = ops[-1]
                    factors[q] = U @ factors[q]
                    ops[-1] = ("lane", M @ M_prev, factors)
                else:
                    ops.append(("lane", M, K._one_factor(U, q)))
            else:
                if ops and ops[-1][0] == "rowq" and ops[-1][2] == q:
                    ops[-1] = ("rowq", U @ ops[-1][1], q)
                else:
                    ops.append(("rowq", U, q))

    # post-pass 1: collapse H(a)·[diag]·H(a) triples on a row qubit into
    # ONE sandwich pass: each clique's whole real-part-extraction block
    # becomes a single sweep over the planes (3 passes -> 1)
    fused = []
    i = 0
    while i < len(ops):
        s = (_try_sandwich(ops[i], ops[i + 1], ops[i + 2])
             if i + 2 < len(ops) else None)
        if s is not None:
            fused.append(s)
            i += 3
        else:
            fused.append(ops[i])
            i += 1
    ops = fused

    # post-pass 1b: group runs of consecutive-ancilla sandwiches into ONE
    # multi pass, up to kernels._MAX_SANDWICH_K ancillas per pass. QCMRF
    # emits one sandwich per clique on consecutive ancilla qubits and no
    # clique's profile mentions another clique's ancilla, so neighbours
    # commute and compose as a position-dependent Rx tensor power.
    grouped = []   # each group: [list of sandwich ops sorted by ancilla]
    out1b = []
    for op in ops:
        g = grouped[-1] if grouped else None
        if (op[0] == "sandwich" and g is not None
                and len(g) < K._MAX_SANDWICH_K
                and (op[1] == g[-1][1] + 1 or op[1] == g[0][1] - 1)
                and _sandwich_group_independent(g, op)):
            g.append(op) if op[1] == g[-1][1] + 1 else g.insert(0, op)
        elif op[0] == "sandwich":
            grouped.append([op])
            out1b.append(grouped[-1])
        else:
            grouped.append(None)
            out1b.append(op)
    ops = []
    for item in out1b:
        if not isinstance(item, list) or len(item) == 1:
            ops.append(item[0] if isinstance(item, list) else item)
            continue
        mt = sum((s[5] for s in item), ())
        ma = sum((tuple(s[6]) for s in item), ())
        mb = item[0][7]
        for s in item[1:]:
            mb = mb + s[7]
        ops.append(("sandwichk", item[0][1],
                    tuple(s[2] for s in item),
                    tuple(s[3] for s in item),
                    tuple(s[4] for s in item),
                    mt, ma, mb))

    # post-pass 2: merge 1q ops on ADJACENT row qubits into one 4x4 pass
    # (matrix index = bit(q_lo+1)*2 + bit(q_lo) -> kron(U_hi, U_lo))
    merged = []
    for op in ops:
        if (op[0] == "rowq" and merged and merged[-1][0] == "rowq"
                and abs(merged[-1][2] - op[2]) == 1):
            _, U_prev, q_prev = merged[-1]
            _, U, q = op
            if q > q_prev:
                merged[-1] = ("row2", np.kron(U, U_prev), q_prev)
            else:
                merged[-1] = ("row2", np.kron(U_prev, U), q)
        else:
            merged.append(op)
    return merged


def _sandwich_group_independent(group, op) -> bool:
    """True when no profile in ``group + [op]`` conditions on any of the
    combined ancilla set (the commutation requirement for multi fusion).
    Each element is a ('sandwich', a, nt, na, nb, mt, ma, mb) op."""
    ancs = {s[1] for s in group} | {op[1]}
    for s in list(group) + [op]:
        for terms in (s[2], s[5]):  # nu terms, mu terms
            for conds in terms:
                if any(p in ancs for p, _ in conds):
                    return False
    return True


def fold_uniform_prefix(prim: list):
    """Detect the H-wall prefix and fold it into a closed-form init.

    Every leading ``('1q', H, q)`` on a distinct qubit acts on |0...0>, so
    the state after the prefix is the uniform real superposition over the
    folded qubits tensored with |0> elsewhere: a masked constant that one
    write-only pass produces. A qubit is folded only if it has NO LATER
    1q primitive: ancilla H's must stay in the stream so the H·D·H
    sandwich fusion still sees its triples.

    Returns ``(folded_qubits, rest)``; ``folded_qubits`` is () when
    nothing folds (no leading H's, e.g. lowered basis-gate streams).
    """
    H = np.asarray(GATES_1Q["h"], np.complex64)
    last_1q = {}
    for k, p in enumerate(prim):
        if p[0] == "1q":
            last_1q[p[2]] = k
    folded = []
    k = 0
    while k < len(prim):
        p = prim[k]
        if p[0] != "1q":
            break
        _, U, q = p
        if (q in folded or last_1q[q] != k
                or not np.allclose(U, H, atol=1e-9)):
            break
        folded.append(q)
        k += 1
    if len(folded) < 2:  # a lone H saves nothing over its own pass
        return (), prim
    return tuple(sorted(folded)), prim[k:]


def sandwich_fold_parts(first_op, folded_locals):
    """If a fused stream's first op is a sandwich group whose ancillas
    avoid ``folded_locals``, return its ``(a, nts, nas, nbs, mt, ma,
    mb)`` normalized to the multi (k-tuple) layout so a write-only
    uniform-init fold can absorb it; else None."""
    if first_op[0] in ("sandwichk", "sandwich4"):
        _, a, nts, nas, nbs, mt, ma, mb = first_op
        if any(a <= q < a + len(nts) for q in folded_locals):
            return None
        return a, nts, nas, nbs, mt, ma, mb
    if first_op[0] == "sandwich":
        _, a, nt, na, nb, mt, ma, mb = first_op
        if a in folded_locals:
            return None
        return a, (nt,), (na,), (nb,), mt, ma, mb
    return None


def plan_stream(circuit: Circuit) -> list:
    """Fused op stream of a circuit, planned from its gates:
    :func:`circuit_primitives` (X-deferred lowering) composed with
    :func:`fuse_primitives` (peephole fusion). The H-wall prefix folds into
    a closed-form ``('init_uniform', qubits)`` first op, or into the first
    sandwich group as a write-only ``sandwichku`` (see
    :func:`fold_uniform_prefix`). :func:`fuse_ops` is this planner behind a
    cache."""
    prim = circuit_primitives(circuit)
    folded, rest = fold_uniform_prefix(prim)
    if not folded:
        return fuse_primitives(prim)
    ops = fuse_primitives(rest)
    # the uniform state's ancilla bits are 0, so the first multi
    # sandwich's output on it has a closed form: one write-only pass
    # replaces a write pass plus a read+write pass (ancillas are never
    # folded, see fold_uniform_prefix)
    if ops:
        parts = sandwich_fold_parts(ops[0], folded)
        if parts is not None:
            return [("sandwichku", folded) + parts] + ops[1:]
    return [("init_uniform", folded)] + ops


# ---- one plan a gate skeleton ----------------------------------------------
#
# A gate's parameter enters a fused stream only through diagonal angles, to
# which the planner applies +, unary -, / and abs; the stream's structure
# (kinds, qubits, conditions, matrices) comes from the parameter-free gates
# and the layout. The one choice that reads an angle's value is a term's
# drop at |angle| <= 1e-12 (_try_sandwich). So fuse_ops keeps, per gate
# skeleton, the stream's structure, the tape of the float operations that
# make its angles from the gate parameters in the planner's own order, and
# the outcomes of its drop tests.

#: fused streams kept, one a gate skeleton (least recently used evicted)
FUSE_CACHE_SIZE = 64


class _Angle:
    """An angle while the planner is traced: its value and its node of the
    :class:`_Tape` that recomputes it from the gate parameters."""

    __slots__ = ("tape", "ref", "val")

    def __init__(self, tape, ref, val):
        self.tape, self.ref, self.val = tape, ref, val

    def __add__(self, other):
        return self.tape.add(self, other)

    __radd__ = __add__  # float addition commutes, bit for bit

    def __neg__(self):
        return self.tape.neg(self)

    def __truediv__(self, divisor):
        return self.tape.div(self, divisor)

    def __abs__(self):
        return self.tape.abs(self)

    def __gt__(self, threshold):
        return self.tape.test(self, threshold)


# the kinds of a tape's operations
_ADD, _ADD_CONST, _NEG, _DIV, _ABS = range(5)


class _Tape:
    """The float operations that make a traced stream's angles from the gate
    parameters ``p``.

    A leaf is ``sign * (p[j] / divisor)``: a parameter negated or not and
    divided at most once, where the order of the two changes no bit, so the
    leaves are one numpy expression. Each operation acts on earlier nodes
    and is replayed in the order the planner made it. A test is ``node >
    threshold``, with the outcome the planner took. A leaf's ref is its
    index, an operation's ``~index``; :meth:`node` numbers the leaves
    first, then the operations."""

    def __init__(self, params):
        self.params = params
        self.leaf_keys = []   # (j, sign, divisor) a leaf
        self.leaf_refs = {}   # (j, sign, divisor) -> ref
        self.ops = []         # (kind, ref, ref or constant or None)
        self.tests = []       # (ref, threshold, outcome)
        self.vals = []        # each leaf's value
        self.op_vals = []     # each operation's value

    def leaf(self, j: int, sign: float = 1.0,
             divisor: float = 1.0) -> _Angle:
        key = (j, sign, divisor)
        ref = self.leaf_refs.get(key)
        if ref is None:
            ref = self.leaf_refs[key] = len(self.leaf_keys)
            self.leaf_keys.append(key)
            self.vals.append(sign * (self.params[j] / divisor))
        return _Angle(self, ref, self.vals[ref])

    def _op(self, kind, a, b, val) -> _Angle:
        self.ops.append((kind, a, b))
        self.op_vals.append(val)
        return _Angle(self, ~(len(self.ops) - 1), val)

    def add(self, x: _Angle, other) -> _Angle:
        if isinstance(other, _Angle):
            return self._op(_ADD, x.ref, other.ref, x.val + other.val)
        return self._op(_ADD_CONST, x.ref, other, x.val + other)

    def neg(self, x: _Angle) -> _Angle:
        if x.ref >= 0:
            j, sign, divisor = self.leaf_keys[x.ref]
            return self.leaf(j, -sign, divisor)
        return self._op(_NEG, x.ref, None, -x.val)

    def div(self, x: _Angle, divisor) -> _Angle:
        if x.ref >= 0 and self.leaf_keys[x.ref][2] == 1.0:
            j, sign, _ = self.leaf_keys[x.ref]
            return self.leaf(j, sign, divisor)
        return self._op(_DIV, x.ref, divisor, x.val / divisor)

    def abs(self, x: _Angle) -> _Angle:
        return self._op(_ABS, x.ref, None, abs(x.val))

    def test(self, x: _Angle, threshold) -> bool:
        outcome = x.val > threshold
        self.tests.append((x.ref, threshold, outcome))
        return outcome

    def node(self, ref: int) -> int:
        return ref if ref >= 0 else len(self.leaf_keys) + ~ref


class _Slot(int):
    """An angle of a kept stream: the index of its node's value."""


class _Holder(tuple):
    """A tuple of a kept stream that holds angles."""


def _hold(x, tape: _Tape):
    """``x``, a piece of a traced stream, with each angle made a
    :class:`_Slot` and each tuple that holds one a :class:`_Holder`. What
    holds no angle (conditions, matrices) is kept as it is: every stream
    refilled from the plan shares it."""
    if isinstance(x, _Angle):
        return _Slot(tape.node(x.ref))
    if type(x) is tuple:
        items = tuple(_hold(y, tape) for y in x)
        if any(type(y) in (_Slot, _Holder) for y in items):
            return _Holder(items)
    return x


def _fill(x, vals):
    """A kept piece with its slots replaced by their values."""
    kind = type(x)
    if kind is _Holder:
        return tuple([_fill(y, vals) for y in x])
    if kind is _Slot:
        return vals[x]
    return x


class _Plan:
    """A fused stream kept for one gate skeleton: its ops with slots for
    the angles, and its tape with the nodes numbered."""

    __slots__ = ("ops", "leaf_j", "leaf_sign", "leaf_div", "steps", "tests")

    def __init__(self, ops, tape: _Tape):
        self.ops = [_hold(op, tape) for op in ops]
        j, sign, div = zip(*tape.leaf_keys) if tape.leaf_keys else ((),) * 3
        self.leaf_j = np.asarray(j, dtype=np.int64)
        self.leaf_sign = np.asarray(sign, dtype=np.float64)
        self.leaf_div = np.asarray(div, dtype=np.float64)
        node = tape.node
        self.steps = [(kind, node(a), node(b) if kind == _ADD else b)
                      for kind, a, b in tape.ops]
        self.tests = [(node(ref), t, outcome)
                      for ref, t, outcome in tape.tests]

    def values(self, params):
        """Every node's value for the gate parameters ``params``, or None
        where a drop test comes out otherwise than when the plan was
        made."""
        p = np.asarray(params, dtype=np.float64)
        vals = (self.leaf_sign * (p[self.leaf_j] / self.leaf_div)).tolist()
        push = vals.append
        for kind, a, b in self.steps:
            if kind == _ADD:
                push(vals[a] + vals[b])
            elif kind == _ADD_CONST:
                push(vals[a] + b)
            elif kind == _NEG:
                push(-vals[a])
            elif kind == _DIV:
                push(vals[a] / b)
            else:
                push(abs(vals[a]))
        for node, t, outcome in self.tests:
            if (vals[node] > t) != outcome:
                return None
        return vals

    def stream(self, vals) -> list:
        return [_fill(op, vals) for op in self.ops]


def _trace(circuit: Circuit, params) -> Tuple[_Plan, list]:
    """(plan, stream): the planner run once on ``circuit`` with its gate
    parameters ``params`` traced."""
    tape = _Tape(params)
    gates, j = [], 0
    for g in circuit.gates:
        if g.name in _PARAM_GATES:
            g = g.with_params((tape.leaf(j),))
            j += 1
        gates.append(g)
    traced = plan_stream(Circuit(circuit.num_qubits, gates=gates))
    plan = _Plan(traced, tape)
    return plan, plan.stream(tape.vals + tape.op_vals)


#: gate skeleton -> _Plan, least recently used first
_PLANS: "collections.OrderedDict[tuple, _Plan]" = collections.OrderedDict()


@profiling.spanned("qcmrf.planes.fuse")
def fuse_ops(circuit: Circuit) -> list:
    """:func:`plan_stream` of a circuit, kept per gate skeleton (every
    gate's name, qubits and flags; at most :data:`FUSE_CACHE_SIZE`). A
    circuit of a kept skeleton gets the kept stream with its angles
    recomputed from its own gate parameters, in the planner's order: the
    stream the planner would give, bit for bit (counted as ``fuse_hit``).
    The planner runs (counted as ``fuse_build``) on a new skeleton, and
    where a term it dropped at a near-zero angle, or kept, would now go the
    other way. The stream's matrices are the kept plan's own: callers read
    them and do not write to them."""
    skeleton, params = [], []
    for g in circuit.gates:
        skeleton.append((g.name, g.qubits, g.flags))
        if g.name in _PARAM_GATES:
            params.append(g.params[0])
    skeleton = tuple(skeleton)
    plan = _PLANS.get(skeleton)
    vals = plan.values(params) if plan is not None else None
    if vals is not None:
        _PLANS.move_to_end(skeleton)
        profiling.count("fuse_hit")
        return plan.stream(vals)
    profiling.count("fuse_build")
    plan, ops = _trace(circuit, params)
    _PLANS[skeleton] = plan
    _PLANS.move_to_end(skeleton)
    if len(_PLANS) > FUSE_CACHE_SIZE:
        _PLANS.popitem(last=False)
    return ops


@profiling.spanned("qcmrf.planes.run")
def fold_fresh(ops) -> list:
    """The stream with the sandwich groups that follow its leading
    write-only ``sandwichku`` absorbed into it, while each group's
    ancillas are still |0> on its input: unfolded, directly after the
    ones absorbed, extending their adjacent range to at most
    ``kernels.MAX_UNIFORM_K``, and no profile of the merged pass (mu
    included) conditioning on any of its ancillas
    (:func:`_sandwich_group_independent`). Such a group's input on its
    own ancillas is (psi, 0, ..., 0), so its output has the closed form
    of the write-only pass: the merged pass is one write over all their
    ancillas, its nu profiles appended and its mu terms concatenated,
    bases added, as post-pass 1b merges, while all its terms fit the
    kernels' table (``kernels.MAX_SANDWICH_TERMS``). Counts ``fresh_fold``
    once an absorbed group (by 0 where a leading ``sandwichku`` absorbs
    none). Any other stream is returned as it is."""
    if not ops or ops[0][0] != "sandwichku":
        return ops
    _, folded, a, nts, nas, nbs, mt, ma, mb = ops[0]
    i = 1
    while i < len(ops):
        parts = sandwich_fold_parts(ops[i], folded)
        if parts is None:
            break
        b, nts2, nas2, nbs2, mt2, ma2, mb2 = parts
        k = len(nts) + len(nts2)
        if b == a + len(nts):
            merged = (a, nts + nts2, nas + nas2, nbs + nbs2)
        elif b + len(nts2) == a:
            merged = (b, nts2 + nts, nas2 + nas, nbs2 + nbs)
        else:
            break
        # each ancilla a sandwich op, mu terms on the first
        singles = [("sandwich", merged[0] + t, merged[1][t], (), 0.0,
                    mt + mt2 if t == 0 else (), (), 0.0) for t in range(k)]
        n_terms = sum(map(len, merged[1])) + len(mt) + len(mt2)
        if (k > K.MAX_UNIFORM_K or n_terms > K.MAX_SANDWICH_TERMS
                or not _sandwich_group_independent(singles[1:], singles[0])):
            break
        a, nts, nas, nbs = merged
        mt, ma, mb = mt + mt2, ma + ma2, mb + mb2
        i += 1
    profiling.count("fresh_fold", i - 1)
    if i == 1:
        return ops
    return [("sandwichku", folded, a, nts, nas, nbs, mt, ma, mb)] + ops[i:]


@profiling.spanned("qcmrf.planes.run")
def apply_ops(re, im, ops, num_qubits: int):
    """Run a fused op stream on the planes, op for op as given, updating
    them in place; returns them."""
    for op in ops:
        kind = op[0]
        if kind == "init_uniform":
            K.uniform_planes(num_qubits, op[1], out=(re, im))
        elif kind == "sandwich":
            _, a, nt, na, nb, mt, ma, mb = op
            K.apply_hdh_sandwich(re, im, a, nt, na, nb, mt, ma, mb)
        elif kind == "sandwich2":
            _, a, nt1, na1, nb1, nt2, na2, nb2, mt, ma, mb = op
            K.apply_hdh_sandwich_pair(re, im, a, nt1, na1, nb1, nt2, na2,
                                      nb2, mt, ma, mb)
        elif kind == "sandwich4":
            _, a, nts, nas, nbs, mt, ma, mb = op
            K.apply_hdh_sandwich_quad(re, im, a, nts, nas, nbs, mt, ma, mb)
        elif kind == "sandwichk":
            _, a, nts, nas, nbs, mt, ma, mb = op
            K.apply_hdh_sandwich_multi(re, im, a, nts, nas, nbs, mt, ma,
                                       mb)
        elif kind == "sandwichku":
            _, folded, a, nts, nas, nbs, mt, ma, mb = op
            K.apply_hdh_sandwich_multi_uniform(
                num_qubits, folded, a, nts, nas, nbs, mt, ma, mb,
                out=(re, im))
        elif kind == "diag":
            _, terms, angles, base = op
            K.apply_diagonal_profile(re, im, terms, angles, base)
        elif kind == "lane" and len(op) == 3:
            K.apply_lane_factored(re, im, op[2])
        elif kind == "lane":
            K.apply_lane(re, im, op[1])
        elif kind == "rowq":
            _, U, q = op
            K.apply_1q(re, im, U, q, num_qubits)
        elif kind == "row2":
            _, U4, q_lo = op
            K.apply_2q_row_pair(re, im, U4, q_lo)
        else:
            raise ValueError(f"unknown op {kind!r}")
    return re, im


def _start_planes(ops, num_qubits: int, device):
    """Planes for a stream to run from ``|0...0>``: not zeroed where its
    first op writes them whole."""
    device = resolve_device(device)
    if ops and ops[0][0] in ("init_uniform", "sandwichku"):
        shape = K.plane_shape(num_qubits)
        return (torch.empty(shape, dtype=torch.float32, device=device),
                torch.empty(shape, dtype=torch.float32, device=device))
    return zero_planes(num_qubits, device)


def run_ops(ops, num_qubits: int, device=None):
    """Planes of ``|0...0>`` after a fused op stream, on ``device`` (the
    current CUDA device unless one is named; raises when there is none).
    A leading write-only pass first absorbs the sandwich groups on fresh
    ancillas after it (:func:`fold_fresh`)."""
    ops = fold_fresh(ops)
    return apply_ops(*_start_planes(ops, num_qubits, device), ops,
                     num_qubits)


def _engine_width(circuit: Circuit) -> int:
    nq = circuit.num_qubits
    if nq < 7:
        raise ValueError(
            "the plane engine needs >= 7 qubits; use sim.dense below that"
        )
    return nq


def run_statevector(circuit: Circuit, device=None):
    """Final statevector planes ``(2**Q / 128, 128)`` with measurements
    deferred (fused ops), on ``device``: the current CUDA device unless
    the caller names one (``device="cpu"`` runs the plain versions)."""
    nq = _engine_width(circuit)
    re, im = run_ops(fuse_ops(circuit), nq, device)
    if circuit.global_phase:
        c = float(np.cos(circuit.global_phase))
        s = float(np.sin(circuit.global_phase))
        re, im = re * c - im * s, re * s + im * c
    return re, im


def _clbit_probs(circuit: Circuit, probs: torch.Tensor) -> torch.Tensor:
    """The joint clbit-value distribution of the flat outcome
    probabilities ``probs`` (QCMRF wiring: identity key map)."""
    pairs = circuit.measured_pairs
    # the identity shortcut holds only when EVERY qubit is measured to its
    # own clbit AND the clbit register is exactly the qubit register;
    # otherwise the mass is marginalised onto keys with unmeasured clbits
    # zero (dense semantics)
    if not pairs or (
        len(pairs) == circuit.num_qubits
        and circuit.num_clbits == circuit.num_qubits
        and all(q == c for q, c in pairs)
    ):
        return probs
    idx = torch.arange(probs.shape[0], dtype=torch.int64,
                       device=probs.device)
    keys = torch.zeros_like(idx)
    for q, c in pairs:
        keys = keys | (((idx >> q) & 1) << c)
    out = torch.zeros((1 << circuit.num_clbits,), dtype=probs.dtype,
                      device=probs.device)
    return out.index_add_(0, keys, probs)


@profiling.spanned("qcmrf.planes.outcome")
def outcome_probs(circuit: Circuit, re, im) -> torch.Tensor:
    """Joint clbit-value distribution (QCMRF wiring: identity key map)."""
    return _clbit_probs(circuit, (re * re + im * im).reshape(-1))


#: the passes of a fused stream that have a probability form
_PROBS_KINDS = ("sandwichku", "sandwich", "sandwichk")


@profiling.spanned("qcmrf.planes.run")
def _probs_pass(op, num_qubits: int, planes, device) -> torch.Tensor:
    """A stream's last pass, a sandwich pass, in its probability form:
    every basis state's probability, flat. The write-only pass (a stream
    it absorbed whole) takes no planes; a read-write pass reads
    ``planes``, its input, and writes the probabilities into the real
    plane."""
    if op[0] == "sandwichku":
        return K.apply_hdh_sandwich_multi_uniform_probs(num_qubits, *op[1:],
                                                        device=device)
    if op[0] == "sandwich":
        _, a, nt, na, nb, mt, ma, mb = op
        nts, nas, nbs = (nt,), (na,), (nb,)
    else:
        _, a, nts, nas, nbs, mt, ma, mb = op
    return K.apply_hdh_sandwich_multi_probs(*planes, a, nts, nas, nbs, mt,
                                            ma, mb).reshape(-1)


@profiling.spanned("qcmrf.planes.simulate")
def simulate_probs(circuit: Circuit, device=None) -> torch.Tensor:
    """Run + outcome distribution, on ``device`` as for
    :func:`run_statevector`. A stream that ends in a sandwich pass runs its
    last pass in its probability form, so no amplitude of the final state
    is stored: the write-only pass where it absorbs the whole stream
    (:func:`fold_fresh`; then no planes are made at all), else the last
    read-write pass; any other stream ends with :func:`outcome_probs`. The
    global phase changes no probability and is not applied."""
    nq = _engine_width(circuit)
    ops = fold_fresh(fuse_ops(circuit))
    if not ops or ops[-1][0] not in _PROBS_KINDS:
        return outcome_probs(circuit, *apply_ops(
            *_start_planes(ops, nq, device), ops, nq))
    *head, last = ops
    planes = (None if last[0] == "sandwichku" else
              apply_ops(*_start_planes(head, nq, device), head, nq))
    probs = _probs_pass(last, nq, planes, device)
    with profiling.span("qcmrf.planes.outcome"):
        return _clbit_probs(circuit, probs)
