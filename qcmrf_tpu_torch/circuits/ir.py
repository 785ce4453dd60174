"""A small circuit IR for the QCMRF compiler and simulators (port of
:mod:`qcmrf_tpu.circuits.ir`, plain Python, same semantics).

A flat, hashable gate list over integer qubits: no parameter binding, no
registers.

Gate set
--------
Primitive:  h, x, sx, sxdg, rz(lam), cx, cp(lam), id
High-level: flags_phase: a diagonal phase ``e^{i*angle}`` on basis states
            whose *pattern qubits* match ``flags`` and whose control qubit
            is |1> (the fused [AND(flags) -> cp(2*gamma) -> AND-dagger]
            block of a QCMRF clique, with the workspace qubit elided).
Meta:       measure (qubit -> clbit), barrier, global_phase.

QCMRF measures each ancilla once, mid-circuit, and never touches it again,
so deferred measurement is exact: the simulators sample the final joint
distribution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

PRIMITIVE_1Q = ("h", "x", "sx", "sxdg", "id")
PARAM_1Q = ("rz",)
PRIMITIVE_2Q = ("cx",)
PARAM_2Q = ("cp",)


@dataclasses.dataclass(frozen=True)
class Gate:
    name: str
    qubits: Tuple[int, ...]
    params: Tuple[float, ...] = ()
    # flags_phase only: +1 control-on-|1>, -1 control-on-|0> per pattern qubit
    flags: Tuple[int, ...] = ()
    clbits: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "qubits", tuple(int(q) for q in self.qubits))
        object.__setattr__(
            self, "params", tuple(float(p) for p in self.params)
        )
        object.__setattr__(self, "flags", tuple(int(f) for f in self.flags))
        object.__setattr__(self, "clbits", tuple(int(c) for c in self.clbits))

    def with_params(self, params: Tuple[float, ...]) -> "Gate":
        """This gate with ``params`` in place of its own, taken as given (a
        tuple of floats): the fields it keeps were converted when this gate
        was made and are not converted again."""
        g = object.__new__(Gate)
        g.__dict__.update(self.__dict__)
        g.__dict__["params"] = params
        return g


@dataclasses.dataclass
class Circuit:
    """A flat gate-list circuit with deferred measurements."""

    num_qubits: int
    num_clbits: int = 0
    gates: List[Gate] = dataclasses.field(default_factory=list)
    global_phase: float = 0.0
    name: str = "circuit"

    # ---- builder API ----------------------------------------------------

    def _append(self, name, qubits, params=(), flags=(), clbits=()):
        for q in qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(f"qubit {q} out of range for {name}")
        self.gates.append(
            Gate(name=name, qubits=tuple(qubits), params=tuple(params),
                 flags=tuple(flags), clbits=tuple(clbits))
        )
        return self

    def h(self, q):        return self._append("h", (q,))
    def x(self, q):        return self._append("x", (q,))
    def sx(self, q):       return self._append("sx", (q,))
    def sxdg(self, q):     return self._append("sxdg", (q,))
    def id(self, q):       return self._append("id", (q,))
    def rz(self, lam, q):  return self._append("rz", (q,), (lam,))
    def cx(self, c, t):    return self._append("cx", (c, t))
    def cp(self, lam, c, t): return self._append("cp", (c, t), (lam,))
    def barrier(self):     return self._append("barrier", ())

    def flags_phase(self, pattern_qubits: Sequence[int],
                    flags: Sequence[int], angle: float, control: int):
        """Diagonal phase e^{i*angle} on {pattern matches flags} & {control=1}.

        Semantics of the AND(flags) / cp(2g) / AND-dagger sandwich of a
        QCMRF clique block, with the workspace qubit elided.
        """
        if len(pattern_qubits) != len(flags):
            raise ValueError("flags length must match pattern qubits")
        return self._append(
            "flags_phase", tuple(pattern_qubits) + (control,),
            (angle,), flags=tuple(flags),
        )

    def measure(self, qubit: int, clbit: int):
        if not (0 <= clbit < self.num_clbits):
            raise ValueError(f"clbit {clbit} out of range")
        return self._append("measure", (qubit,), clbits=(clbit,))

    def add_global_phase(self, phase: float):
        self.global_phase = math.fmod(self.global_phase + phase, 2 * math.pi)
        return self

    # ---- inspection ------------------------------------------------------

    @property
    def measured_pairs(self) -> List[Tuple[int, int]]:
        return [
            (g.qubits[0], g.clbits[0]) for g in self.gates
            if g.name == "measure"
        ]

    def count_ops(self) -> dict:
        out: dict = {}
        for g in self.gates:
            out[g.name] = out.get(g.name, 0) + 1
        return out

    def depth(self) -> int:
        """Gate depth over qubits (barriers/measures included as ops)."""
        level = [0] * max(self.num_qubits, 1)
        d = 0
        for g in self.gates:
            if g.name == "barrier" or not g.qubits:
                continue
            l = max(level[q] for q in g.qubits) + 1
            for q in g.qubits:
                level[q] = l
            d = max(d, l)
        return d

    def inverse(self) -> "Circuit":
        """Adjoint circuit (no measurements allowed)."""
        inv = Circuit(self.num_qubits, self.num_clbits,
                      name=self.name + "_dg")
        inv.global_phase = -self.global_phase
        for g in reversed(self.gates):
            if g.name == "measure":
                raise ValueError("cannot invert a circuit with measurements")
            if g.name in ("h", "x", "cx", "id", "barrier"):
                inv.gates.append(g)
            elif g.name == "sx":
                inv.gates.append(dataclasses.replace(g, name="sxdg"))
            elif g.name == "sxdg":
                inv.gates.append(dataclasses.replace(g, name="sx"))
            elif g.name in ("rz", "cp", "flags_phase"):
                inv.gates.append(
                    dataclasses.replace(g, params=(-g.params[0],))
                )
            else:
                raise ValueError(f"cannot invert gate {g.name}")
        return inv

    def extend(self, other: "Circuit", qubit_map: Optional[Sequence[int]] = None):
        """Append another circuit, optionally remapping its qubits.

        Measure gates are remapped clbit-alongside-qubit (this package's
        wiring is always clbit == qubit index); a measure whose clbit does
        not follow that convention cannot be remapped unambiguously and
        raises instead of silently mis-wiring.
        """
        for g in other.gates:
            qubits = g.qubits
            clbits = g.clbits
            if qubit_map is not None:
                qubits = tuple(qubit_map[q] for q in qubits)
                if g.name == "measure":
                    if g.clbits != g.qubits:
                        raise ValueError(
                            "extend(qubit_map=...) cannot remap a measure "
                            f"with clbits {g.clbits} != qubits {g.qubits}"
                        )
                    clbits = qubits
            self.gates.append(
                dataclasses.replace(g, qubits=qubits, clbits=clbits)
            )
        self.global_phase = math.fmod(
            self.global_phase + other.global_phase, 2 * math.pi
        )
        return self
