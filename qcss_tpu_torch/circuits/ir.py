"""A small Clifford circuit / program IR.

Replaces the reference's use of pyQuil ``Program`` as both the user-facing
input to the FT transpiler and the synthesis target for encoding networks
(reference: css_code.py:203-312, ftqc.py:42-120). Unlike Quil, the IR has
*structured* control flow only (``if_then`` on a classical bit), because the
execution target is a traced, batched JAX program rather than an instruction
interpreter with jumps: arbitrary ``Jump``/``JumpTarget`` control flow does
not exist on this substrate by design.

`Circuit`  — a pure unitary Clifford gate list (H/S/X/Y/Z/CNOT/CZ/I).
`Program`  — circuits plus classical memory declarations, MEASURE, RESET and
             IF_THEN; the input language of `qcss_tpu_torch.ftqc.rewrite_program`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Union

CLIFFORD_1Q = ("I", "X", "Y", "Z", "H", "S")
CLIFFORD_2Q = ("CNOT", "CZ")
GATE_ARITY = {**{g: 1 for g in CLIFFORD_1Q}, **{g: 2 for g in CLIFFORD_2Q}}

# Opcode numbering for array-lowered circuits; the order must match the
# branch table in qcss_tpu_torch.sim.tableau.run_circuit_scanned.
OPCODES = {name: i for i, name in enumerate(CLIFFORD_1Q + CLIFFORD_2Q)}


@dataclass(frozen=True)
class GateInst:
    name: str
    qubits: tuple[int, ...]

    def __post_init__(self):
        if self.name not in GATE_ARITY:
            raise ValueError(f"unknown gate {self.name!r}")
        if len(self.qubits) != GATE_ARITY[self.name]:
            raise ValueError(
                f"{self.name} expects {GATE_ARITY[self.name]} qubits, "
                f"got {len(self.qubits)}"
            )
        if len(set(self.qubits)) != len(self.qubits):
            raise ValueError("gate qubits must be distinct")


@dataclass(frozen=True)
class BitRef:
    """A reference to one bit of a declared classical register."""

    name: str
    index: int


@dataclass(frozen=True)
class DeclareInst:
    name: str
    size: int


@dataclass(frozen=True)
class MeasureInst:
    qubit: int
    target: BitRef


@dataclass(frozen=True)
class ResetInst:
    qubit: int


@dataclass(frozen=True)
class IfThenInst:
    """Apply `body` (unitary only) iff the classical bit is 1."""

    condition: BitRef
    body: "Circuit"


@dataclass(frozen=True)
class PragmaInst:
    """An annotation with no execution semantics, carried through the
    transpiler untouched — the analogue of the reference's Pragma
    pass-through (reference: ftqc.py:113-114). Useful for tagging programs
    for external tooling; both engines skip it."""

    name: str
    args: tuple = ()


CLASSICAL_OPS = ("MOVE", "NOT", "AND", "IOR", "XOR")


@dataclass(frozen=True)
class ClassicalInst:
    """A classical bit operation inside a user program — the IR form of the
    classical instructions the reference's transpiler passes through
    (reference: ftqc.py:111-116, quil_classical.py:60-127).

    dst <op>= src, where src is another BitRef or an immediate 0/1
    (ignored for the unary NOT)."""

    op: str
    dst: BitRef
    src: "BitRef | int | None" = None

    def __post_init__(self):
        if self.op not in CLASSICAL_OPS:
            raise ValueError(f"unknown classical op {self.op!r}")
        if self.op == "NOT":
            if self.src is not None:
                raise ValueError("NOT is unary")
        elif self.src is None:
            raise ValueError(f"{self.op} needs a source bit or immediate")
        elif isinstance(self.src, int) and self.src not in (0, 1):
            raise ValueError("immediate must be 0 or 1")


@dataclass(frozen=True)
class GuardedInst:
    """Execute `inner` iff the classical guard bit reads 1, per sample.

    The general masked-instruction form behind arbitrary (goto-shaped)
    control flow: the Quil front-end's CFG structurizer lowers every basic
    block to guarded instructions over one-hot block-activity bits, and a
    bounded dispatch loop re-runs the guarded program until every sample
    reaches the exit block (the traced replacement for the reference's
    mangled-label jump pass-through — reference: ftqc.py:98-103,147-151).
    Unlike `IfThenInst` (unitary body only), the inner instruction may be a
    measurement, reset or classical op; execution requires the scheduled
    engine, whose macro-ops all support per-sample condition masking."""

    condition: BitRef
    inner: "GateInst | MeasureInst | ResetInst | ClassicalInst"

    def __post_init__(self):
        if not isinstance(self.inner, (GateInst, MeasureInst, ResetInst,
                                       ClassicalInst)):
            raise ValueError(
                f"GuardedInst cannot wrap {type(self.inner).__name__}")


@dataclass(frozen=True)
class RepeatUntilInst:
    """Bounded repeat-until-success: execute `body` while the classical bit
    is 0, re-checking before every body instruction, for at most
    `max_iters` iterations.

    The traced replacement for the unstructured Quil jump loops the
    reference transpiles (reference: ftqc.py:98-107): under batching the
    loop must have a fixed bound, and per-sample progress is handled by
    masking (samples whose bit is already 1 pass through untouched). The
    body may contain gates, measurements and resets (typically ending in
    the measurement that sets the condition bit)."""

    condition: BitRef
    body: tuple  # of GateInst | MeasureInst | ResetInst
    max_iters: int

    def __post_init__(self):
        if self.max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        for inst in self.body:
            if not isinstance(inst, (GateInst, MeasureInst, ResetInst,
                                     ClassicalInst, GuardedInst)):
                raise ValueError(
                    f"repeat_until body cannot contain {type(inst).__name__}"
                )


Instruction = Union[
    GateInst, MeasureInst, ResetInst, IfThenInst, RepeatUntilInst,
    ClassicalInst, PragmaInst, DeclareInst, GuardedInst
]


class Block:
    """An instruction-list builder for `Program.repeat_until` bodies: the
    same gate/measure/reset surface as `Program`, minus declarations (the
    body references the enclosing program's registers)."""

    def __init__(self):
        self.instructions: list[Instruction] = []

    def gate(self, name: str, *qubits: int) -> "Block":
        self.instructions.append(GateInst(name, tuple(int(q) for q in qubits)))
        return self

    def i(self, q):
        return self.gate("I", q)

    def x(self, q):
        return self.gate("X", q)

    def y(self, q):
        return self.gate("Y", q)

    def z(self, q):
        return self.gate("Z", q)

    def h(self, q):
        return self.gate("H", q)

    def s(self, q):
        return self.gate("S", q)

    def cnot(self, c, t):
        return self.gate("CNOT", c, t)

    def cz(self, a, b):
        return self.gate("CZ", a, b)

    def measure(self, qubit: int, target: BitRef) -> "Block":
        self.instructions.append(MeasureInst(int(qubit), target))
        return self

    def reset(self, qubit: int) -> "Block":
        self.instructions.append(ResetInst(int(qubit)))
        return self

    def move(self, dst: BitRef, src) -> "Block":
        self.instructions.append(ClassicalInst("MOVE", dst, src))
        return self

    def not_(self, dst: BitRef) -> "Block":
        self.instructions.append(ClassicalInst("NOT", dst))
        return self

    def and_(self, dst: BitRef, src) -> "Block":
        self.instructions.append(ClassicalInst("AND", dst, src))
        return self

    def ior(self, dst: BitRef, src) -> "Block":
        self.instructions.append(ClassicalInst("IOR", dst, src))
        return self

    def xor(self, dst: BitRef, src) -> "Block":
        self.instructions.append(ClassicalInst("XOR", dst, src))
        return self

    def guarded(self, condition: BitRef, inner) -> "Block":
        self.instructions.append(GuardedInst(condition, inner))
        return self


class Circuit:
    """An ordered list of Clifford gates on integer-indexed qubits."""

    def __init__(self, gates: Iterable[GateInst] = ()):  # noqa: D401
        self.gates: list[GateInst] = list(gates)

    # -- builders ------------------------------------------------------------

    def gate(self, name: str, *qubits: int) -> "Circuit":
        self.gates.append(GateInst(name, tuple(int(q) for q in qubits)))
        return self

    def i(self, q):
        return self.gate("I", q)

    def x(self, q):
        return self.gate("X", q)

    def y(self, q):
        return self.gate("Y", q)

    def z(self, q):
        return self.gate("Z", q)

    def h(self, q):
        return self.gate("H", q)

    def s(self, q):
        return self.gate("S", q)

    def cnot(self, c, t):
        return self.gate("CNOT", c, t)

    def cz(self, a, b):
        return self.gate("CZ", a, b)

    # -- utilities -----------------------------------------------------------

    def __iter__(self):
        return iter(self.gates)

    def __len__(self):
        return len(self.gates)

    def __add__(self, other: "Circuit") -> "Circuit":
        return Circuit(self.gates + list(other.gates))

    def __iadd__(self, other: "Circuit") -> "Circuit":
        self.gates.extend(other.gates)
        return self

    def num_qubits(self) -> int:
        return 1 + max((q for g in self.gates for q in g.qubits), default=-1)

    def to_arrays(self):
        """Lower to (opcodes, qubit0, qubit1) int32 numpy arrays for
        `lax.scan` execution (unused qubit slots are 0)."""
        import numpy as np

        T = len(self.gates)
        ops = np.zeros(T, dtype=np.int32)
        q0 = np.zeros(T, dtype=np.int32)
        q1 = np.zeros(T, dtype=np.int32)
        for i, g in enumerate(self.gates):
            ops[i] = OPCODES[g.name]
            q0[i] = g.qubits[0]
            if len(g.qubits) > 1:
                q1[i] = g.qubits[1]
        return ops, q0, q1

    def __repr__(self):
        body = "; ".join(f"{g.name}{list(g.qubits)}" for g in self.gates[:8])
        more = f" … +{len(self.gates) - 8}" if len(self.gates) > 8 else ""
        return f"<Circuit {len(self.gates)} gates: {body}{more}>"


class Program:
    """A Clifford program with classical memory: the raw input to the FT
    transpiler, playing the role of pyQuil ``Program`` in the reference."""

    def __init__(self):
        self.instructions: list[Instruction] = []
        self.memory: dict[str, int] = {}

    def declare(self, name: str, size: int = 1) -> list[BitRef]:
        if name in self.memory:
            raise ValueError(f"register {name!r} already declared")
        self.memory[name] = size
        self.instructions.append(DeclareInst(name, size))
        return [BitRef(name, i) for i in range(size)]

    def gate(self, name: str, *qubits: int) -> "Program":
        self.instructions.append(GateInst(name, tuple(int(q) for q in qubits)))
        return self

    def i(self, q):
        return self.gate("I", q)

    def x(self, q):
        return self.gate("X", q)

    def y(self, q):
        return self.gate("Y", q)

    def z(self, q):
        return self.gate("Z", q)

    def h(self, q):
        return self.gate("H", q)

    def s(self, q):
        return self.gate("S", q)

    def cnot(self, c, t):
        return self.gate("CNOT", c, t)

    def cz(self, a, b):
        return self.gate("CZ", a, b)

    def measure(self, qubit: int, target: BitRef) -> "Program":
        if target.name not in self.memory:
            raise ValueError(f"register {target.name!r} not declared")
        self.instructions.append(MeasureInst(int(qubit), target))
        return self

    def reset(self, qubit: int) -> "Program":
        self.instructions.append(ResetInst(int(qubit)))
        return self

    def if_then(self, condition: BitRef, body: Circuit) -> "Program":
        self.instructions.append(IfThenInst(condition, body))
        return self

    def guarded(self, condition: BitRef, inner) -> "Program":
        """Append a per-sample-guarded instruction (see `GuardedInst`)."""
        if condition.name not in self.memory:
            raise ValueError(f"register {condition.name!r} not declared")
        self.instructions.append(GuardedInst(condition, inner))
        return self

    def move(self, dst: BitRef, src) -> "Program":
        """dst = src (BitRef or immediate 0/1) — reference: ftqc.py:111-116."""
        self._check_declared(dst, src)
        self.instructions.append(ClassicalInst("MOVE", dst, src))
        return self

    def not_(self, dst: BitRef) -> "Program":
        self._check_declared(dst, None)
        self.instructions.append(ClassicalInst("NOT", dst))
        return self

    def and_(self, dst: BitRef, src) -> "Program":
        self._check_declared(dst, src)
        self.instructions.append(ClassicalInst("AND", dst, src))
        return self

    def ior(self, dst: BitRef, src) -> "Program":
        self._check_declared(dst, src)
        self.instructions.append(ClassicalInst("IOR", dst, src))
        return self

    def xor(self, dst: BitRef, src) -> "Program":
        self._check_declared(dst, src)
        self.instructions.append(ClassicalInst("XOR", dst, src))
        return self

    def pragma(self, name: str, *args) -> "Program":
        """Attach a no-op annotation (reference: ftqc.py:113-114)."""
        self.instructions.append(PragmaInst(str(name), tuple(args)))
        return self

    def _check_declared(self, dst: BitRef, src):
        if dst.name not in self.memory:
            raise ValueError(f"register {dst.name!r} not declared")
        if isinstance(src, BitRef) and src.name not in self.memory:
            raise ValueError(f"register {src.name!r} not declared")

    def repeat_until(self, condition: BitRef, body: Block,
                     max_iters: int) -> "Program":
        """Repeat `body` (a `Block`) while `condition` reads 0, at most
        `max_iters` times — see `RepeatUntilInst`. The register must be
        declared (and is zero-initialized, so a fresh bit always admits the
        first iteration)."""
        if condition.name not in self.memory:
            raise ValueError(f"register {condition.name!r} not declared")
        for inst in body.instructions:
            if isinstance(inst, MeasureInst) and inst.target.name not in self.memory:
                raise ValueError(f"register {inst.target.name!r} not declared")
        self.instructions.append(
            RepeatUntilInst(condition, tuple(body.instructions), int(max_iters))
        )
        return self

    def qubits(self) -> list[int]:
        found: set[int] = set()

        def scan(insts):
            for inst in insts:
                if isinstance(inst, GateInst):
                    found.update(inst.qubits)
                elif isinstance(inst, (MeasureInst, ResetInst)):
                    found.add(inst.qubit)
                elif isinstance(inst, IfThenInst):
                    found.update(q for g in inst.body for q in g.qubits)
                elif isinstance(inst, RepeatUntilInst):
                    scan(inst.body)
                elif isinstance(inst, GuardedInst):
                    scan((inst.inner,))

        scan(self.instructions)
        return sorted(found)

    def __repr__(self):
        return f"<Program {len(self.instructions)} instructions, mem={self.memory}>"
