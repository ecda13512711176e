"""The deterministic FT-encoded programs of the JAX package's end-to-end
tests (tests/test_ftqc.py, tests/test_quil.py), with their exact outcomes.

Each `Spec` builds its program through an IR namespace (`Program`,
`Circuit`, `Block`, `parse_quil`), so the same program can be built by
this package or by another that has the same builder surface,
and names the code, the `rewrite_program` options and the gold: a check
on the registers of every shot (``"__prep_fail__"`` excluded).

`FRAMES_PROGRAMS` adds the deterministic set of the JAX package's
tests/test_ftqc_frames.py that `PROGRAMS` lacks; `FRAMES_REFUSED` names
the programs of both sets that the JAX package's 'frames' engine refuses,
and `UNROLLED_REFUSED` the programs of `PROGRAMS` that its unrolled engine
refuses. Used by ``chip_smoke.py`` (paths 12-14) and by the CPU tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable

import numpy as np

# tests/test_quil.py: the loop {A, B} with two entries (fall-through into
# A, a jump into B), which only the dispatch tier of the Quil front end
# (guarded instructions inside a repeat_until) can express
QUIL_TWO_ENTRY_LOOP = """
    DECLARE ro BIT[2]
    DECLARE c BIT
    DECLARE k BIT
    MOVE c 1
    JUMP-WHEN @B c
    LABEL @A
    X 0
    LABEL @B
    MEASURE 0 ro[0]
    NOT k
    JUMP-WHEN @A k
    MEASURE 0 ro[1]
"""

CODES = {
    "steane": lambda fam: fam.steane(),
    "surface3": lambda fam: fam.rotated_surface(3, max_table_weight=2,
                                                t=None),
    "surface5": lambda fam: fam.rotated_surface(5, max_table_weight=3,
                                                t=None),
    "shor": lambda fam: fam.shor(),
}


@dataclass(frozen=True)
class Spec:
    build: Callable          # IR namespace -> Program
    gold: Callable           # {"ro": [B, m] uint8, ...} -> bool
    code: str = "steane"
    options: dict = field(default_factory=dict)
    source: str = ""         # the test it comes from


def _ir():
    from qcss_tpu_torch.circuits import Block, Circuit, Program, parse_quil

    return SimpleNamespace(Program=Program, Circuit=Circuit, Block=Block,
                           parse_quil=parse_quil)


def _single(ops: str):
    """One logical qubit: the gates ``ops`` (one letter each), then
    measure into ro[0]."""
    def build(ir):
        prog = ir.Program()
        ro = prog.declare("ro", 1)
        for g in ops:
            getattr(prog, g.lower())(0)
        prog.measure(0, ro[0])
        return prog
    return build


def _const(*bits):
    return lambda res: bool((res["ro"] == np.asarray(bits)).all())


def _feedback(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 2)
    prog.h(0)
    prog.measure(0, ro[0])
    prog.if_then(ro[0], ir.Circuit().x(0))
    prog.measure(0, ro[1])
    return prog


def _superdense(bit0: int, bit1: int):
    def build(ir):
        prog = ir.Program()
        ro = prog.declare("ro", 2)
        prog.h(0).cnot(0, 1)
        if bit0 == 0 and bit1 == 1:
            prog.x(0)
        if bit0 == 1 and bit1 == 0:
            prog.z(0)
        if bit0 == 1 and bit1 == 1:
            prog.x(0).z(0)
        prog.cnot(0, 1).h(0)
        prog.measure(0, ro[0])
        prog.measure(1, ro[1])
        return prog
    return build


def _ghz4(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 4)
    prog.h(0).cnot(0, 1).cnot(1, 2).cnot(2, 3)
    for q in range(4):
        prog.measure(q, ro[q])
    return prog


def _repeat_until(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 2)
    body = ir.Block().reset(0).h(0).measure(0, ro[0])
    prog.repeat_until(ro[0], body, max_iters=4)
    prog.measure(0, ro[1])
    return prog


def _classical_ops(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 4)
    prog.x(0).measure(0, ro[0])
    prog.move(ro[1], 1)        # ro1 = 1
    prog.xor(ro[1], ro[0])     # ro1 = 1 ^ 1 = 0
    prog.ior(ro[2], ro[0])     # ro2 = 0 | 1 = 1
    prog.and_(ro[2], ro[1])    # ro2 = 1 & 0 = 0
    prog.not_(ro[3])           # ro3 = 1
    return prog


def _classical_feedback(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 3)
    prog.h(0).measure(0, ro[0])
    prog.move(ro[1], ro[0])
    prog.not_(ro[1])           # ro1 = !ro0
    prog.if_then(ro[0], ir.Circuit().x(0))   # undo if measured 1
    prog.if_then(ro[1], ir.Circuit().i(0))   # no-op branch on computed bit
    prog.measure(0, ro[2])
    return prog


PROGRAMS = {
    "x": Spec(_single("X"), _const(1), source="test_ftqc.py:42"),
    "y": Spec(_single("Y"), _const(1), source="test_ftqc.py:50"),
    "z": Spec(_single("Z"), _const(0), source="test_ftqc.py:58"),
    "xxx": Spec(_single("XXX"), _const(1), source="test_ftqc.py:68"),
    "yz": Spec(_single("YZ"), _const(1), source="test_ftqc.py:76"),
    "hzh": Spec(_single("HZH"), _const(1), source="test_ftqc.py:83"),
    "s": Spec(_single("HSSH"), _const(1), source="test_ftqc.py:90"),
    "feedback": Spec(_feedback, lambda r: bool((r["ro"][:, 1] == 0).all()),
                     source="test_ftqc.py:100"),
    **{f"superdense{b0}{b1}": Spec(_superdense(b0, b1), _const(b0, b1),
                                   source="test_ftqc.py:118")
       for b0 in (0, 1) for b1 in (0, 1)},
    "ghz4": Spec(_ghz4, lambda r: bool((r["ro"] == r["ro"][:, :1]).all()),
                 options={"ancillas": "dedicated"},
                 source="test_ftqc.py:140"),
    "repeat_until": Spec(
        _repeat_until,
        lambda r: bool((r["ro"][:, 1] == r["ro"][:, 0]).all()),
        source="test_ftqc.py:359"),
    "classical_ops": Spec(_classical_ops, _const(1, 0, 0, 1),
                          source="test_ftqc.py:435"),
    "classical_feedback": Spec(
        _classical_feedback,
        lambda r: bool((r["ro"][:, 2] == 0).all()
                       and (r["ro"][:, 1] == 1 - r["ro"][:, 0]).all()),
        source="test_ftqc.py:465"),
    "ec2": Spec(_single("X"), _const(1), options={"ec_extractions": 2},
                source="test_ftqc.py:505"),
    "quil_two_entry_loop": Spec(
        lambda ir: ir.parse_quil(QUIL_TWO_ENTRY_LOOP), _const(1, 1),
        source="test_quil.py:188"),
    "surface3_x": Spec(_single("X"), _const(1), code="surface3",
                       source="test_ftqc.py:299"),
    "shor_x": Spec(_single("X"), _const(1), code="shor",
                   source="test_ftqc.py:312"),
}


def _x_cnot(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 2)
    prog.x(0).cnot(0, 1)
    prog.measure(0, ro[0]).measure(1, ro[1])
    return prog


def _pauli_feedback(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 2)
    prog.x(0).measure(0, ro[0])
    prog.if_then(ro[0], ir.Circuit().x(0))
    prog.measure(0, ro[1])
    return prog


def _repeat_until_pauli(ir):
    prog = ir.Program()
    ro = prog.declare("ro", 2)
    body = ir.Block().reset(0).x(0).measure(0, ro[0])
    prog.repeat_until(ro[0], body, max_iters=3)
    prog.measure(0, ro[1])
    return prog


# tests/test_ftqc_frames.py's deterministic set, where PROGRAMS lacks it
# (its X, Y, Z, XXX, YZ and HZH sequences are PROGRAMS' own)
FRAMES_PROGRAMS = {
    "ssx": Spec(_single("SSX"), _const(1), source="test_ftqc_frames.py:47"),
    "x_cnot": Spec(_x_cnot, _const(1, 1), source="test_ftqc_frames.py:58"),
    "pauli_feedback": Spec(_pauli_feedback, _const(1, 0),
                           source="test_ftqc_frames.py:69"),
    "repeat_until_pauli": Spec(_repeat_until_pauli, _const(1, 1),
                               source="test_ftqc_frames.py:79"),
}

# The programs of PROGRAMS and FRAMES_PROGRAMS that the JAX package refuses
# on tableau='frames' with UnsupportedProgramError: `EncodedProgram` with
# tableau='frames' (its `_validate`: a conditional or looped non-Pauli
# gate), then `schedule.reference_outcomes` on its lowering (a random
# reference outcome), from
#   for name in {**PROGRAMS, **FRAMES_PROGRAMS}:
#       prog, code = build(name, ir)   # ir: the JAX package's IR
#       enc = EncodedProgram(prog, code, tableau="frames", **options)
#       schedule.reference_outcomes(schedule.lower(prog, code), code)
# (JAX 0.9.0 on the CPU).
FRAMES_REFUSED = {
    "feedback": "deterministic",
    "ghz4": "deterministic",
    "repeat_until": "frames",
    "classical_feedback": "deterministic",
}

# The programs of PROGRAMS that the JAX package refuses on
# engine='unrolled' (`EncodedProgram(prog, code, engine="unrolled",
# **options)`: ValueError for dedicated ancillas and repeated extraction,
# UnsupportedProgramError for repeat_until), each with a part of its
# message, from
#   for name in PROGRAMS:
#       prog, code = build(name, ir)   # ir: the JAX package's IR
#       EncodedProgram(prog, code, engine="unrolled", **options)
# (JAX 0.9.0 on the CPU; tests/test_torch_ftqc_unrolled.py builds the
# reference's EncodedProgram again and holds the port's refusals to it).
UNROLLED_REFUSED = {
    "ghz4": "dedicated ancillas",
    "repeat_until": "repeat_until",
    "ec2": "repeated extraction",
    "quil_two_entry_loop": "repeat_until",
}


def build(name: str, ir=None):
    """(program, code) of ``PROGRAMS[name]`` or ``FRAMES_PROGRAMS[name]``
    built with the IR namespace ``ir`` and the code families
    ``ir.families`` (this package's by default)."""
    if ir is None:
        from qcss_tpu_torch.codes import families

        ir = _ir()
        ir.families = families
    spec = {**PROGRAMS, **FRAMES_PROGRAMS}[name]
    return spec.build(ir), CODES[spec.code](ir.families)


def x_program(ir=None):
    """The flagship X-then-measure program (the JAX package's
    benchmarks/ftqc_bench.py)."""
    return _single("X")(ir or _ir())
