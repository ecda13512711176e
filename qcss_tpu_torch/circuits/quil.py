"""Quil text front-end: run reference-ecosystem programs unmodified.

The reference's input language is a pyQuil ``Program`` fed to its
transpiler (reference: ftqc.py:42-120); this framework's native input is
`circuits.ir.Program`. This module parses the Quil subset those programs
actually use — Clifford gates, DECLARE/MEASURE/RESET, classical bit ops,
and ARBITRARY ``JUMP``/``JUMP-WHEN``/``JUMP-UNLESS``/``LABEL`` control
flow — into the IR, so a reference user can paste their Quil source and
run it FT-encoded on the device.

Control flow is STRUCTURED rather than translated jump-for-jump (the
reference mangles labels and keeps the gotos — ftqc.py:98-107,147-151; a
traced batched executor needs reducible control flow). Two tiers:

1. Pattern-matched idioms (preferred — emits the tight native forms):

   * ``JUMP-WHEN @THEN c`` / ``JUMP @END`` / ``LABEL @THEN`` / body /
     ``LABEL @END``  →  ``if_then(c, body)``   (pyQuil's if_then shape)
   * ``JUMP-UNLESS @SKIP c`` / body / ``LABEL @SKIP``  →  ``if_then``
   * ``LABEL @S`` / ``JUMP-WHEN @E c`` / body / ``JUMP @S`` / ``LABEL @E``
     →  ``repeat_until(c, body)``              (loop while c == 0)
   * the ``JUMP-UNLESS`` loop head (loop while c == 1) lowers via a
     synthesized negation register kept in sync per iteration.

2. General CFG dispatch (fallback — ANY jump topology, including
   irreducible gotos, computed-looking chains, nested loops): the program
   is split into basic blocks; each block's instructions are emitted as
   per-sample `GuardedInst`s over one-hot block-activity bits
   (``__cf_at``); branch terminators move the activity bit; a bounded
   ``repeat_until`` dispatch loop re-runs the guarded pass until every
   sample reaches the exit block. A pass executes every forward chain to
   completion (blocks are emitted in program order, so a jump to a LATER
   block fires within the same pass); each back-edge traversal anywhere
   in the program costs one pass, so in this tier ``max_loop_iters``
   bounds the TOTAL number of back-edge traversals — nested or
   sequential loops share one global budget, unlike tier 1 where each
   ``repeat_until`` gets its own. Programs whose combined iteration
   count approaches the bound truncate differently across tiers; raise
   ``max_loop_iters`` accordingly for multi-loop goto programs. This is
   the batched-traced equivalent of the
   reference's mangled-label jump pass-through (ftqc.py:98-103,147-151):
   every jump topology a Quil program can express runs.

Semantic deltas vs a real Quil machine, all documented limits of the
traced substrate: loops are bounded by ``max_loop_iters`` (the IR's
`RepeatUntilInst` contract), and in tier 1 the loop condition is
re-checked before every body instruction rather than only at the head
(per-sample masking; indistinguishable for bodies that set their flag
last, which is every repeat-until-success protocol in the reference).

Unsupported constructs (DEFGATE, jumps to undefined labels,
non-Clifford gates) raise ``UnsupportedProgramError`` with the
offending line. Non-BIT/INTEGER DECLAREs (REAL, OCTET, ...) are carried
through as PRAGMA annotations exactly like the reference transpiler's
untouched Declare pass-through (reference: ftqc.py:111-116); only a
*use* of such a register errors.
"""

from __future__ import annotations

import math
import re

from qcss_tpu_torch.circuits.ir import (
    BitRef,
    Block,
    Circuit,
    ClassicalInst,
    Program,
)
from qcss_tpu_torch.errors import UnsupportedProgramError

_GATES_1Q = {"I", "X", "Y", "Z", "H", "S"}
_GATES_2Q = {"CNOT", "CZ"}

_PHASE_RE = re.compile(r"^PHASE\((?P<arg>[^)]+)\)$")

_JUMP_KINDS = ("JUMP", "JUMP-WHEN", "JUMP-UNLESS")


def _phase_angle(expr: str) -> float:
    """Evaluate the tiny arithmetic grammar pyQuil prints for angles
    (numbers, pi, * / + - and unary minus)."""
    expr = expr.strip().lower().replace("pi", repr(math.pi))
    if not re.fullmatch(r"[0-9eE().+\-*/ ]+", expr):
        raise UnsupportedProgramError(f"unsupported PHASE angle {expr!r}")
    try:
        return float(eval(expr, {"__builtins__": {}}, {}))  # noqa: S307
    except Exception as exc:  # pragma: no cover
        raise UnsupportedProgramError(
            f"cannot evaluate PHASE angle {expr!r}") from exc


class _Atom:
    __slots__ = ("kind", "args", "line")

    def __init__(self, kind, args, line):
        self.kind = kind
        self.args = args
        self.line = line

    def __repr__(self):  # pragma: no cover
        return f"_Atom({self.kind}, {self.args})"


def _tokenize(text: str) -> list[_Atom]:
    atoms: list[_Atom] = []
    for lineno, raw_line in enumerate(text.splitlines(), 1):
        line = raw_line.split("#", 1)[0].strip()
        if not line or line == "NOP":
            continue
        parts = line.split()
        head = parts[0].upper()
        atoms.append(_Atom(head, parts[1:], f"line {lineno}: {raw_line.strip()}"))
    return atoms


def _bit_ref(prog: Program, regs: dict, token: str, line: str):
    m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", token)
    if not m:
        raise UnsupportedProgramError(f"bad memory reference at {line}")
    name, idx = m.group(1), int(m.group(2) or 0)
    if name not in regs:
        raise UnsupportedProgramError(f"undeclared register {name!r} at {line}")
    return regs[name][idx]


def _hoist(atoms: list[_Atom], prog: Program) -> tuple[list[_Atom], dict]:
    """Process DECLARE (hoisted — Quil semantics) and PRAGMA; return the
    remaining executable atoms (HALT included: it is a real terminator in
    goto programs) and the register map."""
    regs: dict[str, list] = {}
    rest: list[_Atom] = []
    for a in atoms:
        if a.kind == "DECLARE":
            if len(a.args) < 2:
                raise UnsupportedProgramError(f"bad DECLARE at {a.line}")
            name = a.args[0]
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", a.args[1])
            if not m:
                raise UnsupportedProgramError(f"bad DECLARE at {a.line}")
            if m.group(1) in ("BIT", "INTEGER"):
                size = int(m.group(2) or 1)
                regs[name] = prog.declare(name, size)
            else:
                # REAL/OCTET etc.: carried as an annotation, matching the
                # reference transpiler's untouched Declare pass-through
                # (reference: ftqc.py:111-116). No instruction in the
                # supported subset can read or write non-bit memory, so
                # any USE of the register still errors as undeclared.
                prog.pragma("DECLARED", name, m.group(1),
                            int(m.group(2) or 1))
        elif a.kind == "PRAGMA":
            prog.pragma(*a.args)
        else:
            rest.append(a)
    return rest, regs


def _make_emitters(prog: Program, regs: dict):
    """Shared atom → IR emitters closing over the program's registers."""

    def emit_gate(sink, a: _Atom):
        head = a.kind
        m = _PHASE_RE.fullmatch(head)
        if m is not None:
            ang = _phase_angle(m.group("arg"))
            if not math.isclose(ang % (2 * math.pi), math.pi / 2,
                                abs_tol=1e-9):
                raise UnsupportedProgramError(
                    f"PHASE supported only at pi/2 (= S), at {a.line}")
            head = "S"
        if head in _GATES_1Q:
            if len(a.args) != 1:
                raise UnsupportedProgramError(f"bad gate arity at {a.line}")
            sink.gate(head, int(a.args[0]))
        elif head in _GATES_2Q:
            if len(a.args) != 2:
                raise UnsupportedProgramError(f"bad gate arity at {a.line}")
            sink.gate(head, int(a.args[0]), int(a.args[1]))
        else:
            raise UnsupportedProgramError(
                f"unsupported instruction at {a.line} (Clifford subset: "
                f"{sorted(_GATES_1Q | _GATES_2Q)}, PHASE(pi/2))")

    def emit_plain(sink, a: _Atom):
        k = a.kind
        if k == "MEASURE":
            if len(a.args) != 2:
                raise UnsupportedProgramError(
                    f"MEASURE needs a target register, at {a.line}")
            sink.measure(int(a.args[0]), _bit_ref(prog, regs, a.args[1], a.line))
        elif k == "RESET":
            if len(a.args) != 1:
                raise UnsupportedProgramError(
                    f"global RESET is unsupported, at {a.line}")
            sink.reset(int(a.args[0]))
        elif k in ("MOVE", "NOT", "AND", "IOR", "XOR"):
            dst = _bit_ref(prog, regs, a.args[0], a.line)
            if k == "NOT":
                sink.not_(dst)
            else:
                src_tok = a.args[1]
                src = (int(src_tok) if re.fullmatch(r"[01]", src_tok)
                       else _bit_ref(prog, regs, src_tok, a.line))
                getattr(sink, {"MOVE": "move", "AND": "and_", "IOR": "ior",
                               "XOR": "xor"}[k])(dst, src)
        elif k == "DEFGATE":
            raise UnsupportedProgramError(f"DEFGATE is unsupported ({a.line})")
        else:
            emit_gate(sink, a)

    return emit_gate, emit_plain


def _parse_structured(atoms: list[_Atom], max_loop_iters: int) -> Program:
    """Tier 1: pattern-match pyQuil's structured jump idioms (see module
    docstring); raises UnsupportedProgramError on any out-of-idiom jump,
    which `parse_quil` catches to fall back to the CFG dispatch tier."""
    prog = Program()
    rest, regs = _hoist(atoms, prog)
    neg_count = [0]
    emit_gate, emit_plain = _make_emitters(prog, regs)

    def find_label(seq, name, start):
        name = name.lstrip("@")
        for j in range(start, len(seq)):
            if seq[j].kind == "LABEL" and seq[j].args[0].lstrip("@") == name:
                return j
        return -1

    def build(seq: list[_Atom], sink, depth: int):
        i = 0
        while i < len(seq):
            a = seq[i]
            if a.kind == "HALT":
                if i == len(seq) - 1:
                    i += 1
                    continue
                raise UnsupportedProgramError(
                    f"mid-program HALT is out of idiom ({a.line})")
            if a.kind == "LABEL":
                # loop head?  LABEL @S ; JUMP-WHEN/UNLESS @E c ; body ;
                # JUMP @S ; LABEL @E
                s_name = a.args[0].lstrip("@")
                if (i + 1 < len(seq)
                        and seq[i + 1].kind in ("JUMP-WHEN", "JUMP-UNLESS")):
                    e_name = seq[i + 1].args[0].lstrip("@")
                    # find the back jump
                    back = next(
                        (j for j in range(i + 2, len(seq))
                         if seq[j].kind == "JUMP"
                         and seq[j].args[0].lstrip("@") == s_name), -1)
                    end = find_label(seq, e_name, i + 2)
                    if back >= 0 and end == back + 1:
                        if depth > 0:
                            raise UnsupportedProgramError(
                                f"nested loops are out of idiom ({a.line})")
                        cond = _bit_ref(prog, regs, seq[i + 1].args[1], a.line)
                        body_atoms = seq[i + 2:back]
                        blk = Block()
                        for b_at in body_atoms:
                            if b_at.kind in ("LABEL", "JUMP", "JUMP-WHEN",
                                             "JUMP-UNLESS", "HALT"):
                                raise UnsupportedProgramError(
                                    "control flow inside a loop body is "
                                    f"out of idiom ({b_at.line})")
                            emit_plain(blk, b_at)
                        if seq[i + 1].kind == "JUMP-WHEN":
                            # exits when c == 1: the IR's native form
                            prog.repeat_until(cond, blk, max_loop_iters)
                        else:
                            # exits when c == 0 (pyQuil while_do): loop on
                            # a synthesized negation kept fresh per
                            # iteration
                            neg_count[0] += 1
                            aux = prog.declare(
                                f"__quil_neg_{neg_count[0]}", 1)[0]
                            prog.move(aux, cond).not_(aux)
                            blk.move(aux, cond).not_(aux)
                            prog.repeat_until(aux, blk, max_loop_iters)
                        i = end + 1
                        continue
                i += 1  # plain label (jump target of a structured idiom)
                continue
            if a.kind == "JUMP-WHEN":
                tgt = a.args[0].lstrip("@")
                cond = _bit_ref(prog, regs, a.args[1], a.line)
                # pyQuil if_then: JUMP-WHEN @THEN c ; JUMP @END ;
                # LABEL @THEN ; body ; LABEL @END
                if (i + 2 < len(seq) and seq[i + 1].kind == "JUMP"
                        and seq[i + 2].kind == "LABEL"
                        and seq[i + 2].args[0].lstrip("@") == tgt):
                    e_name = seq[i + 1].args[0]
                    end = find_label(seq, e_name, i + 3)
                    if end < 0:
                        raise UnsupportedProgramError(
                            f"unmatched {e_name} ({a.line})")
                    body = Circuit()
                    for b_at in seq[i + 3:end]:
                        emit_gate(body, b_at)
                    prog.if_then(cond, body)
                    i = end + 1
                    continue
                raise UnsupportedProgramError(
                    f"out-of-idiom JUMP-WHEN ({a.line})")
            if a.kind == "JUMP-UNLESS":
                # JUMP-UNLESS @SKIP c ; body ; LABEL @SKIP  =>  if c: body
                tgt = a.args[0].lstrip("@")
                end = find_label(seq, tgt, i + 1)
                if end < 0:
                    raise UnsupportedProgramError(
                        f"unmatched @{tgt} ({a.line})")
                cond = _bit_ref(prog, regs, a.args[1], a.line)
                body = Circuit()
                for b_at in seq[i + 1:end]:
                    emit_gate(body, b_at)
                prog.if_then(cond, body)
                i = end + 1
                continue
            if a.kind == "JUMP":
                raise UnsupportedProgramError(
                    f"out-of-idiom JUMP ({a.line})")
            emit_plain(sink, a)
            i += 1

    build(rest, prog, 0)
    return prog


def _parse_dispatch(atoms: list[_Atom], max_loop_iters: int) -> Program:
    """Tier 2: general CFG structurizer — PC-dispatch over basic blocks
    (see module docstring). Handles any jump topology the reference's
    mangled-label pass-through accepts (reference: ftqc.py:98-103)."""
    prog = Program()
    rest, regs = _hoist(atoms, prog)
    _, emit_plain = _make_emitters(prog, regs)

    # -- split into basic blocks ------------------------------------------
    # A block: (names, insts, term). term is ('fall',), ('halt',),
    # ('jump', label), or ('when'/'unless', cond_token, label, line).
    blocks: list[dict] = [{"names": [], "insts": [], "term": None}]
    label_of: dict[str, int] = {}

    def new_block():
        blocks.append({"names": [], "insts": [], "term": None})

    for a in rest:
        cur = blocks[-1]
        if a.kind == "LABEL":
            name = a.args[0].lstrip("@")
            if cur["insts"]:  # consecutive labels share one block
                cur["term"] = ("fall",)
                new_block()
            blocks[-1]["names"].append(name)
            if name in label_of:
                raise UnsupportedProgramError(
                    f"duplicate label @{name} ({a.line})")
            label_of[name] = len(blocks) - 1
        elif a.kind == "JUMP":
            cur["term"] = ("jump", a.args[0].lstrip("@"), a.line)
            new_block()
        elif a.kind in ("JUMP-WHEN", "JUMP-UNLESS"):
            kind = "when" if a.kind == "JUMP-WHEN" else "unless"
            cur["term"] = (kind, a.args[1], a.args[0].lstrip("@"), a.line)
            new_block()
        elif a.kind == "HALT":
            cur["term"] = ("halt",)
            new_block()
        else:
            if cur["term"] is not None:  # pragma: no cover — new_block above
                new_block()
            blocks[-1]["insts"].append(a)
    if blocks[-1]["term"] is None:
        blocks[-1]["term"] = ("fall",)
    # Drop a trailing empty unlabelled block (artifact of a final jump).
    if (len(blocks) > 1 and not blocks[-1]["insts"]
            and not blocks[-1]["names"] and blocks[-1]["term"] == ("fall",)):
        blocks.pop()

    nb = len(blocks)
    EXIT = nb

    def resolve(label: str, line: str) -> int:
        if label not in label_of:
            raise UnsupportedProgramError(f"jump to undefined label "
                                          f"@{label} ({line})")
        return label_of[label]

    # -- emit the dispatch program ----------------------------------------
    def fresh(base: str) -> str:
        name, i = base, 0
        while name in prog.memory:
            i += 1
            name = f"{base}_{i}"
        return name

    at = prog.declare(fresh("__cf_at"), nb + 1)    # one-hot activity bits
    g = prog.declare(fresh("__cf_g"), nb + 1)      # pass-scoped guards
    done = prog.declare(fresh("__cf_done"), 1)[0]
    prog.move(at[0], 1)

    body = Block()
    for k, blk in enumerate(blocks):
        gk = g[k]
        # Snapshot the activity bit: the terminator clears at[k] (and may
        # re-set it for a later pass), so the block's own guard must be a
        # pass-scoped copy. Masked by loop-activity; the scheduler's
        # guard∧active lowering (schedule.lower emit_guarded) keeps a
        # stale snapshot from firing ops after a sample exits.
        body.move(gk, at[k])
        for a in blk["insts"]:
            tmp = Block()
            emit_plain(tmp, a)
            for inner in tmp.instructions:
                body.guarded(gk, inner)
        body.guarded(gk, ClassicalInst("MOVE", at[k], 0))
        term = blk["term"]
        if term[0] == "halt":
            body.guarded(gk, ClassicalInst("MOVE", at[EXIT], 1))
        elif term[0] == "fall":
            nxt = k + 1 if k + 1 < nb else EXIT
            body.guarded(gk, ClassicalInst("MOVE", at[nxt], 1))
        elif term[0] == "jump":
            body.guarded(gk, ClassicalInst("MOVE", at[resolve(term[1],
                                                              term[2])], 1))
        else:  # conditional: ('when'/'unless', cond_token, label, line)
            kind, cond_tok, label, line = term
            t = resolve(label, line)
            f = k + 1 if k + 1 < nb else EXIT
            cond = _bit_ref(prog, regs, cond_tok, line)
            if t == f:
                body.guarded(gk, ClassicalInst("MOVE", at[t], 1))
            elif kind == "when":   # taken iff cond == 1
                body.guarded(gk, ClassicalInst("MOVE", at[t], cond))
                body.guarded(gk, ClassicalInst("MOVE", at[f], cond))
                body.guarded(gk, ClassicalInst("NOT", at[f]))
            else:                  # unless: taken iff cond == 0
                body.guarded(gk, ClassicalInst("MOVE", at[t], cond))
                body.guarded(gk, ClassicalInst("NOT", at[t]))
                body.guarded(gk, ClassicalInst("MOVE", at[f], cond))
    # Exit block: swallow the activity bit and flag termination.
    body.move(g[EXIT], at[EXIT])
    body.guarded(g[EXIT], ClassicalInst("MOVE", at[EXIT], 0))
    body.guarded(g[EXIT], ClassicalInst("MOVE", done, 1))

    prog.repeat_until(done, body, max_loop_iters)
    return prog


def parse_quil(text: str, *, max_loop_iters: int = 8) -> Program:
    """Parse Quil source into a `circuits.ir.Program` (see module
    docstring): structured jump idioms when they match, general CFG
    dispatch for any other jump topology."""
    atoms = _tokenize(text)
    try:
        return _parse_structured(atoms, max_loop_iters)
    except UnsupportedProgramError as exc:
        if not any(a.kind in _JUMP_KINDS or a.kind in ("LABEL", "HALT")
                   for a in atoms):
            raise
        try:
            return _parse_dispatch(atoms, max_loop_iters)
        except UnsupportedProgramError:
            raise
        except Exception:  # pragma: no cover — surface the first error
            raise exc


def loads(text: str, **kwargs) -> Program:
    """Alias for `parse_quil`."""
    return parse_quil(text, **kwargs)
