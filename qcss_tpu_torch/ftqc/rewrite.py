"""The FT transpiler: rewrite a raw Clifford program into fault-tolerant
encoded form (PyTorch port of `qcss_tpu.ftqc.rewrite`, the scheduled
engine).

`rewrite_program(raw, code)` validates the program and produces an
`EncodedProgram` (reference analogue: ftqc.py:42-120). Execution follows the
reference's structure exactly:

* one code block per program qubit + two shared ancilla blocks (the
  reference shares ancillas to stay simulable on the QVM and notes the
  fault-tolerance cost — reference: ftqc.py:153-160; kept here because it
  also bounds tableau width),
* FT |0̄⟩ preparation of every block up front (reference: ftqc.py:77-78),
* a round of Steane error correction on EVERY block after each logical gate
  (reference: ftqc.py:86),
* FT measurement with error correction interleaved between the 2t+1 trials
  (reference: ftqc.py:91-95),
* structured `if_then` feedback executed as masked gate application — the
  reference routes this through Quil jump instructions with mangled labels
  (reference: ftqc.py:98-103).

The scheduled engine (the default) runs the program as the macro-op rows
of `ftqc.schedule`, batched over the shots on the card (``device="cuda"``,
the default) or on the CPU, on the 'unpacked', 'packed' or 'frames'
engine, with Steane or (on 'frames') flag EC; for 'frames' the reference
outcomes are recorded once (`schedule.reference_outcomes`), which refuses a
program whose measured blocks are not in definite Z̄ eigenstates. The
unrolled engine (``engine='unrolled'``) walks the program's instructions
on the host and calls the protocols of `ftqc.executor.FTProtocols` one by
one; both engines run the same executor bodies.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.circuits.ir import (
    BitRef,
    ClassicalInst,
    DeclareInst,
    PragmaInst,
    GateInst,
    GuardedInst,
    IfThenInst,
    MeasureInst,
    Program,
    RepeatUntilInst,
    ResetInst,
)
from qcss_tpu_torch.errors import (
    UnsupportedGateError,
    UnsupportedProgramError,
    UnsupportedQECCError,
)
from qcss_tpu_torch.ftqc.executor import ExecState, FTProtocols
from qcss_tpu_torch.sim import noise as noise_mod


class EncodedProgram:
    """A validated FT-encoded program, executable over a batch of shots."""

    #: the constructor's settings between ``code`` and ``device``, in its
    #: order: `on` builds a program from them
    SETTINGS = ("noise", "max_prep_attempts", "engine", "tableau",
                "ancillas", "ec_extractions", "ec_schedule", "ec_mode")

    def __init__(self, raw: Program, code, noise: noise_mod.NoiseModel | None = None,
                 max_prep_attempts: int = 8, engine: str = "scheduled",
                 tableau: str = "unpacked", ancillas: str = "shared",
                 ec_extractions: int = 1, ec_schedule: str = "serial",
                 ec_mode: str = "steane", device="cuda"):
        if code.k != 1:
            raise UnsupportedQECCError("code must have k = 1")
        if engine not in ("scheduled", "unrolled"):
            raise ValueError("engine must be 'scheduled' or 'unrolled'")
        if tableau not in ("unpacked", "packed", "frames"):
            raise ValueError("tableau must be 'unpacked', 'packed' or 'frames'")
        if engine == "unrolled" and tableau != "unpacked":
            raise ValueError(f"the {tableau} engine requires the scheduled engine")
        if ancillas not in ("shared", "dedicated"):
            raise ValueError("ancillas must be 'shared' or 'dedicated'")
        if engine == "unrolled" and ancillas == "dedicated":
            raise ValueError("dedicated ancillas require the scheduled engine")
        if engine == "unrolled" and ec_extractions != 1:
            raise ValueError("repeated extraction requires the scheduled engine")
        if ec_schedule == "parallel" and engine == "unrolled":
            raise ValueError("parallel EC requires the scheduled engine")
        if ec_schedule == "parallel" and ancillas != "dedicated":
            raise ValueError("ec_schedule='parallel' requires "
                             "ancillas='dedicated'")
        if ec_schedule == "parallel" and tableau != "frames":
            raise ValueError("ec_schedule='parallel' requires "
                             "tableau='frames'")
        if ec_mode not in ("steane", "flag"):
            raise ValueError("ec_mode must be 'steane' or 'flag'")
        if ec_mode == "flag":
            if engine != "scheduled":
                raise ValueError("ec_mode='flag' requires the scheduled engine")
            if tableau != "frames":
                raise ValueError("ec_mode='flag' requires tableau='frames'")
            if ec_extractions != 1:
                raise ValueError("ec_mode='flag' has its own adaptive "
                                 "re-extraction; use ec_extractions=1")
            if ec_schedule != "serial":
                raise ValueError("ec_mode='flag' requires ec_schedule='serial'")
        self.ec_mode = ec_mode
        self.raw = raw
        self.code = code
        self.noise = noise or noise_mod.NoiseModel()
        self.engine = engine
        self.tableau = tableau
        self.ancillas = ancillas
        self.ec_extractions = ec_extractions
        self.ec_schedule = ec_schedule
        self.max_prep_attempts = max_prep_attempts
        self.qubit_map = {q: i for i, q in enumerate(raw.qubits())}
        self.n_logical = len(self.qubit_map)
        self.memory = dict(raw.memory)
        self._scheduled = None  # (macro, executor, ref_outs), built once
        self._validate()
        self.device = _cuda.resolve_device(device)
        # Blocks: one per logical qubit, then two shared EC/measure
        # ancillas (the unrolled engine's protocols, built once).
        self.protocols = (
            FTProtocols(code, self.n_logical + 2, self.noise,
                        max_prep_attempts, device=self.device)
            if engine == "unrolled" else None)

    def on(self, device) -> "EncodedProgram":
        """The same program (source, code and `SETTINGS`) built to run on
        ``device``: a new program, whatever device ``self`` runs on."""
        return type(self)(self.raw, self.code,
                          *(getattr(self, k) for k in self.SETTINGS),
                          device=device)

    def _validate(self):
        code = self.code

        def check_gate(name: str, kind: str):
            if name not in ("I", "X", "Y", "Z") and not code.is_transversal(name):
                raise UnsupportedGateError(
                    f"{kind} logical gate {name} not implemented for this code"
                )

        def check_frame_body(g: GateInst, kind: str):
            # Frame-engine soundness: per-sample conditional NON-Pauli
            # gates would make the reference trajectory sample-dependent,
            # invalidating the recorded reference outcomes. Conditional
            # Paulis ride the frame exactly, so they are fine.
            if self.tableau == "frames" and g.name not in ("I", "X", "Y", "Z"):
                raise UnsupportedProgramError(
                    f"{kind} non-Pauli gate {g.name} is not supported by "
                    "the 'frames' engine (sample-dependent reference); use "
                    "a tableau engine"
                )

        def check_guarded(g, kind: str):
            if self.engine != "scheduled":
                raise UnsupportedProgramError(
                    "guarded instructions require the scheduled engine")
            if isinstance(g.inner, GateInst):
                check_gate(g.inner.name, kind)
                check_frame_body(g.inner, kind)

        for inst in self.raw.instructions:
            if isinstance(inst, GateInst):
                check_gate(inst.name, "")
            elif isinstance(inst, IfThenInst):
                for g in inst.body:
                    check_gate(g.name, "conditional")
                    check_frame_body(g, "conditional")
            elif isinstance(inst, GuardedInst):
                check_guarded(inst, "guarded")
            elif isinstance(inst, RepeatUntilInst):
                if self.engine != "scheduled":
                    raise UnsupportedProgramError(
                        "repeat_until requires the scheduled engine"
                    )
                for b in inst.body:
                    if isinstance(b, GateInst):
                        check_gate(b.name, "looped")
                        check_frame_body(b, "looped")
                    elif isinstance(b, GuardedInst):
                        check_guarded(b, "looped guarded")
            elif isinstance(inst, (MeasureInst, ResetInst, DeclareInst,
                                   ClassicalInst, PragmaInst)):
                continue
            else:
                raise UnsupportedProgramError(f"unsupported instruction: {inst}")

    # -- execution ---------------------------------------------------------------

    def _blocks(self):
        p = self.protocols
        data = [p.block(i) for i in range(self.n_logical)]
        anc1 = p.block(self.n_logical)
        anc2 = p.block(self.n_logical + 1)
        return data, anc1, anc2

    def _execute(self, batch: int, seed: int,
                 generator: torch.Generator | None
                 ) -> tuple[dict[str, torch.Tensor], ExecState]:
        """The unrolled engine: the program's instructions walked on the
        host, each one a call of the protocols (reference:
        ftqc.py:42-120). Returns the registers (``"__prep_fail__"``
        included) and the final state."""
        p = self.protocols
        data, anc1, anc2 = self._blocks()
        st = p.init_state(batch, seed, generator=generator)
        mem = {
            name: torch.zeros((batch, size), dtype=torch.uint8,
                              device=self.device)
            for name, size in self.memory.items()
        }

        def ec_all(s: ExecState) -> ExecState:
            for block in data:
                s = p.error_correct(s, block, anc1, anc2)
            return s

        def set_bit(ref, value):
            reg = mem[ref.name].clone()
            reg[:, ref.index] = value
            mem[ref.name] = reg

        # FT-prepare every logical block in |0̄⟩ (reference: ftqc.py:77-78).
        for block in data:
            st = p.encode_zero(st, block, anc1)

        for inst in self.raw.instructions:
            if isinstance(inst, (DeclareInst, PragmaInst)):
                continue
            if isinstance(inst, GateInst):
                blocks = [data[self.qubit_map[q]] for q in inst.qubits]
                st = p.apply_logical_gate(st, inst.name, blocks)
                st = ec_all(st)
            elif isinstance(inst, IfThenInst):
                # the gate is masked; its EC round runs on every shot, as
                # the reference's unrolled engine runs it
                mask = mem[inst.condition.name][:, inst.condition.index]
                for g in inst.body:
                    blocks = [data[self.qubit_map[q]] for q in g.qubits]
                    st = p.apply_logical_gate(st, g.name, blocks, mask=mask)
                    st = ec_all(st)
            elif isinstance(inst, MeasureInst):
                block = data[self.qubit_map[inst.qubit]]
                st, outcome = p.measure(st, block, anc1, anc2,
                                        ec_between=ec_all)
                set_bit(inst.target, outcome)
            elif isinstance(inst, ClassicalInst):
                # Pass-through of user classical instructions
                # (reference: ftqc.py:111-116) as memory arithmetic.
                cur = mem[inst.dst.name][:, inst.dst.index]
                if isinstance(inst.src, BitRef):
                    src = mem[inst.src.name][:, inst.src.index]
                elif inst.src is None:
                    src = None
                else:
                    src = torch.full_like(cur, int(inst.src))
                new = {
                    "MOVE": lambda: src,
                    "NOT": lambda: 1 ^ cur,
                    "AND": lambda: cur & src,
                    "IOR": lambda: cur | src,
                    "XOR": lambda: cur ^ src,
                }[inst.op]()
                set_bit(inst.dst, new)
            elif isinstance(inst, ResetInst):
                block = data[self.qubit_map[inst.qubit]]
                st = p.encode_zero(st, block, anc1)
            else:  # pragma: no cover - validated away
                raise UnsupportedProgramError(str(inst))
        mem["__prep_fail__"] = st.prep_fail[:, None]
        return mem, st

    def _prepare_scheduled(self):
        """Lower once, build the executor and (for the 'frames' engine)
        record the reference measurement outcomes."""
        if self._scheduled is None:
            from qcss_tpu_torch.ftqc import schedule

            macro = schedule.lower(self.raw, self.code)
            executor = schedule.MacroExecutor(
                self.code, self.n_logical, self.noise, self.max_prep_attempts,
                tableau_engine=self.tableau, ancillas=self.ancillas,
                ec_extractions=self.ec_extractions,
                ec_schedule=self.ec_schedule,
                ec_mode=self.ec_mode,
                device=self.device,
            )
            ref_outs = (
                schedule.reference_outcomes(macro, self.code,
                                            device=self.device)
                if self.tableau == "frames" else None
            )
            self._scheduled = (macro, executor, ref_outs)
        return self._scheduled

    def run(self, batch: int, seed: int = 0, *,
            generator: torch.Generator | None = None) -> dict[str, np.ndarray]:
        """Execute `batch` shots; returns classical registers as numpy
        arrays [batch, size] — the analogue of the reference's
        ``qvm.run(prog)`` result matrix (reference: test/test_ftqc.py:153-156).
        Randomness comes from ``generator`` when given, else from ``seed``
        (`schedule.MacroExecutor` seeds one generator a sub-operation; the
        two engines split alike).

        The reserved register ``"__prep_fail__"`` ([batch, 1] uint8) flags
        samples where some FT preparation exhausted ``max_prep_attempts``
        without passing verification; callers can discard those shots or
        bound the unverified fraction."""
        if self.engine == "unrolled":
            out, _ = self._execute(batch, seed, generator)
            return {name: v.cpu().numpy() for name, v in out.items()}
        macro, executor, ref_outs = self._prepare_scheduled()
        st = executor.execute(macro, batch, seed=seed, generator=generator,
                              ref_outs=ref_outs)
        memory = st.memory.cpu().numpy()
        out = {
            name: memory[:, off:off + size]
            for name, (off, size) in macro.memory_layout.items()
        }
        out["__prep_fail__"] = st.prep_fail.cpu().numpy()[:, None]
        return out


def rewrite_program(raw: Program, code, *,
                    noise: noise_mod.NoiseModel | None = None,
                    max_prep_attempts: int = 8,
                    engine: str = "scheduled",
                    tableau: str = "unpacked",
                    ancillas: str = "shared",
                    ec_extractions: int = 1,
                    ec_schedule: str = "serial",
                    ec_mode: str = "steane",
                    device="cuda") -> EncodedProgram:
    """Validate and FT-encode a raw Clifford program — the framework's
    flagship entry point (reference analogue: ftqc.py:42).

    engine: 'scheduled' (macro-op rows; `ftqc.schedule`) or 'unrolled'
    (the program's instructions walked on the host over `FTProtocols`;
    'unpacked' tableau, shared ancillas, one extraction, serial Steane EC,
    no repeat_until or guarded instructions).
    tableau: 'unpacked' (byte-per-bit, best for small codes), 'packed'
    (32-bit words, word-aligned blocks, block measurements on K9 on the
    card; best for surface-code-scale blocks) or 'frames' (Pauli frames
    plus reference outcomes recorded once: the Monte-Carlo fast path,
    bit-identical to 'unpacked' on one seed; every measured block must be
    in a definite Z̄ eigenstate, and conditional gates must be Paulis).
    ancillas: 'shared' (one EC/measure ancilla pair for all blocks — the
    reference's QVM-ceiling compromise, reference: ftqc.py:153-160) or
    'dedicated' (an ancilla pair per logical block; statistically identical
    under this noise model, structurally ceiling-free).
    ec_extractions: 1 (single noisy extraction per EC sector, the
    reference's scheme) or 2 (Shor-style repeated extraction: a correction
    commits only when both syndromes agree).
    ec_schedule: 'serial' (one block's Steane round at a time, the
    reference's shared-scratch structure — ftqc.py:153-171) or 'parallel'
    (every block's round simultaneously; requires ancillas='dedicated' and
    tableau='frames'; under idle noise this removes the n_logical-fold
    idle exposure the serial schedule charges to waiting blocks).
    ec_mode: 'steane' (encoded-ancilla transversal extraction, the
    reference's protocol — css_code.py:436-470) or 'flag' (bare
    ancilla+flag qubit per stabilizer, sequential CNOTs, adaptive
    re-extraction with flag-conditioned hook decoding — Chao-Reichardt/
    Chamberland-Beverland; t=1 codes, frames engine; 2 bare ancillas
    replace the 2n-qubit verified ancilla blocks per EC extraction).
    device: where the shots run ("cuda" by default; "cpu" runs the plain
    PyTorch versions).
    """
    return EncodedProgram(raw, code, noise, max_prep_attempts, engine,
                          tableau, ancillas, ec_extractions, ec_schedule,
                          ec_mode, device)


def run_program(raw: Program, code, batch: int = 1, *,
                seed: int = 0,
                generator: torch.Generator | None = None,
                noise: noise_mod.NoiseModel | None = None,
                device="cuda") -> dict[str, np.ndarray]:
    """Convenience: rewrite then run."""
    return rewrite_program(raw, code, noise=noise, device=device).run(
        batch, seed, generator=generator)
