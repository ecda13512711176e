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

The program runs as the macro-op rows of `ftqc.schedule`, batched over the
shots on the card (``device="cuda"``, the default) or on the CPU, on the
'unpacked', 'packed' or 'frames' engine; for 'frames' the reference
outcomes are recorded once (`schedule.reference_outcomes`), which refuses a
program whose measured blocks are not in definite Z̄ eigenstates. The
unrolled engine (``engine='unrolled'``) and flag EC (``ec_mode='flag'``)
are not ported yet (ROADMAP.md, queue 1); they raise `NotImplementedError`
after the reference's validation.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.circuits.ir import (
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
from qcss_tpu_torch.sim import noise as noise_mod

_NOT_PORTED = ("is not ported yet (ROADMAP.md, queue 1: the unrolled "
               "engine is item 3 (c), flag EC item 4)")


class EncodedProgram:
    """A validated FT-encoded program, executable over a batch of shots."""

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
        if engine == "unrolled":
            raise NotImplementedError(f"engine='unrolled' {_NOT_PORTED}")
        if ec_mode == "flag":
            raise NotImplementedError(f"ec_mode='flag' {_NOT_PORTED}")
        self.device = _cuda.resolve_device(device)

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
        (`schedule.MacroExecutor` seeds one generator a sub-operation).

        The reserved register ``"__prep_fail__"`` ([batch, 1] uint8) flags
        samples where some FT preparation exhausted ``max_prep_attempts``
        without passing verification; callers can discard those shots or
        bound the unverified fraction."""
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

    engine: 'scheduled' (macro-op rows; `ftqc.schedule`). 'unrolled' is
    validated as in the reference but not ported yet.
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
    reference's protocol — css_code.py:436-470); 'flag' is validated as
    in the reference but not ported yet.
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
