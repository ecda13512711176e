"""Reference-style FT protocol interface over the macro executor (PyTorch
port of `qcss_tpu.ftqc.executor`).

`FTProtocols` exposes the reference's protocol surface — FT |0̄⟩/|+̄⟩
preparation, Steane error correction, noisy and 2t+1 majority-vote logical
measurement, logical gate application (reference: css_code.py:314-646) —
as explicit methods over named `CodeBlock`s. It is a thin adapter over
`qcss_tpu_torch.ftqc.schedule.MacroExecutor`, which holds the single
implementation of every protocol; this class exists for the unrolled
execution engine and for tests/notebooks that drive protocols step by step.

The state is `ExecState` (= `schedule.MachineState`): batched tableau +
per-block known-error Pauli frames — the reference's corrections-never-
touch-qubits design (reference: qecc.py:14-31) as [B, blocks, n] bit
tensors — plus the vote/memory buffers the macro engine uses. Where the
JAX package threads a key through the state, the executor keeps a split
counter: `init_state` restarts it from ``seed`` (or one draw from
``generator``) exactly as `MacroExecutor.initial_state` does, so every
sub-operation draws from the same generator in both engines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from qcss_tpu_torch.errors import UnsupportedGateError
from qcss_tpu_torch.ftqc.schedule import GATE_IDS, MachineState, MacroExecutor
from qcss_tpu_torch.sim import noise as noise_mod

# The execution state; see schedule.MachineState.
ExecState = MachineState


@dataclass(frozen=True)
class CodeBlock:
    """A logical qubit: physical qubit indices + frame row index
    (reference analogue: qecc.py:14-31 + ftqc.py:122-128)."""

    index: int  # frame row
    qubits: tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.qubits)


class FTProtocols(MacroExecutor):
    """FT protocol implementations for one CSS code over a fixed block
    layout, on the unpacked tableau engine. Every method takes a state and
    returns a new one; the state lives on ``device`` (default: the card).

    Blocks n_blocks-2 and n_blocks-1 are the shared ancilla pair used by
    error correction and measurement (reference: ftqc.py:60-61)."""

    def __init__(self, code, n_blocks: int,
                 noise: noise_mod.NoiseModel | None = None,
                 max_prep_attempts: int = 8, device="cuda"):
        if code.k != 1:
            raise ValueError("FT protocols require k = 1 codes")
        super().__init__(code, n_blocks - 2, noise, max_prep_attempts,
                         tableau_engine="unpacked", device=device)

    # -- blocks and state -------------------------------------------------------

    def block(self, index: int) -> CodeBlock:
        n = self.n
        return CodeBlock(index, tuple(range(index * n, (index + 1) * n)))

    def init_state(self, batch: int, seed: int = 0, *,
                   generator: torch.Generator | None = None) -> ExecState:
        """Every block in |0>^n, frames, votes and one memory bit zero;
        restarts the split counter from ``seed`` (or one draw from
        ``generator``)."""
        return self.initial_state(batch, 1, seed=seed, generator=generator)

    # -- FT preparation (reference: css_code.py:314-366) --------------------------

    def encode_zero(self, st: ExecState, block: CodeBlock,
                    ancilla: CodeBlock) -> ExecState:
        return self._encode_ft(st, block.index, ancilla.index, plus=False)

    def encode_plus(self, st: ExecState, block: CodeBlock,
                    ancilla: CodeBlock) -> ExecState:
        return self._encode_ft(st, block.index, ancilla.index, plus=True)

    # -- Steane error correction (reference: css_code.py:436-470) -----------------

    def error_correct(self, st: ExecState, data: CodeBlock,
                      anc1: CodeBlock, anc2: CodeBlock) -> ExecState:
        if (anc1.index, anc2.index) != (self.anc1, self.anc2):
            raise ValueError(
                "error correction uses the shared ancilla pair "
                f"(blocks {self.anc1}, {self.anc2})"
            )
        return self._ec_one(st, data.index)

    # -- logical measurement (reference: css_code.py:542-646) ---------------------

    def noisy_measure(self, st: ExecState, data: CodeBlock,
                      anc1: CodeBlock, anc2: CodeBlock
                      ) -> tuple[ExecState, torch.Tensor]:
        if (anc1.index, anc2.index) != (self.anc1, self.anc2):
            raise ValueError("measurement uses the shared ancilla pair")
        return self._noisy_measure(st, data.index)

    def measure(self, st: ExecState, data: CodeBlock,
                anc1: CodeBlock, anc2: CodeBlock,
                ec_between: Callable[[ExecState], ExecState] | None = None,
                ) -> tuple[ExecState, torch.Tensor]:
        """FT logical Z measurement: 2t+1 noisy measurements with a round of
        (caller-supplied) global error correction after each — the batched
        form of the reference's generator-yield contract (reference:
        css_code.py:576-579, ftqc.py:91-95) — then a majority vote."""
        outcomes = []
        for _ in range(self.trials):
            st, o = self.noisy_measure(st, data, anc1, anc2)
            outcomes.append(o)
            if ec_between is not None:
                st = ec_between(st)
        votes = torch.stack(outcomes, dim=0).to(torch.int32).sum(dim=0)
        majority = (votes >= (self.trials + 1) // 2).to(torch.uint8)
        return st, majority

    # -- logical gates (reference: css_code.py:368-434) ----------------------------

    def apply_logical_gate(self, st: ExecState, name: str,
                           blocks: Sequence[CodeBlock],
                           mask: torch.Tensor | None = None) -> ExecState:
        """Dispatch: Pauli-frame ops → transversal → unsupported
        (no non-Clifford support, matching reference: css_code.py:433-434).
        With `mask` ([B] 0/1), the gate applies only to flagged samples
        (classical feedback); without it, to every sample."""
        if name not in ("I", "X", "Y", "Z") and not self.code.is_transversal(name):
            raise UnsupportedGateError(f"logical gate {name} not implemented")
        if name not in GATE_IDS:
            raise UnsupportedGateError(f"logical gate {name} not implemented")
        b0 = blocks[0].index
        b1 = blocks[1].index if len(blocks) > 1 else 0
        return self._apply_gate(st, GATE_IDS[name], b0, b1, mask)
