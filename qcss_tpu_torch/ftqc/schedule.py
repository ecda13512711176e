"""Macro-op scheduler and executor for FTQC programs (PyTorch port of
`qcss_tpu.ftqc.schedule`, the scheduled engine on the tableau engines).

`lower` turns an encoded program into a small array of
macro-instructions over a uniform machine state:

    PREP_ZERO b cond        FT |0̄⟩ preparation of block b
    GATE g b0 b1 cond       logical gate
    EC_ALL cond             Steane error correction on every data block
    MEASURE_TRIAL b s cond  one noisy logical measurement into vote slot s
    VOTE_STORE off cond     majority over the 2t+1 vote slots -> memory[off]
    CLASSICAL cop dst src cond   classical bit op on memory

Every op carries a per-sample condition `cond` against classical memory:
-1 = unconditional, k >= 0 = run iff memory[k] == 1, and -(k+2) = run iff
memory[k] == 0 (the negated form `repeat_until` loops lower to). Masked-out
samples pass through an op with their machine state selected back — the
batched replacement for the reference's jump-skipped instruction spans
(reference: ftqc.py:98-107).

The lowering (`lower`, `macro_rows`, `circuit_depth`) is the JAX
package's host code, unchanged. `MacroExecutor` runs the rows as a host
Python loop: the opcode, the gate id and the classical-op id are host
ints, so each row dispatches to one body, which queues its tensor work on
the state's device. The repeat-until-success preparation loops at most
``max_prep_attempts`` times and stops once no sample is still flagged
(one host read an attempt). An unconditional op (condition -1) commits
its new state without a select.

Randomness: where the reference splits its key once per sub-operation,
the executor hands that sub-operation a fresh `torch.Generator` on the
state's device, seeded with (seed * 1000003 + i) mod 2^63 for the
executor's i-th split (`sim.noise.chunk_generators` seeds its chunks the
same way). What an operation draws therefore does not depend on how many
values an earlier operation consumed, and both tableau engines draw the
same collapse bits (`tableau.resolve_collapse_bits`) and executor
channels (reset, readout, idle) from the same generators: under
``p_meas``/``p_reset``/``p_idle`` noise the 'unpacked' and 'packed'
engines give identical registers, frames and ``prep_fail``.

The frame engine (``tableau_engine='frames'``) takes no collapse bits,
but every sub-operation still takes its split, so its draws line up with
the unpacked engine's and the two give identical registers and
``prep_fail`` under every channel; its FT preparations run the compiled
(matrix-form) prep networks. Parallel EC (``ec_schedule='parallel'``,
frames only) runs every block's Steane round at once, its
repeat-until-success preparation a host loop of at most
``max_prep_attempts`` attempts committed per (sample, block). Flag EC
(``ec_mode='flag'``, frames only) measures each stabilizer with a bare
ancilla and a flag qubit (`ftqc.flags` builds the CNOT orders and the
flag-conditioned tables); its second extraction runs over the whole batch
every round and commits per sample, so every round takes the same splits.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.circuits.ir import (
    CLASSICAL_OPS,
    BitRef,
    ClassicalInst,
    DeclareInst,
    PragmaInst,
    GateInst,
    GuardedInst,
    IfThenInst,
    MeasureInst,
    RepeatUntilInst,
    ResetInst,
)
from qcss_tpu_torch.decode import lut as decode_lut
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod

# Macro opcodes.
OP_PREP_ZERO = 0
OP_GATE = 1
OP_EC_ALL = 2
OP_MEASURE_TRIAL = 3
OP_VOTE_STORE = 4
OP_CLASSICAL = 5  # (cop, dst, src_enc, cond): classical bit op on memory;
# src_enc >= 0 is a register offset, -(v+1) an immediate v (0/1).
# The pass-through of the reference's classical instructions
# (reference: ftqc.py:111-116).
OP_NOP = 6  # padding row (`macro_rows(pad_to=)`); the executor skips it

# Logical gate ids for OP_GATE's arg0 ('PHASE' is the reference's old name
# for S — reference: test/test_css_code.py:25).
GATE_IDS = {"I": 0, "X": 1, "Y": 2, "Z": 3, "H": 4, "S": 5, "CNOT": 6, "CZ": 7,
            "PHASE": 5}

def circuit_depth(arrays) -> int:
    """ASAP-layered depth of an array-lowered circuit (host-side): the
    number of parallel gate layers, i.e. the circuit's duration in
    elementary time steps for idle-noise accounting."""
    ops, q0, q1 = (np.asarray(a) for a in arrays)
    from qcss_tpu_torch.circuits.ir import OPCODES

    two_q_start = OPCODES["CNOT"]
    avail: dict[int, int] = {}
    depth = 0
    for g in range(ops.shape[0]):
        qs = [int(q0[g])]
        if int(ops[g]) >= two_q_start:
            qs.append(int(q1[g]))
        t = max(avail.get(q, 0) for q in qs) + 1
        for q in qs:
            avail[q] = t
        depth = max(depth, t)
    return depth


class MacroProgram(NamedTuple):
    """Lowered program: rows of (opcode, a0, a1, a2, a3) int32."""

    ops: np.ndarray          # [T, 5]
    n_logical: int
    memory_layout: dict[str, tuple[int, int]]  # name -> (offset, size)
    memory_size: int


def lower(raw, code) -> MacroProgram:
    """Lower a validated `circuits.ir.Program` to macro-instructions,
    following the reference's transpile structure (reference: ftqc.py:42-120):
    FT-prep all blocks, EC after every logical gate, EC between measurement
    trials, majority vote.

    The EC round emitted after a conditional gate carries the gate's own
    condition, matching the reference's jump-skip semantics (the emitted EC
    sits inside the skipped span — reference: ftqc.py:98-107): samples whose
    condition is 0 skip both the gate and its EC round, via the per-sample
    state-select masking every macro-op supports."""
    qubit_map = {q: i for i, q in enumerate(raw.qubits())}
    n_logical = len(qubit_map)
    trials = 2 * code.t + 1

    layout: dict[str, tuple[int, int]] = {}
    offset = 0
    for name, size in raw.memory.items():
        layout[name] = (offset, size)
        offset += size

    rows: list[tuple[int, int, int, int, int]] = []
    for b in range(n_logical):
        rows.append((OP_PREP_ZERO, b, -1, 0, 0))

    def bit_offset(ref) -> int:
        off, _ = layout[ref.name]
        return off + ref.index

    def emit_gate(g: GateInst, cond: int):
        b0 = qubit_map[g.qubits[0]]
        b1 = qubit_map[g.qubits[1]] if len(g.qubits) > 1 else 0
        rows.append((OP_GATE, GATE_IDS[g.name], b0, b1, cond))
        rows.append((OP_EC_ALL, cond, 0, 0, 0))

    def emit_measure(inst: MeasureInst, cond: int):
        b = qubit_map[inst.qubit]
        for s in range(trials):
            rows.append((OP_MEASURE_TRIAL, b, s, cond, 0))
            rows.append((OP_EC_ALL, cond, 0, 0, 0))
        rows.append((OP_VOTE_STORE, bit_offset(inst.target), cond, 0, 0))

    def emit_classical(inst: ClassicalInst, cond: int):
        if isinstance(inst.src, BitRef):
            src = bit_offset(inst.src)
        elif inst.src is None:
            src = -1
        else:
            src = -(int(inst.src) + 1)
        rows.append((OP_CLASSICAL, CLASSICAL_OPS.index(inst.op),
                     bit_offset(inst.dst), src, cond))

    # One hidden scratch bit past the user registers, used to AND a
    # GuardedInst's guard with the enclosing loop's activity mask (the
    # per-op condition word holds a single bit test).
    scratch = offset
    used_scratch = [False]
    _MOVE = CLASSICAL_OPS.index("MOVE")

    def emit_inner(inst, cond: int):
        """Emit a GuardedInst's inner instruction under condition `cond`."""
        if isinstance(inst, GateInst):
            emit_gate(inst, cond)
        elif isinstance(inst, MeasureInst):
            emit_measure(inst, cond)
        elif isinstance(inst, ClassicalInst):
            emit_classical(inst, cond)
        elif isinstance(inst, ResetInst):
            rows.append((OP_PREP_ZERO, qubit_map[inst.qubit], cond, 0, 0))
        else:  # pragma: no cover — GuardedInst validates inner types
            raise ValueError(f"cannot lower guarded {inst}")

    def emit_guarded(inst: GuardedInst, ncond: int | None):
        """Lower a GuardedInst. Outside a loop the guard bit IS the
        condition. Inside a loop the op must fire only when (loop still
        active) AND (guard set): scratch = 0; scratch = guard [masked by
        loop-active]; inner [masked by scratch]. The unconditional zeroing
        is what keeps a stale guard bit from re-firing an op for samples
        that already exited the loop."""
        goff = bit_offset(inst.condition)
        if ncond is None:
            emit_inner(inst.inner, goff)
            return
        used_scratch[0] = True
        rows.append((OP_CLASSICAL, _MOVE, scratch, -1 - 0, -1))   # scratch=0
        rows.append((OP_CLASSICAL, _MOVE, scratch, goff, ncond))
        emit_inner(inst.inner, scratch)

    for inst in raw.instructions:
        if isinstance(inst, (DeclareInst, PragmaInst)):
            continue
        if isinstance(inst, GateInst):
            emit_gate(inst, -1)
        elif isinstance(inst, IfThenInst):
            for g in inst.body:
                emit_gate(g, bit_offset(inst.condition))
        elif isinstance(inst, MeasureInst):
            emit_measure(inst, -1)
        elif isinstance(inst, ClassicalInst):
            emit_classical(inst, -1)
        elif isinstance(inst, GuardedInst):
            emit_guarded(inst, None)
        elif isinstance(inst, ResetInst):
            rows.append((OP_PREP_ZERO, qubit_map[inst.qubit], -1, 0, 0))
        elif isinstance(inst, RepeatUntilInst):
            # Bounded unroll: every body op masked by "loop bit still 0"
            # (negated encoding -(k+2)); samples that have already
            # succeeded pass through untouched.
            ncond = -bit_offset(inst.condition) - 2
            for _ in range(inst.max_iters):
                for body_inst in inst.body:
                    if isinstance(body_inst, GateInst):
                        emit_gate(body_inst, ncond)
                    elif isinstance(body_inst, MeasureInst):
                        emit_measure(body_inst, ncond)
                    elif isinstance(body_inst, ClassicalInst):
                        emit_classical(body_inst, ncond)
                    elif isinstance(body_inst, GuardedInst):
                        emit_guarded(body_inst, ncond)
                    elif isinstance(body_inst, ResetInst):
                        rows.append((OP_PREP_ZERO,
                                     qubit_map[body_inst.qubit], ncond, 0, 0))
                    else:  # pragma: no cover — IR validates body types
                        raise ValueError(f"cannot lower {body_inst}")
        else:  # pragma: no cover — rewrite validates first
            raise ValueError(f"cannot lower {inst}")

    return MacroProgram(
        ops=np.asarray(rows, dtype=np.int32).reshape(-1, 5),
        n_logical=n_logical,
        memory_layout=layout,
        memory_size=offset + 1 if used_scratch[0] else max(offset, 1),
    )


class MachineState(NamedTuple):
    tab: object               # tableau.Tableau | tableau_packed.PackedTableau
    x_frames: torch.Tensor    # [B, n_blocks, n] uint8
    z_frames: torch.Tensor
    votes: torch.Tensor       # [B, trials]
    memory: torch.Tensor      # [B, M]
    prep_fail: torch.Tensor   # [B] uint8 — 1 iff any FT preparation for this
    # sample exhausted max_prep_attempts while still flagged by error
    # detection (an unverified preparation the caller may want to discard)


def _with_block(frames: torch.Tensor, b: int, val) -> torch.Tensor:
    """``frames`` with block b's [B, n] plane replaced by ``val``."""
    out = frames.clone()
    out[:, b, :] = val
    return out


def _where(mask, new, old):
    """Per-sample select along the batch axis; mask None selects `new`."""
    if mask is None:
        return new
    m = mask.to(torch.bool).reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


class MacroExecutor:
    """Executes a MacroProgram batched on a block-level engine
    (`ftqc.engines`): 'unpacked' byte-per-bit tableaus for small codes,
    'packed' 32-bit-word tableaus for surface-code-scale blocks, whose
    block measurements run K9 on the card, or 'frames', per-sample Pauli
    deviations (the Monte-Carlo fast path; needs the reference outcomes
    of `reference_outcomes`). Block arguments are host ints; the state
    lives on ``device`` (default: the card)."""

    def __init__(self, code, n_logical: int,
                 noise: noise_mod.NoiseModel | None = None,
                 max_prep_attempts: int = 8,
                 tableau_engine: str = "unpacked",
                 ancillas: str = "shared",
                 ec_extractions: int = 1,
                 ec_schedule: str = "serial",
                 ec_mode: str = "steane",
                 reference_mode: bool = False,
                 device="cuda"):
        from qcss_tpu_torch.ftqc.engines import make_engine

        if ancillas not in ("shared", "dedicated"):
            raise ValueError("ancillas must be 'shared' or 'dedicated'")
        if ec_extractions not in (1, 2):
            raise ValueError("ec_extractions must be 1 or 2")
        if ec_schedule not in ("serial", "parallel"):
            raise ValueError("ec_schedule must be 'serial' or 'parallel'")
        if ec_mode not in ("steane", "flag"):
            raise ValueError("ec_mode must be 'steane' or 'flag'")
        if ec_mode == "flag" and not reference_mode:
            # Flag EC measures stabilizers with bare ancilla+flag qubit
            # pairs and sequential CNOTs (qubit-level ops: frames engine
            # only); the adaptive re-extraction subsumes ec_extractions,
            # and the per-stabilizer serial schedule is inherent.
            if tableau_engine != "frames":
                raise ValueError("ec_mode='flag' requires tableau='frames'")
            if ec_extractions != 1:
                raise ValueError("ec_mode='flag' has its own adaptive "
                                 "re-extraction; use ec_extractions=1")
            if ec_schedule != "serial":
                raise ValueError("ec_mode='flag' requires "
                                 "ec_schedule='serial'")
        self.ec_mode = ec_mode if not reference_mode else "steane"
        if ec_schedule == "parallel":
            # Parallel EC runs every block's Steane round simultaneously:
            # it needs per-block ancillas, and per-(sample, block) RUS
            # commits, which only the frame state representation supports
            # (tableau rows are not block-separable mid-protocol).
            if ancillas != "dedicated":
                raise ValueError("ec_schedule='parallel' requires "
                                 "ancillas='dedicated'")
            if tableau_engine != "frames" and not reference_mode:
                raise ValueError("ec_schedule='parallel' requires "
                                 "tableau='frames'")
        self.ec_schedule = ec_schedule if not reference_mode else "serial"
        # reference_mode: the noiseless run that records per-measure-site
        # reference outcomes for the 'frames' engine. Pauli gates are
        # skipped (they ride the frame in the frame run) and measure
        # trials ignore their condition mask — sound because a
        # deterministic Z̄ measurement is non-demolition, so forcing it
        # cannot disturb the reference quantum trajectory.
        self.reference_mode = reference_mode
        # ec_extractions=2: Shor-style repeated syndrome extraction in EC —
        # each sector extracts TWICE (fresh verified ancilla each time) and
        # commits the frame correction only for samples where both
        # syndromes agree (the reference trusts a single noisy extraction —
        # css_code.py:436-470).
        self.ec_extractions = ec_extractions
        self.code = code
        self.n = code.n
        self.n_logical = n_logical
        self.ancillas = ancillas
        # 'shared': one ancilla pair serves every block (the reference's
        # QVM-qubit-ceiling compromise — reference: ftqc.py:153-160).
        # 'dedicated': each logical block owns its own EC/measure ancilla
        # pair. Without idle locations (p_idle = 0) the failure statistics
        # are identical; with p_idle > 0 the serialization cost the
        # reference warns about (ftqc.py:156-160) becomes measurable.
        n_anc = 2 if ancillas == "shared" else 2 * n_logical
        self.n_blocks = n_logical + n_anc
        self.noise = noise or noise_mod.NoiseModel()
        self.max_prep_attempts = max_prep_attempts
        self.trials = 2 * code.t + 1
        self.device = _cuda.resolve_device(device)
        self.engine = make_engine(tableau_engine, self.n, self.n_blocks,
                                  self.noise)
        dev = code.device.to(self.device)
        self.h1, self.h2 = dev.h1, dev.h2
        self.lut1, self.lut2 = dev.lut_c1, dev.lut_c2
        self.logical_x, self.logical_z = dev.logical_x, dev.logical_z
        self.detect_x_plain = dev.h2
        self.detect_x_with_ops = torch.cat([dev.h2, dev.logical_z], dim=0)
        self.detect_z_plain = dev.h1
        self.detect_z_with_ops = torch.cat([dev.h1, dev.logical_x], dim=0)
        # Block-local prep networks (qubits in [0, n)), lowered once; the
        # engine offsets them to the target block. Depth-optimized
        # (commuting-gate reorder, unitary-identical to the reference-order
        # network): idle noise is charged per LAYER, so prep depth is a
        # direct fault-tolerance cost (encoding.depth_optimize).
        from qcss_tpu_torch.circuits.encoding import depth_optimize

        self._prep_zero0 = depth_optimize(
            code.noisy_encode_zero(range(self.n))).to_arrays()
        self._prep_plus0 = depth_optimize(
            code.noisy_encode_plus(range(self.n))).to_arrays()
        # Frame engine: prep circuits in matrix form, built once on the
        # executor's device (bit-identical to the per-gate loop on the same
        # generator; two products per FT-prep attempt).
        if hasattr(self.engine, "compile_block_circuit"):
            self._prep_zero_comp = self.engine.compile_block_circuit(
                self._prep_zero0).to(self.device)
            self._prep_plus_comp = self.engine.compile_block_circuit(
                self._prep_plus0).to(self.device)
        else:
            self._prep_zero_comp = self._prep_plus_comp = None
        # Shared-mode static ancilla block indices (reference: ftqc.py:60-61).
        self.anc1 = n_logical
        self.anc2 = n_logical + 1
        if self.ec_schedule == "parallel":
            # static qubit windows (host) and block indices (on the device
            # once); each anc pair's 2n columns commit as one unit
            L = n_logical
            a1 = [L + 2 * b for b in range(L)]
            a2 = [L + 2 * b + 1 for b in range(L)]
            anc1_q = self.engine.blocks_qubits(a1)
            anc2_q = self.engine.blocks_qubits(a2)

            def on_dev(a):
                return torch.as_tensor(np.asarray(a), device=self.device)

            self._par = {
                "data_q": self.engine.blocks_qubits(list(range(L))),
                "anc1_q": anc1_q,
                "anc2_q": anc2_q,
                "anc1_blocks": on_dev(a1),
                "anc2_blocks": on_dev(a2),
                "cols": np.concatenate([anc1_q, anc2_q], axis=1),  # [L, 2n]
                "fidx": on_dev(np.repeat(np.arange(L), 2 * self.n)),
                "ablocks": on_dev(a1 + a2),
                "bidx": on_dev(np.tile(np.arange(L), 2)),
            }
        # Idle-noise durations, in elementary time steps (one transversal
        # layer / measurement / reset = 1 step; prep networks = their
        # ASAP-layered depth). Static Python ints, so each idle channel
        # composes to ONE closed-form injection (noise.compose_pauli).
        self._idle_on = bool(self.noise.p_idle) and n_logical > 0
        self._depth_zero = circuit_depth(self._prep_zero0)
        self._depth_plus = circuit_depth(self._prep_plus0)
        # _error_detect(x_sector, include_operators): reset + anc prep +
        # transversal CNOT + (H for the Z sector) + measure.
        self._detect_steps = {
            (True, False): 1 + self._depth_plus + 1 + 1,
            (True, True): 1 + self._depth_zero + 1 + 1,
            (False, False): 1 + self._depth_zero + 1 + 1 + 1,
            (False, True): 1 + self._depth_plus + 1 + 1 + 1,
        }
        # one _encode_ft attempt: reset + prep + both detection rounds
        self._attempt_steps = {
            True: 1 + self._depth_plus
            + self._detect_steps[(True, False)]
            + self._detect_steps[(False, True)],
            False: 1 + self._depth_zero
            + self._detect_steps[(False, False)]
            + self._detect_steps[(True, True)],
        }
        self._idle_masks: dict[tuple, torch.Tensor] = {}
        if self.ec_mode == "flag":
            from qcss_tpu_torch.ftqc import flags as flags_mod

            self._flag = flags_mod.build_flag_data(code)
            # flags on H1 rows condition the X-error decode; H2 rows the
            # Z-error decode (hooks deposit the SAME Pauli type as the
            # measured stabilizer — see flags.py docstring)
            self._flag_cond_x = torch.as_tensor(
                self._flag.x_sector.cond_lut, device=self.device)
            self._flag_cond_z = torch.as_tensor(
                self._flag.z_sector.cond_lut, device=self.device)
            self._flag_idle_rates = None  # built at first use
        self._seed = 0
        self._splits = 0

    def _anc_pair(self, b: int) -> tuple[int, int]:
        """The EC/measure ancilla pair serving data block b."""
        if self.ancillas == "shared":
            return self.anc1, self.anc2
        return self.n_logical + 2 * b, self.n_logical + 2 * b + 1

    # -- helpers ------------------------------------------------------------------

    def _start(self, seed: int, generator: torch.Generator | None) -> None:
        """Restart the split counter; the base seed is ``seed``, or one
        draw from ``generator`` when one is given."""
        if generator is not None:
            seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                     device=generator.device))
        self._seed = int(seed)
        self._splits = 0

    def _split(self, st: MachineState):
        """The next sub-operation's generator: fresh, on the state's
        device, seeded from the split counter (module docstring)."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self._seed * 1000003 + self._splits) % (1 << 63))
        self._splits += 1
        return st, gen

    def _idle_data(self, st: MachineState, busy, steps: int,
                   sample_mask=None) -> MachineState:
        """Charge `steps` time steps of idle noise to every DATA block not
        in `busy` (block indices; ancilla blocks are reset/re-verified
        before every use, so idling them is unobservable). The composed
        channel costs one RNG draw, made identically in every engine.
        `sample_mask` restricts the charge to samples actually spending
        the time."""
        if not self._idle_on or steps <= 0:
            return st
        rate = noise_mod.compose_pauli(self.noise.rate_idle, steps)
        st, gen = self._split(st)
        B = st.x_frames.shape[0]
        L = self.n_logical
        u = torch.rand((B, L, self.n), generator=gen, device=self.device)
        x_hi, z_lo, z_hi = noise_mod._thresholds_1q(rate)
        x_hit = u < x_hi
        z_hit = (u >= z_lo) & (u < z_hi)
        busy = tuple(busy)
        idle = self._idle_masks.get(busy)
        if idle is None:  # copied to the device once per busy set
            idle = self._idle_masks[busy] = torch.tensor(
                [bl not in busy for bl in range(L)], device=self.device)
        m = idle[None, :, None]
        if sample_mask is not None:
            m = m & sample_mask.to(torch.bool)[:, None, None]
        xf = (x_hit & m).to(torch.uint8)
        zf = (z_hit & m).to(torch.uint8)
        return st._replace(tab=self.engine.inject_data_flips(st.tab, xf, zf))

    def _cond_mask(self, st: MachineState, cond: int):
        """Per-sample execution mask for an op's condition word: -1 → None
        (every sample), k >= 0 → memory[k], -(k+2) → NOT memory[k]."""
        if cond == -1:
            return None
        if cond >= 0:
            return st.memory[:, cond]
        return 1 - st.memory[:, -(cond + 2)]

    def _select_tab(self, mask, new, old):
        return new if mask is None else self.engine.select(mask, new, old)

    def _select_state(self, mask, new: MachineState,
                      old: MachineState) -> MachineState:
        """Commit `new` only for mask=1 samples (every sample for None)."""
        if mask is None:
            return new
        return MachineState(
            self.engine.select(mask, new.tab, old.tab),
            _where(mask, new.x_frames, old.x_frames),
            _where(mask, new.z_frames, old.z_frames),
            _where(mask, new.votes, old.votes),
            _where(mask, new.memory, old.memory),
            _where(mask, new.prep_fail, old.prep_fail),
        )

    def _run_prep(self, st: MachineState, b: int, plus: bool) -> MachineState:
        st, gen = self._split(st)
        comp = self._prep_plus_comp if plus else self._prep_zero_comp
        if comp is not None:
            return st._replace(
                tab=self.engine.run_compiled(st.tab, comp, b, gen))
        arrays = self._prep_plus0 if plus else self._prep_zero0
        return st._replace(
            tab=self.engine.run_block_circuit(st.tab, arrays, b, gen))

    def _reset_block(self, st: MachineState, b: int) -> MachineState:
        st, gen = self._split(st)
        tab = self.engine.reset_block(st.tab, b, gen)
        if self.noise.p_reset:
            st, gen = self._split(st)
            flips = (torch.rand((tab.batch, self.n), generator=gen,
                                device=self.device)
                     < self.noise.p_reset).to(torch.uint8)
            tab = self.engine.inject_block_flips(tab, b, flips,
                                                 torch.zeros_like(flips))
        return st._replace(tab=tab, x_frames=_with_block(st.x_frames, b, 0),
                           z_frames=_with_block(st.z_frames, b, 0))

    def _transversal_cnot(self, st: MachineState, b_ctrl: int,
                          b_tgt: int) -> MachineState:
        st, gen = self._split(st)
        return st._replace(
            tab=self.engine.transversal_cnot(st.tab, b_ctrl, b_tgt, gen))

    def _transversal_1q(self, st: MachineState, gate: str,
                        b: int) -> MachineState:
        st, gen = self._split(st)
        return st._replace(
            tab=self.engine.transversal_1q(st.tab, gate, b, gen))

    def _measure_block(self, st: MachineState, b: int):
        st, gen = self._split(st)
        tab, outs = self.engine.measure_block(st.tab, b, gen)
        st = st._replace(tab=tab)
        if self.noise.p_meas:
            st, gen = self._split(st)
            outs = noise_mod.flip_bits(outs, self.noise.p_meas, gen)
        return st, outs

    # -- FT subroutines (reference: css_code.py:314-533) ----------------------------

    def _error_detect(self, st: MachineState, b: int, anc: int,
                      x_sector: bool, include_operators: bool):
        """Detect X (or Z) errors on block b against noisily prepared block
        `anc` (reference: css_code.py:472-533)."""
        st = self._reset_block(st, anc)
        if x_sector:
            st = self._run_prep(st, anc, plus=not include_operators)
            st = self._transversal_cnot(st, b, anc)
        else:
            st = self._run_prep(st, anc, plus=include_operators)
            st = self._transversal_cnot(st, anc, b)
            st = self._transversal_1q(st, "H", anc)
        st, mem = self._measure_block(st, anc)
        if x_sector:
            check = (self.detect_x_with_ops if include_operators
                     else self.detect_x_plain)
            frame = st.x_frames[:, b, :]
        else:
            check = (self.detect_z_with_ops if include_operators
                     else self.detect_z_plain)
            frame = st.z_frames[:, b, :]
        return st, decode_lut.detect_errors(mem, frame, check)

    def _encode_ft(self, st: MachineState, b: int, anc: int, plus: bool,
                   busy_data=()) -> MachineState:
        """Repeat-until-success |0̄⟩/|+̄⟩ preparation of block b with
        detection against `anc` (reference: css_code.py:314-366): each
        attempt runs batch-wide but commits only still-flagged samples.
        `busy_data` lists the data blocks engaged in this prep (all others
        are charged one attempt's worth of idle noise per attempt they
        actually wait through — committed with the rest of the attempt,
        so only still-flagged samples pay)."""
        flag = torch.ones((st.tab.batch,), dtype=torch.uint8,
                          device=self.device)
        for attempt in range(self.max_prep_attempts):
            if attempt and not bool(flag.any()):  # one host read an attempt
                break
            s = self._reset_block(st, b)
            s = self._run_prep(s, b, plus)
            # Detection ORDER is load-bearing for fault tolerance: each
            # round's transversal CNOT back-propagates the (unverified)
            # detection ancilla's own prep errors onto the block — the
            # X-sector round deposits Z-type errors (CNOT b->anc), the
            # Z-sector round deposits X-type (CNOT anc->b). The LAST round
            # must therefore be the one whose deposit is benign for the
            # prepared eigenstate (Z onto |0̄⟩, X onto |+̄⟩); the earlier
            # round's fatal-type deposit is still caught by the later
            # check. The reference runs X-then-Z for BOTH eigenstates
            # (reference: css_code.py:334-339,358-364).
            if plus:
                s, out_a = self._error_detect(s, b, anc, x_sector=True,
                                              include_operators=False)
                s, out_b = self._error_detect(s, b, anc, x_sector=False,
                                              include_operators=True)
            else:
                s, out_a = self._error_detect(s, b, anc, x_sector=False,
                                              include_operators=False)
                s, out_b = self._error_detect(s, b, anc, x_sector=True,
                                              include_operators=True)
            new_flag = out_a | out_b
            # Blocks elsewhere idle for this attempt's duration (committed
            # below only for samples actually re-running it).
            s = self._idle_data(s, busy_data, self._attempt_steps[plus])
            keep = None if attempt == 0 else flag  # every sample starts flagged
            st = MachineState(
                self._select_tab(keep, s.tab, st.tab),
                _where(keep, s.x_frames, st.x_frames),
                _where(keep, s.z_frames, st.z_frames),
                st.votes, st.memory, st.prep_fail,
            )
            flag = torch.where(flag.to(torch.bool), new_flag, flag)
        # Samples still flagged here carry a preparation that never passed
        # verification (the reference loops unboundedly — css_code.py:314-366;
        # a batched program needs a bound). Record rather than silently commit.
        return st._replace(prep_fail=st.prep_fail | flag)

    def _extract_x_syndrome(self, st: MachineState, b: int, anc1: int,
                            anc2: int):
        """One X-sector extraction: verified |+̄⟩ ancilla, CNOT(b→anc),
        measure; returns (state, syndrome of mem relative to b's frame)."""
        st = self._encode_ft(st, anc1, anc2, plus=True)
        st = self._transversal_cnot(st, b, anc1)
        st = self._idle_data(st, (b,), 1)      # others idle through the CNOT
        st, mem = self._measure_block(st, anc1)
        st = self._idle_data(st, (), 1)        # every data block idles
        return st, gf2_torch.syndromes_dense(mem ^ st.x_frames[:, b, :],
                                             self.h2)

    def _extract_z_syndrome(self, st: MachineState, b: int, anc1: int,
                            anc2: int):
        st = self._encode_ft(st, anc1, anc2, plus=False)
        st = self._transversal_cnot(st, anc1, b)
        st = self._idle_data(st, (b,), 1)
        st = self._transversal_1q(st, "H", anc1)
        st, mem = self._measure_block(st, anc1)
        st = self._idle_data(st, (), 2)        # H on the ancilla + measure
        return st, gf2_torch.syndromes_dense(mem ^ st.z_frames[:, b, :],
                                             self.h1)

    def _ec_one(self, st: MachineState, b: int) -> MachineState:
        """Steane EC on block b with its ancilla pair
        (reference: css_code.py:436-470). With ec_extractions=2, each
        sector's correction commits only where two consecutive extractions
        agree (Shor-style; spurious measurement-driven frame entries drop
        to second order)."""
        anc1, anc2 = self._anc_pair(b)

        st, syn_x = self._extract_x_syndrome(st, b, anc1, anc2)
        commit = None
        if self.ec_extractions > 1:
            st, syn_x2 = self._extract_x_syndrome(st, b, anc1, anc2)
            commit = (syn_x == syn_x2).all(dim=-1)
        corr = decode_lut.decode_corrections(syn_x, self.lut2)
        if commit is not None:
            corr = torch.where(commit[:, None], corr, torch.zeros_like(corr))
        st = st._replace(x_frames=_with_block(
            st.x_frames, b, st.x_frames[:, b, :] ^ corr))

        st, syn_z = self._extract_z_syndrome(st, b, anc1, anc2)
        commit = None
        if self.ec_extractions > 1:
            st, syn_z2 = self._extract_z_syndrome(st, b, anc1, anc2)
            commit = (syn_z == syn_z2).all(dim=-1)
        corr = decode_lut.decode_corrections(syn_z, self.lut1)
        if commit is not None:
            corr = torch.where(commit[:, None], corr, torch.zeros_like(corr))
        return st._replace(z_frames=_with_block(
            st.z_frames, b, st.z_frames[:, b, :] ^ corr))

    # -- flag EC (ec_mode='flag'; frames engine; t=1 codes) ------------------------
    #
    # Chamberland-Beverland distance-3 protocol (arXiv:1708.02246),
    # batched: one FLAGGED extraction of every stabilizer (bare syndrome
    # ancilla + bare flag qubit, sequential CNOTs — 2 ancilla qubits
    # instead of the 2 encoded verifier blocks Steane EC burns per
    # extraction); samples with any syndrome or flag run ONE more
    # unflagged extraction (committed per sample, like the RUS prep
    # bodies) and decode ITS syndrome — with the flag-conditioned hook
    # table where a flag fired, the standard LUT otherwise. Single-fault
    # FT: a measurement flip corrupts only extraction 1 (unused); a hook
    # fires its flag and extraction 2 reads the hook's full syndrome,
    # which the conditional table corrects exactly; a fault inside
    # extraction 2 implies extraction 1 was clean, so the state is clean
    # and any weight<=1 mis-correction is correctable next round. The
    # second extraction runs over the whole batch (no host read decides
    # whether it runs), so every round takes the same splits.

    def _flag_anc_qubits(self, b: int):
        """(syndrome-ancilla, flag) bare qubit indices serving block b —
        the first two qubits of the block's anc1 ancilla block."""
        anc1, _ = self._anc_pair(b)
        base = np.asarray([anc1 * self.engine.stride], np.int64)
        return base, base + 1

    def _flag_cnot(self, st: MachineState, qc, qt) -> MachineState:
        st, gen = self._split(st)
        return st._replace(tab=self.engine.cnot_qubits(st.tab, qc, qt, gen))

    def _flag_h(self, st: MachineState, q) -> MachineState:
        st, gen = self._split(st)
        return st._replace(tab=self.engine.h_qubits(st.tab, q, gen))

    def _flag_meas(self, st: MachineState, q):
        tab, out = self.engine.measure_qubits(st.tab, q)
        st = st._replace(tab=tab)
        out = out[:, 0]
        if self.noise.p_meas:
            st, gen = self._split(st)
            out = noise_mod.flip_bits(out, self.noise.p_meas, gen)
        return st, out

    def _flag_reset_pair(self, st: MachineState, pair_q) -> MachineState:
        st = st._replace(tab=self.engine.reset_blocks(st.tab, pair_q))
        if self.noise.p_reset:
            st, gen = self._split(st)
            B = st.x_frames.shape[0]
            flips = (torch.rand((B, 2), generator=gen, device=self.device)
                     < self.noise.p_reset).to(torch.uint8)
            st = st._replace(tab=fr.inject_flips(st.tab, pair_q, flips,
                                                 torch.zeros_like(flips)))
        return st

    def _flag_idle_block(self, st: MachineState, b: int,
                         flagged: bool) -> MachineState:
        """Per-qubit idle noise WITHIN block b over one full extraction:
        qubit q idles for (total steps - #stabilizers touching q); the
        per-qubit composed channel is evaluated in closed form in float32,
        one draw."""
        if not self._idle_on:
            return st
        if self._flag_idle_rates is None:
            rate = self.noise.rate_idle
            if isinstance(rate, tuple):
                px, py, pz = rate
            else:
                px = py = pz = rate / 3.0
            rates = {}
            for fl, steps in ((True, self._flag.idle_steps_flagged),
                              (False, self._flag.idle_steps_unflagged)):
                s = torch.as_tensor(steps, dtype=torch.float32,
                                    device=self.device)
                lx = torch.pow(1.0 - 2.0 * (py + pz), s)
                ly = torch.pow(1.0 - 2.0 * (px + pz), s)
                lz = torch.pow(1.0 - 2.0 * (px + py), s)
                px2 = torch.clamp((1.0 + lx - ly - lz) / 4.0, min=0.0)
                py2 = torch.clamp((1.0 - lx + ly - lz) / 4.0, min=0.0)
                pz2 = torch.clamp((1.0 - lx - ly + lz) / 4.0, min=0.0)
                rates[fl] = (px2 + py2, px2, px2 + py2 + pz2)
            self._flag_idle_rates = rates
        x_hi, z_lo, z_hi = self._flag_idle_rates[flagged]
        st, gen = self._split(st)
        B = st.x_frames.shape[0]
        u = torch.rand((B, self.n), generator=gen, device=self.device)
        xf = (u < x_hi[None]).to(torch.uint8)
        zf = ((u >= z_lo[None]) & (u < z_hi[None])).to(torch.uint8)
        return st._replace(
            tab=self.engine.inject_block_flips(st.tab, b, xf, zf))

    def _flag_extract(self, st: MachineState, b: int, flagged: bool):
        """One full (both-sector) bare-ancilla syndrome extraction of
        block b. Returns (st, syn_x [B,r2], syn_z [B,r1], flags_z [B,r2],
        flags_x [B,r1]); syndromes are relative to the known frames, flag
        arrays are zeros when flagged=False. Hook directions: the Z-type
        stabilizers (H2 rows, the anc-|0> circuits) hook Z errors, so
        their flags land in flags_z; mirrored for H1."""
        off = b * self.engine.stride
        anc_q, flag_q = self._flag_anc_qubits(b)
        pair_q = np.concatenate([anc_q, flag_q])

        def one_stab(st, sup, x_type: bool):
            """x_type=False: Z-stab (anc |0>, CNOT data->anc, measure Z);
            x_type=True: X-stab (anc |+>, CNOT anc->data, measure X)."""
            st = self._flag_reset_pair(st, pair_q)
            dq = off + np.asarray(sup, np.int64)
            if x_type:
                st = self._flag_h(st, anc_q)
            elif flagged:
                st = self._flag_h(st, flag_q)      # flag |+> for Z-stabs

            def dcnot(st, j):
                if x_type:
                    return self._flag_cnot(st, anc_q, dq[j:j + 1])
                return self._flag_cnot(st, dq[j:j + 1], anc_q)

            def fcnot(st):
                if x_type:
                    return self._flag_cnot(st, anc_q, flag_q)
                return self._flag_cnot(st, flag_q, anc_q)

            st = dcnot(st, 0)
            if flagged:
                st = fcnot(st)
            for j in range(1, len(sup) - 1):
                st = dcnot(st, j)
            if flagged:
                st = fcnot(st)
            if len(sup) > 1:
                st = dcnot(st, len(sup) - 1)
            if x_type:
                st = self._flag_h(st, anc_q)
            st, bit = self._flag_meas(st, anc_q)
            fb = None
            if flagged:
                if not x_type:
                    st = self._flag_h(st, flag_q)  # X-basis flag readout
                st, fb = self._flag_meas(st, flag_q)
            return st, bit, fb

        syn_x_bits, fz_bits = [], []
        for sup in self._flag.z_sector.supports:
            st, bit, fb = one_stab(st, sup, x_type=False)
            syn_x_bits.append(bit)
            if flagged:
                fz_bits.append(fb)
        syn_z_bits, fx_bits = [], []
        for sup in self._flag.x_sector.supports:
            st, bit, fb = one_stab(st, sup, x_type=True)
            syn_z_bits.append(bit)
            if flagged:
                fx_bits.append(fb)

        syn_x = torch.stack(syn_x_bits, dim=1) ^ gf2_torch.syndromes_dense(
            st.x_frames[:, b], self.h2)
        syn_z = torch.stack(syn_z_bits, dim=1) ^ gf2_torch.syndromes_dense(
            st.z_frames[:, b], self.h1)
        if flagged:
            fz, fx = torch.stack(fz_bits, dim=1), torch.stack(fx_bits, dim=1)
        else:
            fz, fx = torch.zeros_like(syn_x), torch.zeros_like(syn_z)
        # idle: every OTHER data block waits out the extraction; block b's
        # own off-support qubits idle per the static per-qubit step counts
        steps = (self._flag.steps_flagged if flagged
                 else self._flag.steps_unflagged)
        st = self._idle_data(st, (b,), steps)
        st = self._flag_idle_block(st, b, flagged)
        return st, syn_x, syn_z, fz, fx

    @staticmethod
    def _first_set(bits: torch.Tensor) -> torch.Tensor:
        """Index of the first 1 along the last axis (0 where none is set),
        as `jnp.argmax` picks it: each position weighted by its distance
        from the end, so the maximum is unique wherever a bit is set."""
        r = bits.shape[-1]
        w = torch.arange(r, 0, -1, dtype=torch.int32, device=bits.device)
        return torch.argmax(bits.to(torch.int32) * w, dim=-1)

    def _ec_one_flag(self, st: MachineState, b: int) -> MachineState:
        """One flag-EC round on block b (see section comment)."""
        st1, sx1, sz1, fz, fx = self._flag_extract(st, b, flagged=True)
        needs2 = ((sx1 == 1).any(dim=1) | (sz1 == 1).any(dim=1)
                  | (fz == 1).any(dim=1) | (fx == 1).any(dim=1)
                  ).to(torch.uint8)
        st2, sx2, sz2, _, _ = self._flag_extract(st1, b, flagged=False)
        st2 = self._select_state(needs2, st2, st1)
        m = needs2.to(torch.bool)[:, None]
        sx2 = torch.where(m, sx2, torch.zeros_like(sx2))
        sz2 = torch.where(m, sz2, torch.zeros_like(sz2))

        any_fx = (fx == 1).any(dim=1)
        corr_x = torch.where(
            any_fx[:, None],
            self._flag_cond_x[self._first_set(fx),
                              gf2_torch.bits_to_index(sx2).to(torch.int64)],
            decode_lut.decode_corrections(sx2, self.lut2))
        st2 = st2._replace(x_frames=_with_block(
            st2.x_frames, b, st2.x_frames[:, b] ^ corr_x))

        any_fz = (fz == 1).any(dim=1)
        corr_z = torch.where(
            any_fz[:, None],
            self._flag_cond_z[self._first_set(fz),
                              gf2_torch.bits_to_index(sz2).to(torch.int64)],
            decode_lut.decode_corrections(sz2, self.lut1))
        return st2._replace(z_frames=_with_block(
            st2.z_frames, b, st2.z_frames[:, b] ^ corr_z))

    # -- parallel EC (ec_schedule='parallel'; frames engine) ----------------------
    #
    # The serial path runs one block's Steane round at a time (the
    # reference's structure — one shared scratch, every other block
    # waiting: ftqc.py:153-171); with idle noise that wait converts
    # directly into data errors. The parallel path runs EVERY block's
    # round simultaneously: all ancilla preps in one multi-window
    # compiled-circuit execution, all transversal CNOTs in one pairwise
    # call, all measurements in one readout — so a wide program pays ONE
    # round of idle exposure instead of n_logical of them.

    def _reset_blocks_par(self, st: MachineState, blocks,
                          qubits) -> MachineState:
        st, _ = self._split(st)  # the reference's split; frames draw none
        tab = self.engine.reset_blocks(st.tab, qubits)
        if self.noise.p_reset:
            st, gen = self._split(st)
            flips = (torch.rand((tab.batch, qubits.size), generator=gen,
                                device=self.device)
                     < self.noise.p_reset).to(torch.uint8)
            tab = fr.inject_flips(tab, qubits.reshape(-1), flips,
                                  torch.zeros_like(flips))
        x_frames, z_frames = st.x_frames.clone(), st.z_frames.clone()
        x_frames[:, blocks] = 0
        z_frames[:, blocks] = 0
        return st._replace(tab=tab, x_frames=x_frames, z_frames=z_frames)

    def _prep_blocks_par(self, st: MachineState, windows,
                         plus: bool) -> MachineState:
        st, gen = self._split(st)
        comp = self._prep_plus_comp if plus else self._prep_zero_comp
        return st._replace(
            tab=self.engine.run_compiled_multi(st.tab, comp, windows, gen))

    def _cnot_par(self, st: MachineState, qc, qt) -> MachineState:
        st, gen = self._split(st)
        return st._replace(tab=self.engine.cnot_qubits(st.tab, qc, qt, gen))

    def _h_par(self, st: MachineState, q) -> MachineState:
        st, gen = self._split(st)
        return st._replace(tab=self.engine.h_qubits(st.tab, q, gen))

    def _measure_blocks_par(self, st: MachineState, qubits):
        st, _ = self._split(st)  # the reference's split; frames draw none
        tab, outs = self.engine.measure_qubits(st.tab, qubits)
        st = st._replace(tab=tab)
        if self.noise.p_meas:
            st, gen = self._split(st)
            outs = noise_mod.flip_bits(outs, self.noise.p_meas, gen)
        return st, outs.reshape(outs.shape[0], self.n_logical, self.n)

    def _detect_par(self, st: MachineState, x_sector: bool,
                    include_operators: bool):
        """All-blocks error detection: verify every anc1 block against its
        anc2 partner (the multi-block `_error_detect`). Returns
        (state, flags [B, L])."""
        p = self._par
        st = self._reset_blocks_par(st, p["anc2_blocks"], p["anc2_q"])
        if x_sector:
            st = self._prep_blocks_par(st, p["anc2_q"],
                                       plus=not include_operators)
            st = self._cnot_par(st, p["anc1_q"], p["anc2_q"])
        else:
            st = self._prep_blocks_par(st, p["anc2_q"],
                                       plus=include_operators)
            st = self._cnot_par(st, p["anc2_q"], p["anc1_q"])
            st = self._h_par(st, p["anc2_q"])
        st, mem = self._measure_blocks_par(st, p["anc2_q"])
        anc1 = p["anc1_blocks"]
        if x_sector:
            check = (self.detect_x_with_ops if include_operators
                     else self.detect_x_plain)
            frame = st.x_frames[:, anc1]
        else:
            check = (self.detect_z_with_ops if include_operators
                     else self.detect_z_plain)
            frame = st.z_frames[:, anc1]
        return st, decode_lut.detect_errors(mem, frame, check)

    def _encode_ft_par(self, st: MachineState, plus: bool) -> MachineState:
        """FT-prepare ALL anc1 blocks at once, with per-(sample, block)
        repeat-until-success: a block that verified keeps its state while
        its neighbors retry (possible on frames because block columns are
        independent; a tableau's rows are not block-separable). A host
        loop of at most ``max_prep_attempts`` attempts, one host read an
        attempt."""
        p = self._par
        B = st.x_frames.shape[0]
        L = self.n_logical
        flag = torch.ones((B, L), dtype=torch.uint8, device=self.device)
        for attempt in range(self.max_prep_attempts):
            if attempt and not bool(flag.any()):  # one host read an attempt
                break
            s = self._reset_blocks_par(st, p["anc1_blocks"], p["anc1_q"])
            s = self._prep_blocks_par(s, p["anc1_q"], plus)
            if plus:
                s, out_a = self._detect_par(s, True, False)
                s, out_b = self._detect_par(s, False, True)
            else:
                s, out_a = self._detect_par(s, False, False)
                s, out_b = self._detect_par(s, True, True)
            new_flag = out_a | out_b  # [B, L]
            tab = self.engine.select_qubits(st.tab, p["cols"],
                                            flag[:, p["fidx"]], s.tab, st.tab)
            mb = torch.zeros((B, self.n_blocks), dtype=torch.bool,
                             device=self.device)
            mb[:, p["ablocks"]] = flag[:, p["bidx"]].to(torch.bool)
            committed = MachineState(
                tab,
                torch.where(mb[:, :, None], s.x_frames, st.x_frames),
                torch.where(mb[:, :, None], s.z_frames, st.z_frames),
                st.votes, st.memory, st.prep_fail,
            )
            # Idle on the DATA blocks must be charged AFTER the commit:
            # the per-(sample, block) commit above only writes ancilla
            # columns, so an injection inside the attempt would be
            # silently reverted (the reference records the bug this
            # ordering fixes: a 1-block program showed the parallel
            # schedule "beating" the serial one 6.7x, though the two charge
            # identical idle for one block).
            st = self._idle_data(committed, (), self._attempt_steps[plus],
                                 sample_mask=flag.to(torch.bool).any(dim=1))
            flag = flag & new_flag
        return st._replace(
            prep_fail=st.prep_fail | flag.any(dim=1).to(torch.uint8))

    def _extract_sector_par(self, st: MachineState, x_sector: bool):
        """One all-blocks syndrome extraction; returns (state, syn [B, L, r])."""
        p = self._par
        st = self._encode_ft_par(st, plus=x_sector)
        if x_sector:
            st = self._cnot_par(st, p["data_q"], p["anc1_q"])
        else:
            st = self._cnot_par(st, p["anc1_q"], p["data_q"])
            st = self._h_par(st, p["anc1_q"])
            st = self._idle_data(st, (), 1)  # H layer on the ancillas
        st, mem = self._measure_blocks_par(st, p["anc1_q"])
        st = self._idle_data(st, (), 1)      # readout layer
        L = self.n_logical
        if x_sector:
            syn = gf2_torch.syndromes_dense(mem ^ st.x_frames[:, :L], self.h2)
        else:
            syn = gf2_torch.syndromes_dense(mem ^ st.z_frames[:, :L], self.h1)
        return st, syn

    def _ec_all_parallel(self, st: MachineState) -> MachineState:
        L = self.n_logical
        for x_sector, lut in ((True, self.lut2), (False, self.lut1)):
            st, syn = self._extract_sector_par(st, x_sector)
            commit = None
            if self.ec_extractions > 1:
                st, syn2 = self._extract_sector_par(st, x_sector)
                commit = (syn == syn2).all(dim=-1)  # [B, L]
            corr = decode_lut.decode_corrections(syn, lut)  # [B, L, n]
            if commit is not None:
                corr = torch.where(commit[:, :, None], corr,
                                   torch.zeros_like(corr))
            if x_sector:
                x_frames = st.x_frames.clone()
                x_frames[:, :L] ^= corr
                st = st._replace(x_frames=x_frames)
            else:
                z_frames = st.z_frames.clone()
                z_frames[:, :L] ^= corr
                st = st._replace(z_frames=z_frames)
        return st

    # -- macro-op bodies --------------------------------------------------------------

    def _op_prep_zero(self, st: MachineState, a) -> MachineState:
        mask = self._cond_mask(st, a[1])
        anc1, _ = self._anc_pair(a[0])
        new = self._encode_ft(st, a[0], anc1, plus=False, busy_data=(a[0],))
        return self._select_state(mask, new, st)

    def _op_gate(self, st: MachineState, a) -> MachineState:
        gate_id, b0, b1, cond = a[0], a[1], a[2], a[3]
        mask = self._cond_mask(st, cond)
        st = self._apply_gate(st, gate_id, b0, b1, mask)
        if self._idle_on:
            # one transversal layer elsewhere; 1q gates carry b1 = 0 in
            # the lowered row, so mask it to b0 there
            b1_eff = b1 if gate_id >= GATE_IDS["CNOT"] else b0
            st = self._idle_data(st, (b0, b1_eff), 1, sample_mask=mask)
        return st

    def _apply_gate(self, st: MachineState, gate_id: int, b0: int, b1: int,
                    mask) -> MachineState:
        """Logical gate dispatch (reference: css_code.py:368-434), masked per
        sample (mask None: every sample)."""

        def pauli_branch(s, x_row, z_row):
            # Logical Pauli = masked frame injection along the operator's
            # support at block b0: conjugating a Pauli through the tableau
            # only flips row signs (reference applies physical gates along
            # the operator — css_code.py:386-407 — which is the same map).
            if self.reference_mode:
                return s  # the reference run excludes Paulis (frame-borne)
            m = (torch.ones((s.tab.batch,), dtype=torch.uint8,
                            device=self.device) if mask is None else mask)
            s2 = s._replace(
                tab=self.engine.pauli_inject(s.tab, b0, x_row, z_row, m))
            if self.noise.p_gate1:
                s2, gen = self._split(s2)
                s2 = s2._replace(tab=self.engine.depolarize_block(
                    s2.tab, b0, self.noise.rate1, gen))
                # Samples whose conditional gate did not fire get no noise
                # location either (the reference's jump skips the gate).
                s2 = s2._replace(tab=self._select_tab(mask, s2.tab, s.tab))
            return s2

        def masked(s, s2):
            return s2._replace(tab=self._select_tab(mask, s2.tab, s.tab))

        xop, zop = self.logical_x[0], self.logical_z[0]
        zeros_row = torch.zeros_like(xop)
        if gate_id == GATE_IDS["I"]:
            return st
        if gate_id == GATE_IDS["X"]:
            return pauli_branch(st, xop, zeros_row)
        if gate_id == GATE_IDS["Y"]:
            return pauli_branch(st, xop, zop)
        if gate_id == GATE_IDS["Z"]:
            return pauli_branch(st, zeros_row, zop)
        if gate_id == GATE_IDS["H"]:
            return masked(st, self._transversal_1q(st, "H", b0))
        if gate_id == GATE_IDS["S"]:
            return masked(st, self._transversal_1q(
                self._transversal_1q(st, "Z", b0), "S", b0))
        if gate_id == GATE_IDS["CNOT"]:
            return masked(st, self._transversal_cnot(st, b0, b1))
        if gate_id == GATE_IDS["CZ"]:
            return masked(st, self._cz(st, b0, b1))
        raise ValueError(f"unknown logical gate id {gate_id}")

    def _cz(self, st: MachineState, b0: int, b1: int) -> MachineState:
        st, gen = self._split(st)
        return st._replace(tab=self.engine.transversal_cz(st.tab, b0, b1, gen))

    def _op_ec_all(self, st: MachineState, a) -> MachineState:
        mask = self._cond_mask(st, a[0])
        if self.ec_mode == "flag":
            new = st
            for b in range(self.n_logical):
                new = self._ec_one_flag(new, b)
        elif self.ec_schedule == "parallel":
            new = self._ec_all_parallel(st)
        else:
            new = st
            for b in range(self.n_logical):
                new = self._ec_one(new, b)
        return self._select_state(mask, new, st)

    def _noisy_measure(self, st: MachineState, b: int):
        """Single (non-FT) logical Z measurement of block b via a fresh |0̄⟩
        ancilla (reference: css_code.py:599-646): transversal CNOT onto the
        ancilla, measure it, opportunistically correct the X frame, outcome
        = Z̄ · corrected bits. Returns (state, outcome[B])."""
        anc1, anc2 = self._anc_pair(b)
        st = self._encode_ft(st, anc1, anc2, plus=False)
        st = self._transversal_cnot(st, b, anc1)
        st = self._idle_data(st, (b,), 1)
        st, mem = self._measure_block(st, anc1)
        st = self._idle_data(st, (), 1)
        corrected, new_x = decode_lut.correct_errors(
            mem, st.x_frames[:, b, :], self.h2, self.lut2)
        st = st._replace(x_frames=_with_block(st.x_frames, b, new_x))
        zbar = self.logical_z[0]
        outcome = ((corrected.to(torch.int32) * zbar.to(torch.int32))
                   .sum(dim=-1) & 1).to(torch.uint8)
        return st, outcome

    def _op_measure_trial(self, st: MachineState, a) -> MachineState:
        b, slot = a[0], a[1]
        # reference_mode forces the trial (a deterministic measurement is
        # non-demolition) so its reference outcome is recorded even inside
        # loops.
        mask = None if self.reference_mode else self._cond_mask(st, a[2])
        new, outcome = self._noisy_measure(st, b)
        # a[4]: the reference outcome of this measure site (zero except in
        # frame-engine runs, where `outcome` is a deviation).
        outcome = outcome ^ (a[4] & 0xFF)
        votes = new.votes.clone()
        votes[:, slot] = outcome
        new = new._replace(votes=votes)
        return self._select_state(mask, new, st)  # also reverts the vote slot

    def _op_vote_store(self, st: MachineState, a) -> MachineState:
        trials = self.trials
        mask = self._cond_mask(st, a[1])
        counts = st.votes[:, :trials].to(torch.int32).sum(dim=-1)
        outcome = (counts >= (trials + 1) // 2).to(torch.uint8)
        memory = st.memory.clone()
        memory[:, a[0]] = _where(mask, outcome, st.memory[:, a[0]])
        return st._replace(memory=memory)

    def _op_classical(self, st: MachineState, a) -> MachineState:
        """Classical bit op on memory (reference: quil_classical.py:60-127
        semantics, batched). a = (cop, dst, src_enc, cond)."""
        cop, dst, src, cond = a[0], a[1], a[2], a[3]
        mask = self._cond_mask(st, cond)
        cur = st.memory[:, max(dst, 0)]
        srcval = (st.memory[:, src] if src >= 0
                  else torch.full_like(cur, (-src - 1) & 0xFF))
        op = CLASSICAL_OPS[cop]
        if op == "MOVE":
            new = srcval
        elif op == "NOT":
            new = 1 ^ cur
        elif op == "AND":
            new = cur & srcval
        elif op == "IOR":
            new = cur | srcval
        else:  # XOR
            new = cur ^ srcval
        memory = st.memory.clone()
        memory[:, dst] = _where(mask, new, cur)
        return st._replace(memory=memory)

    # -- top level -----------------------------------------------------------------------

    def initial_state(self, batch: int, memory_size: int, *, seed: int = 0,
                      generator: torch.Generator | None = None
                      ) -> MachineState:
        """Every block in |0>^n, frames, votes and memory zero; restarts
        the split counter from ``seed`` (or one draw from ``generator``)."""
        self._start(seed, generator)
        zeros_f = torch.zeros((batch, self.n_blocks, self.n),
                              dtype=torch.uint8, device=self.device)
        return MachineState(
            tab=self.engine.zero_state(batch, self.device),
            x_frames=zeros_f,
            z_frames=zeros_f,
            votes=torch.zeros((batch, self.trials), dtype=torch.uint8,
                              device=self.device),
            memory=torch.zeros((batch, memory_size), dtype=torch.uint8,
                               device=self.device),
            prep_fail=torch.zeros((batch,), dtype=torch.uint8,
                                  device=self.device),
        )

    def step(self, st: MachineState, row) -> MachineState:
        """Execute one macro row (host ints: opcode, a0..a3, reference
        outcome)."""
        bodies = {
            OP_PREP_ZERO: self._op_prep_zero,
            OP_GATE: self._op_gate,
            OP_EC_ALL: self._op_ec_all,
            OP_MEASURE_TRIAL: self._op_measure_trial,
            OP_VOTE_STORE: self._op_vote_store,
            OP_CLASSICAL: self._op_classical,
            OP_NOP: lambda st, a: st,
        }
        return bodies[row[0]](st, row[1:])

    def run_rows(self, rows, batch: int, memory_size: int, *,
                 seed: int = 0, generator: torch.Generator | None = None,
                 capture_votes: bool = False):
        """Execute macro rows ([T, 6] host ints: opcode, a0..a3, reference
        outcome) over ``batch`` samples, drawing from ``generator`` when
        given, else from ``seed``. Returns the final `MachineState`, and
        with ``capture_votes`` also the votes after every row
        ([T, B, trials]). `OP_NOP` rows are skipped."""
        st = self.initial_state(batch, memory_size, seed=seed,
                                generator=generator)
        votes = []
        for row in np.asarray(rows).tolist():
            st = self.step(st, row)
            if capture_votes:
                votes.append(st.votes)
        if capture_votes:
            return st, torch.stack(votes) if votes else st.votes[None, :0]
        return st

    def execute(self, macro: MacroProgram, batch: int, *, seed: int = 0,
                generator: torch.Generator | None = None,
                ref_outs: np.ndarray | None = None,
                capture_votes: bool = False):
        """Run the macro program over ``batch`` samples; returns the final
        `MachineState` (tableau, frames, votes, memory, prep_fail).
        ``ref_outs`` ([T] reference measurement outcomes, see
        `reference_outcomes`) is zero-filled when omitted.
        ``capture_votes=True`` additionally returns the votes array after
        every op ([T, B, trials]) — the reference-recording hook."""
        rows = macro_rows(macro, ref_outs)
        return self.run_rows(rows, batch, macro.memory_size, seed=seed,
                             generator=generator,
                             capture_votes=capture_votes)


def macro_rows(macro: MacroProgram, ref_outs: np.ndarray | None = None,
               pad_to: int | None = None) -> np.ndarray:
    """[T, 6] executor rows (ops + reference-outcome column), optionally
    NOP-padded to ``pad_to`` rows (shape-bucketing for shared compiles)."""
    ops = np.asarray(macro.ops)
    ref_col = (
        np.zeros((ops.shape[0], 1), np.int32) if ref_outs is None
        else np.asarray(ref_outs, np.int32).reshape(-1, 1)
    )
    rows = np.concatenate([ops, ref_col], axis=1).astype(np.int32)
    if pad_to is not None and pad_to > rows.shape[0]:
        pad = np.zeros((pad_to - rows.shape[0], 6), np.int32)
        pad[:, 0] = OP_NOP
        rows = np.concatenate([rows, pad], axis=0)
    return rows


# code -> {(rows, memory size, batch, seed, device): reference outcomes};
# weak so codes built in tests are not pinned
_REF_OUTCOMES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def reference_outcomes(macro: MacroProgram, code, *, batch: int = 32,
                       seed: int = 0, device="cuda") -> np.ndarray:
    """Record the reference outcome of every measure site by running the
    macro program ONCE, noiselessly, on the unpacked tableau engine with
    Paulis skipped (`reference_mode`) — the frame engine XORs these into
    its outcome deviations. `batch` independent reference samples double
    as the determinism check (a random outcome disagrees across 32 samples
    with probability 1 - 2^-31): raises `UnsupportedProgramError` if any
    measure site is non-deterministic, the frame engine's soundness
    condition (e.g. a program measuring a block left in |+̄⟩). The rows
    run one at a time and each measure site is checked as it is reached,
    so a refused program stops at its first random outcome (the
    reference checks every row after one compiled run and raises at the
    same first site). The outcomes of an accepted program are kept per
    code, so encoding the same program again records nothing."""
    from qcss_tpu_torch.errors import UnsupportedProgramError

    device = _cuda.resolve_device(device)
    key = (macro.ops.tobytes(), macro.ops.shape, macro.memory_size, batch,
           seed, str(device))
    per_code = _REF_OUTCOMES.setdefault(code, {})
    if key in per_code:
        return per_code[key].copy()
    ex = MacroExecutor(code, macro.n_logical, noise=None,
                       tableau_engine="unpacked", reference_mode=True,
                       device=device)
    st = ex.initial_state(batch, macro.memory_size, seed=seed)
    ops = macro.ops
    refs = np.zeros(ops.shape[0], np.int32)
    for t, row in enumerate(macro_rows(macro).tolist()):
        st = ex.step(st, row)
        if ops[t, 0] == OP_MEASURE_TRIAL:
            vals = st.votes[:, ops[t, 2]].cpu().numpy()
            if not (vals == vals[0]).all():
                raise UnsupportedProgramError(
                    "non-deterministic reference measurement at macro op "
                    f"{t}; the 'frames' engine requires every measured "
                    "block to be in a definite Z̄ eigenstate — use the "
                    "'unpacked' or 'packed' tableau engine for this program"
                )
            refs[t] = int(vals[0])
    per_code[key] = refs.copy()
    return refs
