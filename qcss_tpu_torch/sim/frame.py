"""Pauli-frame Monte-Carlo simulator (PyTorch port of `qcss_tpu.sim.frame`).

All samples run the same Clifford circuit and differ only in which Pauli
faults struck, so only the per-sample fault frame (the deviation from the
noiseless reference run) is propagated: frames are `[B, nq]` uint8
tensors, gates are XOR/permute column ops, and noise is XORed in after
each gate (Gidney, "Stim: a fast stabilizer circuit simulator",
arXiv:2103.02202 §4.2).

Soundness domain, as in the reference: the noiseless reference circuit
has deterministic measurement outcomes, measured qubits are reset before
reuse, and conditional operations are Pauli.

The random draw is split from the arithmetic: `noise.sampled_fault_bits`
draws every gate's fault bits ([B, 4G], four per gate in the layout of
`compile_circuit`'s fault rows) from a `torch.Generator`, and both frame
engines — the per-gate loop `run_arrays_noisy` and the matrix form
`run_compiled_noisy` — take those bits, or draw them the same way, as
does the tableau's `noise.run_arrays_noisy`. So the engines are
bit-identical on one generator state, and a test can hand any of them
the JAX package's fault bits.

The fused channels `inject1_many` / `inject2_many` draw from a generator
exactly as the tableau's `noise.depolarize1_many` / `depolarize2_many` on
the same qubits (the same tensors, in the same order), so the frame XOR
is the Pauli the tableau engine applies on one generator state.

The per-gate functions clone the frame once and then update the clone in
place, column by column; their inputs are never modified. Qubit sets are
index lists (host ints, numpy or tensors) or a `slice` of columns.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.circuits.ir import OPCODES
from qcss_tpu_torch.ops.gf2_torch import mod2_matmul
from qcss_tpu_torch.sim import noise as noise_mod

_TWO_Q_START = OPCODES["CNOT"]


class Frames(NamedTuple):
    """Per-sample Pauli deviation from the reference run: `x[b, q]` /
    `z[b, q]` set iff sample b carries an X / Z error on qubit q."""

    x: torch.Tensor  # [B, nq] uint8
    z: torch.Tensor  # [B, nq] uint8

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def n(self) -> int:
        return self.x.shape[1]


def zero_frames(batch: int, n: int, device="cuda") -> Frames:
    """All-zero frames [batch, n] on ``device`` (the card by default)."""
    z = torch.zeros((batch, n), dtype=torch.uint8,
                    device=resolve_device(device))
    return Frames(z, z.clone())


@functools.lru_cache(maxsize=4096)
def _index_on(qubits: tuple, device: str) -> torch.Tensor:
    """An int64 index tensor, built once per (qubits, device): copying a
    host list to the card waits for the work queued before it, and the FT
    executor indexes the same few qubit sets over and over."""
    return torch.tensor(qubits, dtype=torch.int64, device=device)


def _cols(qubits, device):
    """A column index for ``[:, cols]``: a slice as it is, a tensor moved
    to ``device``, host indices as a cached int64 tensor there."""
    if isinstance(qubits, slice):
        return qubits
    if isinstance(qubits, torch.Tensor):
        return qubits.to(device)
    q = _host_ints(qubits)
    return _index_on(tuple(q.reshape(-1).tolist()),
                     str(torch.device(device))).reshape(q.shape)


def _host_ints(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.int64)


def _apply_gate(x, z, op: int, a: int, b: int) -> None:
    """Conjugate the frame columns (x, z updated in place) by one gate.
    Opcode order matches circuits.ir.OPCODES; Paulis are the identity on
    frames (they change signs only)."""
    if op == 4:  # H
        xa = x[:, a].clone()
        x[:, a] = z[:, a]
        z[:, a] = xa
    elif op == 5:  # S
        z[:, a] ^= x[:, a]
    elif op == 6:  # CNOT
        x[:, b] ^= x[:, a]
        z[:, a] ^= z[:, b]
    elif op == 7:  # CZ
        z[:, a] ^= x[:, b]
        z[:, b] ^= x[:, a]


def propagate_arrays(f: Frames, ops, q0, q1) -> Frames:
    """Noiseless frame propagation through an array-lowered circuit."""
    x, z = f.x.clone(), f.z.clone()
    for op, a, b in zip(_host_ints(ops), _host_ints(q0), _host_ints(q1)):
        _apply_gate(x, z, int(op), int(a), int(b))
    return Frames(x, z)


def run_arrays_noisy(f: Frames, ops, q0, q1, model: noise_mod.NoiseModel,
                     generator: torch.Generator | None = None, *,
                     fault_bits: torch.Tensor | None = None) -> Frames:
    """Frame propagation with a noise location after every gate — the
    per-gate engine (a Python loop over the gates). The fault bits come
    from ``fault_bits`` ([B, 4G]) or are drawn from ``generator``."""
    if model.is_trivial or not (model.p_gate1 or model.p_gate2):
        return propagate_arrays(f, ops, q0, q1)
    ops, q0, q1 = _host_ints(ops), _host_ints(q0), _host_ints(q1)
    bits = fault_bits
    if bits is None:
        bits = noise_mod.sampled_fault_bits(ops, model, generator, f.batch)
    x, z = f.x.clone(), f.z.clone()
    for g, (op, a, b) in enumerate(zip(ops, q0, q1)):
        op, a, b = int(op), int(a), int(b)
        _apply_gate(x, z, op, a, b)
        x[:, a] ^= bits[:, 4 * g]
        z[:, a] ^= bits[:, 4 * g + 1]
        if op >= _TWO_Q_START:
            x[:, b] ^= bits[:, 4 * g + 2]
            z[:, b] ^= bits[:, 4 * g + 3]
    return Frames(x, z)


# -- compiled (matrix-form) circuits -------------------------------------------
#
# Frame propagation through a FIXED Clifford circuit is linear over GF(2),
# and noise injection is XOR, so an entire noisy circuit collapses to
#     out = in · M  ⊕  noise_bits · S
# where M is the circuit's 2n×2n transfer matrix and row r of S is the
# propagated image of elementary fault r through the circuit SUFFIX after
# its gate (noise strikes after each gate, exactly as the per-gate engine
# injects it).


class CompiledFrameCircuit(NamedTuple):
    """Matrix form of a circuit on n qubits (frame coords [x_0..x_{n-1},
    z_0..z_{n-1}]): transfer matrix ``m`` [2n, 2n]; fault-suffix matrix
    ``s`` [4G, 2n], four rows per gate (x_a, z_a, x_b, z_b)."""

    m: torch.Tensor             # [2n, 2n] uint8
    s: torch.Tensor | None      # [4G, 2n] uint8 (None if no gates)
    ops: tuple                  # opcodes per gate (static python ints)
    n: int

    @property
    def num_gates(self) -> int:
        return len(self.ops)

    def to(self, device) -> "CompiledFrameCircuit":
        return self._replace(
            m=self.m.to(device),
            s=None if self.s is None else self.s.to(device))


def compile_circuit(ops, q0, q1, n: int) -> CompiledFrameCircuit:
    """Build the transfer/suffix matrices for an array-lowered circuit on
    n qubits (host-side numpy, once per circuit; a copy of the
    reference's backward pass). At gate g the running suffix map covers
    gates g+1..G (recorded as that gate's fault rows), then gate g is
    prepended via row operations."""
    ops_np = np.asarray(_host_ints(ops), np.int32)
    q0_np = np.asarray(_host_ints(q0), np.int32)
    q1_np = np.asarray(_host_ints(q1), np.int32)
    assert OPCODES["CNOT"] == 6  # gate-rule dispatch below keys off this
    G = ops_np.shape[0]
    m = np.eye(2 * n, dtype=np.uint8)
    rows_rev: list[np.ndarray] = []
    for g in range(G - 1, -1, -1):
        op, a, b = int(ops_np[g]), int(q0_np[g]), int(q1_np[g])
        # record fault coords (x_a, z_a, x_b, z_b) through the suffix;
        # 1q gates use only the first two rows
        rows_rev.append(m[[a, n + a, b % n, n + (b % n)], :].copy())
        # prepend gate g: M <- A_g · M via row ops
        if op == 4:  # H
            m[[a, n + a], :] = m[[n + a, a], :]
        elif op == 5:  # S
            m[a, :] ^= m[n + a, :]
        elif op == 6:  # CNOT
            m[a, :] ^= m[b, :]          # row x_c ^= row x_t
            m[n + b, :] ^= m[n + a, :]  # row z_t ^= row z_c
        elif op == 7:  # CZ
            m[b, :] ^= m[n + a, :]      # row x_b ^= row z_a
            m[a, :] ^= m[n + b, :]      # row x_a ^= row z_b
        # I/X/Y/Z: identity on frames
    rows = list(reversed(rows_rev))
    s = np.concatenate(rows, axis=0) if rows else None
    return compiled_from_numpy(m, s, ops_np, n)


def compiled_from_numpy(m, s, ops, n: int) -> CompiledFrameCircuit:
    """A `CompiledFrameCircuit` from numpy matrices (e.g. the JAX
    package's), on the CPU."""
    return CompiledFrameCircuit(
        m=torch.from_numpy(np.array(m, np.uint8)),
        s=None if s is None else torch.from_numpy(np.array(s, np.uint8)),
        ops=tuple(int(o) for o in np.asarray(ops).reshape(-1)),
        n=int(n),
    )


def maybe_compile(arrays, n: int,
                  min_gates: int = 100) -> CompiledFrameCircuit | None:
    """Compile an array-lowered circuit to matrix form at the reference's
    cutover (100 gates and up); None below it (the per-gate engine)."""
    if len(_host_ints(arrays[0])) < min_gates:
        return None
    return compile_circuit(*arrays, n)


def _noisy_product(v, comp: CompiledFrameCircuit, model, generator,
                   fault_bits, rows: int):
    """v·M ⊕ faults·S for v [rows, 2n]; the fault bits are ``fault_bits``
    or ``rows`` samples drawn from ``generator``."""
    out = mod2_matmul(v, comp.m)
    if (model.p_gate1 or model.p_gate2) and comp.s is not None:
        bits = fault_bits
        if bits is None:
            bits = noise_mod.sampled_fault_bits(comp.ops, model, generator,
                                                rows)
        out = out ^ mod2_matmul(bits, comp.s)
    return out


def run_compiled_noisy(f: Frames, comp: CompiledFrameCircuit,
                       model: noise_mod.NoiseModel,
                       generator: torch.Generator | None = None, *,
                       fault_bits: torch.Tensor | None = None,
                       qubits=None) -> Frames:
    """Execute a compiled circuit: out = in·M ⊕ faults·S. ``qubits``
    ([n] indices or a slice) selects the circuit's qubit window inside
    wider frames (None: the circuit spans the whole frame). Bit-identical
    to `run_arrays_noisy` on the same fault bits or generator state, with
    the window's offsets added to its qubits."""
    n = comp.n
    if qubits is None:
        v = torch.cat([f.x, f.z], dim=-1)  # [B, 2n]
        out = _noisy_product(v, comp, model, generator, fault_bits, f.batch)
        return Frames(out[:, :n].contiguous(), out[:, n:].contiguous())
    q = _cols(qubits, f.x.device)
    v = torch.cat([f.x[:, q], f.z[:, q]], dim=-1)
    out = _noisy_product(v, comp, model, generator, fault_bits, f.batch)
    x, z = f.x.clone(), f.z.clone()
    x[:, q] = out[:, :n]
    z[:, q] = out[:, n:]
    return Frames(x, z)


def run_compiled_noisy_multi(f: Frames, comp: CompiledFrameCircuit,
                             model: noise_mod.NoiseModel,
                             generator: torch.Generator | None, windows, *,
                             fault_bits: torch.Tensor | None = None
                             ) -> Frames:
    """Execute the same compiled block-local circuit on m qubit windows
    at once — the parallel-EC primitive (every block's ancilla prep in one
    pair of products). ``windows``: [m, n] qubit indices. Noise is drawn
    independently per window: one flat [B*m] sample a gate group, row
    b*m + j for shot b and window j (``fault_bits``: [B*m, 4G])."""
    w = _cols(windows, f.x.device)
    m, n = w.shape
    B = f.batch
    v = torch.cat([f.x[:, w], f.z[:, w]], dim=-1)     # [B, m, 2n]
    out = _noisy_product(v.reshape(B * m, 2 * n), comp, model, generator,
                         fault_bits, B * m).reshape(B, m, 2 * n)
    x, z = f.x.clone(), f.z.clone()
    x[:, w] = out[..., :n]
    z[:, w] = out[..., n:]
    return Frames(x, z)


def inject_flips(f: Frames, qubits, x_flips, z_flips) -> Frames:
    """XOR explicit [B, m] flips into the frame at the given qubits."""
    q = _cols(qubits, f.x.device)
    x, z = f.x.clone(), f.z.clone()
    x[:, q] ^= torch.as_tensor(x_flips, device=x.device).to(torch.uint8)
    z[:, q] ^= torch.as_tensor(z_flips, device=z.device).to(torch.uint8)
    return Frames(x, z)


# -- fused noise channels (the tableau channels' draws) ---------------------------


def _num_qubits(qubits, n: int) -> int:
    if isinstance(qubits, slice):
        return len(range(*qubits.indices(n)))
    if isinstance(qubits, torch.Tensor):
        return qubits.numel()
    return len(_host_ints(qubits))


def _qubit_list(qubits, n: int) -> np.ndarray:
    if isinstance(qubits, slice):
        return np.arange(*qubits.indices(n))
    return _host_ints(qubits)


def inject1_many(f: Frames, qubits, p,
                 generator: torch.Generator) -> Frames:
    """IID single-qubit Pauli channel on a set of qubits — the frame
    counterpart of `noise.depolarize1_many` (one [B, m] uniform draw,
    the same thresholds). p: scalar (uniform) or (px, py, pz) (biased)."""
    m = _num_qubits(qubits, f.n)
    u = torch.rand((f.batch, m), generator=generator, device=generator.device)
    x_hit, z_hit = noise_mod._hits_1q(u, p)
    return inject_flips(f, qubits, x_hit, z_hit)


def inject2_many(f: Frames, controls, targets, p,
                 generator: torch.Generator) -> Frames:
    """IID two-qubit noise on m disjoint pairs — the frame counterpart of
    `noise.depolarize2_many`: a [B, m] hit uniform and a pattern in
    [1, 16) for scalar p; for p=(px, py, pz) the biased 1q channel over
    the controls, then the targets."""
    c, q = _qubit_list(controls, f.n), _qubit_list(targets, f.n)
    if isinstance(p, tuple):
        return inject1_many(f, np.concatenate([c, q]), p, generator)
    x1, z1, x2, z2 = noise_mod._hits_2q(generator, (f.batch, len(c)), p)
    return inject_flips(f, np.concatenate([c, q]), torch.cat([x1, x2], 1),
                        torch.cat([z1, z2], 1))


# -- measurement / reset ---------------------------------------------------------


def measure_deviations(f: Frames, qubits, generator=None,
                       p_meas: float = 0.0):
    """Z-basis measurement of qubits whose reference outcome is
    deterministic: returns (frames, outcome deviations [B, m]) — the
    actual outcome is reference ⊕ deviation. Valid only if the measured
    qubits are reset before their next use."""
    outs = f.x[:, _cols(qubits, f.x.device)]
    if p_meas:
        outs = noise_mod.flip_bits(outs, p_meas, generator)
    return f, outs


def reset_qubits(f: Frames, qubits, generator=None,
                 p_reset: float = 0.0) -> Frames:
    """Reset to |0>: the deviation on a reset qubit is the reset-error X
    flip (probability p_reset), independent of its prior frame."""
    q = _cols(qubits, f.x.device)
    x, z = f.x.clone(), f.z.clone()
    if p_reset:
        m = _num_qubits(qubits, f.n)
        x[:, q] = (torch.rand((f.batch, m), generator=generator,
                              device=x.device) < p_reset).to(torch.uint8)
    else:
        x[:, q] = 0
    z[:, q] = 0
    return Frames(x, z)
