"""Batched CHP (Aaronson-Gottesman) stabilizer-tableau simulation
(PyTorch port of `qcss_tpu.sim.tableau`).

The tableau holds, per Monte-Carlo sample, n destabilizer rows followed by
n stabilizer rows as GF(2) X/Z bit matrices plus a sign bit per row. Gate
updates are column-wise XOR/AND ops over the whole batch at once;
measurements vectorize over samples with per-sample branch masking
(random vs deterministic outcomes), as in the reference.

Layout: x, z are [batch, 2n, n] uint8 (rows 0..n-1 destabilizers,
n..2n-1 stabilizers); r is [batch, 2n] uint8 (sign bit, 1 = negative).

Gates take qubit indices as host ints. The public gate functions return a
new tableau: they clone x, z and r once and update the clones in place,
and `run_circuit` / `run_circuit_scanned` clone once per call, not once
per gate. Inputs are never modified.

Randomness: a measurement's collapse bits come from explicit
``rand_bits`` ([B, M] uint8) or are drawn from a `torch.Generator`, all
M columns at once before the loop (`collapse_bits`). Tests hand both
packages the same bits, derived from the reference's keys.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.circuits.ir import OPCODES, Circuit


class Tableau(NamedTuple):
    x: torch.Tensor  # [B, 2n, n] uint8
    z: torch.Tensor  # [B, 2n, n] uint8
    r: torch.Tensor  # [B, 2n] uint8

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def n(self) -> int:
        return self.x.shape[-1]

    def stabilizer_check_matrix(self) -> torch.Tensor:
        """[B, n, 2n] check matrix (X columns then Z columns) of the
        stabilizer half."""
        n = self.n
        return torch.cat([self.x[:, n:, :], self.z[:, n:, :]], dim=-1)

    def clone(self) -> "Tableau":
        return Tableau(self.x.clone(), self.z.clone(), self.r.clone())


def zero_state(batch: int, n: int, device="cuda") -> Tableau:
    """|0>^n for every sample on ``device`` (the card by default):
    destabilizer i = X_i, stabilizer i = Z_i."""
    device = resolve_device(device)
    eye = torch.eye(n, dtype=torch.uint8, device=device)
    zeros = torch.zeros((n, n), dtype=torch.uint8, device=device)
    x = torch.cat([eye, zeros]).repeat(batch, 1, 1)
    z = torch.cat([zeros, eye]).repeat(batch, 1, 1)
    r = torch.zeros((batch, 2 * n), dtype=torch.uint8, device=device)
    return Tableau(x, z, r)


def host_qubits(qubits) -> list[int]:
    """Qubit indices (an int, a sequence, a numpy array or a tensor) as a
    list of host ints."""
    if isinstance(qubits, torch.Tensor):
        qubits = qubits.cpu().numpy()
    return [int(q) for q in np.asarray(qubits, np.int64).reshape(-1)]


# ---------------------------------------------------------------------------
# Gates: in-place column updates of (x, z, r), Clifford conjugation rules
# ---------------------------------------------------------------------------

def _h_(x, z, r, a):
    xa, za = x[:, :, a].clone(), z[:, :, a].clone()
    r ^= xa & za
    x[:, :, a] = za
    z[:, :, a] = xa


def _s_(x, z, r, a):
    xa = x[:, :, a]
    r ^= xa & z[:, :, a]
    z[:, :, a] ^= xa


def _cnot_(x, z, r, c, q):
    xc, zc = x[:, :, c], z[:, :, c]
    xt, zt = x[:, :, q], z[:, :, q]
    r ^= xc & zt & (xt ^ zc ^ 1)
    x[:, :, q] ^= xc
    z[:, :, c] ^= zt


def _cz_(x, z, r, a, b):
    xa, za = x[:, :, a], z[:, :, a]
    xb, zb = x[:, :, b], z[:, :, b]
    r ^= xa & xb & (za ^ zb)
    z[:, :, a] ^= xb
    z[:, :, b] ^= xa


def _apply_op(x, z, r, op: int, a: int, b: int) -> None:
    """One gate by opcode (`circuits.ir.OPCODES` order), in place."""
    if op == 1:  # X
        r ^= z[:, :, a]
    elif op == 2:  # Y
        r ^= x[:, :, a] ^ z[:, :, a]
    elif op == 3:  # Z
        r ^= x[:, :, a]
    elif op == 4:
        _h_(x, z, r, a)
    elif op == 5:
        _s_(x, z, r, a)
    elif op == 6:
        _cnot_(x, z, r, a, b)
    elif op == 7:
        _cz_(x, z, r, a, b)
    elif op != 0:
        raise ValueError(f"unknown opcode {op}")


def _gate(op: int):
    def apply(t: Tableau, a: int, b: int = 0) -> Tableau:
        t = t.clone()
        _apply_op(t.x, t.z, t.r, op, int(a), int(b))
        return t
    return apply


apply_x = _gate(OPCODES["X"])
apply_y = _gate(OPCODES["Y"])
apply_z = _gate(OPCODES["Z"])
apply_h = _gate(OPCODES["H"])
apply_s = _gate(OPCODES["S"])
apply_cnot = _gate(OPCODES["CNOT"])
apply_cz = _gate(OPCODES["CZ"])


def apply_gate(t: Tableau, name: str, *qubits: int) -> Tableau:
    return _gate(OPCODES[name])(t, *qubits)


# ---------------------------------------------------------------------------
# Vectorized multi-qubit forms (transversal layers): pairwise-disjoint
# qubits (pairs), so the column updates are independent and the sign
# contributions XOR together.
# ---------------------------------------------------------------------------

def _parity_reduce(bits: torch.Tensor) -> torch.Tensor:
    """XOR-reduce uint8 bits over the last axis."""
    return (bits.sum(dim=-1) & 1).to(torch.uint8)


def _index(qubits, device) -> torch.Tensor:
    return torch.as_tensor(host_qubits(qubits), dtype=torch.int64,
                           device=device)


def apply_h_many(t: Tableau, qubits) -> Tableau:
    q = _index(qubits, t.x.device)
    x, z, r = t.clone()
    xq, zq = x[:, :, q], z[:, :, q]  # advanced indexing: copies
    r ^= _parity_reduce(xq & zq)
    x[:, :, q] = zq
    z[:, :, q] = xq
    return Tableau(x, z, r)


def apply_s_many(t: Tableau, qubits) -> Tableau:
    q = _index(qubits, t.x.device)
    x, z, r = t.clone()
    xq, zq = x[:, :, q], z[:, :, q]
    r ^= _parity_reduce(xq & zq)
    z[:, :, q] = zq ^ xq
    return Tableau(x, z, r)


def apply_z_many(t: Tableau, qubits) -> Tableau:
    q = _index(qubits, t.x.device)
    return Tableau(t.x, t.z, t.r ^ _parity_reduce(t.x[:, :, q]))


def apply_x_many(t: Tableau, qubits) -> Tableau:
    q = _index(qubits, t.x.device)
    return Tableau(t.x, t.z, t.r ^ _parity_reduce(t.z[:, :, q]))


def apply_cnot_many(t: Tableau, controls, targets) -> Tableau:
    """CNOT on m pairwise-disjoint (control, target) pairs at once."""
    c = _index(controls, t.x.device)
    q = _index(targets, t.x.device)
    x, z, r = t.clone()
    xc, zc = x[:, :, c], z[:, :, c]
    xt, zt = x[:, :, q], z[:, :, q]
    r ^= _parity_reduce(xc & zt & (xt ^ zc ^ 1))
    x[:, :, q] = xt ^ xc
    z[:, :, c] = zc ^ zt
    return Tableau(x, z, r)


def apply_cz_many(t: Tableau, qubits_a, qubits_b) -> Tableau:
    a = _index(qubits_a, t.x.device)
    b = _index(qubits_b, t.x.device)
    x, z, r = t.clone()
    xa, za = x[:, :, a], z[:, :, a]
    xb, zb = x[:, :, b], z[:, :, b]
    r ^= _parity_reduce(xa & xb & (za ^ zb))
    z[:, :, a] = za ^ xb
    z[:, :, b] = zb ^ xa
    return Tableau(x, z, r)


def run_circuit_scanned(t: Tableau, ops, q0, q1) -> Tableau:
    """Execute an array-lowered circuit (`Circuit.to_arrays`): a loop over
    its gates on one clone of the tableau."""
    t = t.clone()
    for op, a, b in zip(host_qubits(ops), host_qubits(q0), host_qubits(q1)):
        _apply_op(t.x, t.z, t.r, op, a, b)
    return t


def run_circuit(t: Tableau, circuit: Circuit) -> Tableau:
    """Apply every gate of a Circuit."""
    return run_circuit_scanned(t, *circuit.to_arrays())


def select(mask: torch.Tensor, new: Tableau, old: Tableau) -> Tableau:
    """Per-sample select: take `new` where mask[b] else `old`."""
    m = mask.to(torch.bool)
    return Tableau(
        torch.where(m[:, None, None], new.x, old.x),
        torch.where(m[:, None, None], new.z, old.z),
        torch.where(m[:, None], new.r, old.r),
    )


def run_circuit_masked(t: Tableau, circuit: Circuit,
                       mask: torch.Tensor) -> Tableau:
    """Apply a circuit only to samples where mask[b] is set — the execution
    form of classical feedback and masked repeat-until-success retries."""
    return select(mask, run_circuit(t, circuit), t)


def apply_pauli_frame(t: Tableau, x_flips: torch.Tensor,
                      z_flips: torch.Tensor) -> Tableau:
    """Inject a batch of Pauli errors: X on qubits with x_flips[b, q] = 1 and
    Z where z_flips[b, q] = 1 (Y = both). Only row signs change: row i picks
    up a sign for every anticommuting position."""
    xf = x_flips.to(torch.uint8)[:, None, :]
    zf = z_flips.to(torch.uint8)[:, None, :]
    flips = _parity_reduce((t.z & xf) ^ (t.x & zf))
    return Tableau(t.x, t.z, t.r ^ flips)


def inject_flips(t: Tableau, qubits, x_flips: torch.Tensor,
                 z_flips: torch.Tensor) -> Tableau:
    """Pauli flips x_flips/z_flips [B, m] on the given distinct qubits
    (`apply_pauli_frame` on [B, n] planes zero elsewhere)."""
    q = _index(qubits, t.x.device)
    xf = torch.zeros((t.batch, t.n), dtype=torch.uint8, device=t.x.device)
    zf = torch.zeros_like(xf)
    xf[:, q] = x_flips.to(torch.uint8)
    zf[:, q] = z_flips.to(torch.uint8)
    return apply_pauli_frame(t, xf, zf)


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def collapse_bits(generator: torch.Generator, batch: int,
                  m: int) -> torch.Tensor:
    """[batch, m] fair uint8 bits on the generator's device: the outcomes
    of the random measurements among m, drawn once before the loop."""
    return torch.randint(0, 2, (batch, m), generator=generator,
                         device=generator.device, dtype=torch.uint8)


def resolve_collapse_bits(generator, rand_bits, batch: int, m: int,
                          device) -> torch.Tensor:
    """Explicit ``rand_bits`` [batch, m], checked, or a fresh draw from
    ``generator`` (`collapse_bits`)."""
    if rand_bits is None:
        if generator is None:
            raise ValueError("pass a generator or rand_bits")
        return collapse_bits(generator, batch, m)
    rand_bits = torch.as_tensor(rand_bits, device=device).to(torch.uint8)
    if tuple(rand_bits.shape) != (batch, m):
        raise ValueError(f"rand_bits must be [{batch}, {m}], got "
                         f"{tuple(rand_bits.shape)}")
    return rand_bits


def _g_exponent(x1, z1, x2, z2):
    """Aaronson-Gottesman g: the exponent of i picked up when multiplying
    the single-qubit Pauli (x1, z1) by (x2, z2). Values in {-1, 0, 1}."""
    x1, z1 = x1.to(torch.int8), z1.to(torch.int8)
    x2, z2 = x2.to(torch.int8), z2.to(torch.int8)
    return (
        x1 * z1 * (z2 - x2)
        + x1 * (1 - z1) * z2 * (2 * x2 - 1)
        + (1 - x1) * z1 * x2 * (1 - 2 * z2)
    )


def _measure_z(t: Tableau, q: int, rand_bit: torch.Tensor):
    """One Z measurement of qubit q with collapse bits ``rand_bit`` [B]."""
    B, two_n, n = t.x.shape[0], t.x.shape[1], t.n
    dev = t.x.device
    row_ids = torch.arange(two_n, device=dev)
    bidx = torch.arange(B, device=dev)

    xq = t.x[:, :, q]  # [B, 2n]
    stab_anticommutes = xq[:, n:] == 1  # [B, n]
    is_random = stab_anticommutes.any(dim=1)  # [B]

    # ---- random branch: argmax takes the first (lowest) anticommuting row
    p_row = n + torch.argmax(stab_anticommutes.to(torch.uint8), dim=1)
    px, pz, pr = t.x[bidx, p_row], t.z[bidx, p_row], t.r[bidx, p_row]

    # rowsum(i, p) for every row i != p with x_iq = 1
    targets = (xq == 1) & (row_ids[None, :] != p_row[:, None])  # [B, 2n]
    g_sum = _g_exponent(px[:, None, :], pz[:, None, :], t.x, t.z).sum(
        dim=-1, dtype=torch.int32)
    r4 = (2 * t.r.to(torch.int32) + 2 * pr.to(torch.int32)[:, None]
          + g_sum) % 4
    new_r = torch.where(targets, (r4 // 2).to(torch.uint8), t.r)
    new_x = torch.where(targets[:, :, None], t.x ^ px[:, None, :], t.x)
    new_z = torch.where(targets[:, :, None], t.z ^ pz[:, None, :], t.z)

    # copy row p into its destabilizer slot p - n
    dest = row_ids[None, :] == (p_row - n)[:, None]
    new_x = torch.where(dest[:, :, None], px[:, None, :], new_x)
    new_z = torch.where(dest[:, :, None], pz[:, None, :], new_z)
    new_r = torch.where(dest, pr[:, None], new_r)

    # row p becomes +/- Z_q with the random bit as its sign = the outcome
    at_p = row_ids[None, :] == p_row[:, None]
    zq_col = (torch.arange(n, device=dev) == q).to(torch.uint8)
    new_x = torch.where(at_p[:, :, None], torch.zeros_like(new_x), new_x)
    new_z = torch.where(at_p[:, :, None], zq_col, new_z)
    new_r = torch.where(at_p, rand_bit[:, None], new_r)
    random_state = Tableau(new_x, new_z, new_r)

    # ---- deterministic branch: the sign of the product of the stabilizer
    # rows n+i whose destabilizers anticommute with Z_q. The rows commute,
    # so the ordered product's phase is
    #   i^( sum_i m_i (2 r_i + |x_i & z_i|) + 2 * sum_{j<l} z_j . x_l )
    # with the pair term from an exclusive prefix count.
    m = (xq[:, :n] == 1).to(torch.int32)  # [B, n]
    sx = t.x[:, n:, :].to(torch.int32) * m[:, :, None]
    sz = t.z[:, n:, :].to(torch.int32) * m[:, :, None]
    prefix_z = torch.cumsum(sz, dim=1) - sz
    pair = (sx * prefix_z).sum(dim=(1, 2))
    y = (t.x[:, n:, :] & t.z[:, n:, :]).sum(dim=-1, dtype=torch.int32)
    base = (m * (2 * t.r[:, n:].to(torch.int32) + y)).sum(dim=1)
    det_outcome = (((base + 2 * pair) % 4) // 2).to(torch.uint8)

    outcome = torch.where(is_random, rand_bit, det_outcome)
    return select(is_random, random_state, t), outcome


def measure_z(t: Tableau, q: int, generator: torch.Generator | None = None,
              *, rand_bit: torch.Tensor | None = None):
    """Measure qubit q in the Z basis across the batch.

    Per sample: if some stabilizer row anticommutes with Z_q the outcome is
    random (the tableau is updated by the AG row operations, the outcome
    is the sample's collapse bit); otherwise it is deterministic (the sign
    of the product of stabilizers whose destabilizer partners
    anticommute). Both branches are computed batch-wide and selected per
    sample. The collapse bits are ``rand_bit`` [B] or drawn from
    ``generator``. Returns (new_tableau, outcomes [B] uint8)."""
    t, out = measure_many(t, [q], generator, rand_bits=None
                          if rand_bit is None else rand_bit[:, None])
    return t, out[:, 0]


def measure_many(t: Tableau, qubits, generator: torch.Generator | None = None,
                 *, rand_bits: torch.Tensor | None = None):
    """Measure a sequence of qubits in Z, in order. Collapse bits:
    ``rand_bits`` [B, M] or one [B, M] draw from ``generator``; column m
    serves qubit m. Returns (state, outcomes [B, M] uint8)."""
    qs = host_qubits(qubits)
    bits = resolve_collapse_bits(generator, rand_bits, t.batch, len(qs),
                                 t.x.device)
    outs = []
    for m, q in enumerate(qs):
        t, out = _measure_z(t, q, bits[:, m])
        outs.append(out)
    if not outs:
        return t, bits[:, :0]
    return t, torch.stack(outs, dim=1)


def reset_z(t: Tableau, q: int, generator: torch.Generator | None = None,
            *, rand_bit: torch.Tensor | None = None) -> Tableau:
    """Reset qubit q to |0>: measure in Z, then flip with X where the
    outcome was 1."""
    return reset_many(t, [q], generator, rand_bits=None
                      if rand_bit is None else rand_bit[:, None])


def reset_many(t: Tableau, qubits, generator: torch.Generator | None = None,
               *, rand_bits: torch.Tensor | None = None) -> Tableau:
    """Reset a sequence of qubits to |0>, in order; collapse bits as in
    `measure_many`."""
    qs = host_qubits(qubits)
    bits = resolve_collapse_bits(generator, rand_bits, t.batch, len(qs),
                                 t.x.device)
    for m, q in enumerate(qs):
        t, outcome = _measure_z(t, q, bits[:, m])
        t = select(outcome, apply_x(t, q), t)
    return t
