"""Bit-packed stabilizer tableaus, 32 qubits per word (PyTorch port of
`qcss_tpu.sim.tableau_packed`).

Rows are stored as 32-bit words, so row operations (the heart of CHP
measurement) touch 32 qubits per element, and the Aaronson-Gottesman
phase function is evaluated bit-sliced:

    g-sum = popcount(plus-mask) - popcount(minus-mask)   (mod 4)

with the plus/minus masks built from the same case analysis as the
unpacked `tableau._g_exponent`, word-parallel.

Layout: x, z are [B, 2n, W] int32 (W = ceil(n/32); bit q%32 of word q//32,
bit 31 included: an int32 holds the reference's uint32 pattern), r is
[B, 2n] uint8. The words are int32 because that is what the measurement
kernel (`sim.cuda_measure`, K9) takes: no conversion at its boundary, and
half the bytes of int64 words. Torch's `>>` on int32 is arithmetic, so
every bit read here is ``(word >> b) & 1``, which is exact for b = 0..31,
and single-bit masks come from `_mask` (bit 31 is -2^31).

`measure_many` is the plain scan of `measure_z` over the measured qubits:
the plain version of K9, which `sim.cuda_measure.measure_many_fused`
launches for tableaus on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.ops.gf2_torch import popcount32
from qcss_tpu_torch.sim import tableau as tb
from qcss_tpu_torch.sim.tableau import host_qubits

WORD = 32


@dataclasses.dataclass(frozen=True)
class PackedTableau:
    x: torch.Tensor  # [B, 2n, W] int32
    z: torch.Tensor  # [B, 2n, W] int32
    r: torch.Tensor  # [B, 2n] uint8
    n: int           # logical qubit count (W may include padding)

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def words(self) -> int:
        return self.x.shape[-1]

    def replace(self, **kw) -> "PackedTableau":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "PackedTableau":
        return PackedTableau(self.x.clone(), self.z.clone(), self.r.clone(),
                             self.n)


def _mask(b: int) -> int:
    """The int32 value with only bit b set."""
    return -(1 << 31) if b == 31 else 1 << b


def _pack(bits: torch.Tensor) -> torch.Tensor:
    return gf2_torch.words32(gf2_torch.pack_bits(bits))


def zero_state(batch: int, n: int, device="cuda") -> PackedTableau:
    """|0>^n on ``device`` (the card by default): destabilizer i = X_i,
    stabilizer i = Z_i."""
    device = resolve_device(device)
    eye = _pack(torch.eye(n, dtype=torch.uint8)).to(device)  # [n, W]
    zeros = torch.zeros_like(eye)
    x = torch.cat([eye, zeros]).repeat(batch, 1, 1)
    z = torch.cat([zeros, eye]).repeat(batch, 1, 1)
    r = torch.zeros((batch, 2 * n), dtype=torch.uint8, device=device)
    return PackedTableau(x, z, r, n)


def from_unpacked(t: tb.Tableau) -> PackedTableau:
    return PackedTableau(_pack(t.x), _pack(t.z), t.r, t.n)


def to_unpacked(t: PackedTableau) -> tb.Tableau:
    return tb.Tableau(gf2_torch.unpack_bits(t.x, t.n),
                      gf2_torch.unpack_bits(t.z, t.n), t.r)


def _addr(q: int) -> tuple[int, int]:
    return q // WORD, q % WORD


def _bit(words: torch.Tensor, b: int) -> torch.Tensor:
    """Bit b of int32 words, as int32 0/1."""
    return (words >> b) & 1


def _col_bit(arr: torch.Tensor, q: int) -> torch.Tensor:
    w, b = _addr(q)
    return _bit(arr[:, :, w], b).to(torch.uint8)


# ---------------------------------------------------------------------------
# Gates: in-place word updates of (x, z, r)
# ---------------------------------------------------------------------------

def _apply_op(x, z, r, op: int, a: int, b: int) -> None:
    """One gate by opcode (`circuits.ir.OPCODES` order), in place."""
    wa, ba = _addr(a)
    if op in (1, 2, 3):  # X, Y, Z: signs only
        flip = 0
        if op in (2, 3):
            flip = _bit(x[:, :, wa], ba)
        if op in (1, 2):
            flip = flip ^ _bit(z[:, :, wa], ba)
        r ^= flip.to(torch.uint8)
    elif op == 4:  # H
        xw, zw = x[:, :, wa].clone(), z[:, :, wa].clone()
        r ^= _bit(xw & zw, ba).to(torch.uint8)
        diff = (xw ^ zw) & _mask(ba)
        x[:, :, wa] ^= diff
        z[:, :, wa] ^= diff
    elif op == 5:  # S
        xw = x[:, :, wa]
        r ^= _bit(xw & z[:, :, wa], ba).to(torch.uint8)
        z[:, :, wa] ^= xw & _mask(ba)
    elif op in (6, 7):
        wb, bb = _addr(b)
        xa, za = _bit(x[:, :, wa], ba), _bit(z[:, :, wa], ba)
        xb, zb = _bit(x[:, :, wb], bb), _bit(z[:, :, wb], bb)
        if op == 6:  # CNOT, control a, target b
            r ^= (xa & zb & (xb ^ za ^ 1)).to(torch.uint8)
            x[:, :, wb] ^= -xa & _mask(bb)
            z[:, :, wa] ^= -zb & _mask(ba)
        else:  # CZ
            r ^= (xa & xb & (za ^ zb)).to(torch.uint8)
            z[:, :, wa] ^= -xb & _mask(ba)
            z[:, :, wb] ^= -xa & _mask(bb)
    elif op != 0:
        raise ValueError(f"unknown opcode {op}")


def _gate(op: int):
    def apply(t: PackedTableau, a: int, b: int = 0) -> PackedTableau:
        t = t.clone()
        _apply_op(t.x, t.z, t.r, op, int(a), int(b))
        return t
    return apply


apply_x = _gate(1)
apply_y = _gate(2)
apply_z = _gate(3)
apply_h = _gate(4)
apply_s = _gate(5)
apply_cnot = _gate(6)
apply_cz = _gate(7)


def run_circuit_scanned(t: PackedTableau, ops, q0, q1) -> PackedTableau:
    """Execute an array-lowered circuit: a loop over its gates on one clone
    of the tableau."""
    t = t.clone()
    for op, a, b in zip(host_qubits(ops), host_qubits(q0), host_qubits(q1)):
        _apply_op(t.x, t.z, t.r, op, a, b)
    return t


def run_circuit(t: PackedTableau, circuit) -> PackedTableau:
    return run_circuit_scanned(t, *circuit.to_arrays())


def apply_pauli_frame(t: PackedTableau, x_flips_packed: torch.Tensor,
                      z_flips_packed: torch.Tensor) -> PackedTableau:
    """Inject packed Pauli flips ([B, W] words each): each row's sign flips
    by the parity of its anticommuting positions — per-word popcounts
    summed over words, reduced mod 2."""
    anti = (
        popcount32(t.z & gf2_torch.words32(x_flips_packed)[:, None, :]).sum(-1)
        + popcount32(t.x & gf2_torch.words32(z_flips_packed)[:, None, :]
                     ).sum(-1)
    ) & 1
    return t.replace(r=t.r ^ anti.to(torch.uint8))


def select(mask, new: PackedTableau, old: PackedTableau) -> PackedTableau:
    m = mask.to(torch.bool)
    return PackedTableau(
        torch.where(m[:, None, None], new.x, old.x),
        torch.where(m[:, None, None], new.z, old.z),
        torch.where(m[:, None], new.r, old.r),
        old.n,
    )


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _g_sum_words(x1, z1, x2, z2) -> torch.Tensor:
    """Bit-sliced Aaronson-Gottesman phase sum: sum over qubit positions of
    g(x1, z1, x2, z2), where inputs are packed words. Returns int32 with
    the same leading shape (P - M, each position contributing -1/0/+1).

    Case analysis identical to `tableau._g_exponent`:
      source Y (x1 z1): +1 where target is Z-only, -1 where X-only
      source X        : +1 where target is Y,     -1 where Z-only
      source Z        : +1 where target is X-only, -1 where Y
    """
    nx1, nz1 = ~x1, ~z1
    nx2, nz2 = ~x2, ~z2
    plus = (x1 & z1 & z2 & nx2) | (x1 & nz1 & x2 & z2) | (nx1 & z1 & x2 & nz2)
    minus = (x1 & z1 & x2 & nz2) | (x1 & nz1 & nx2 & z2) | (nx1 & z1 & x2 & z2)
    return popcount32(plus).sum(-1) - popcount32(minus).sum(-1)


def _prefix_xor(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive XOR prefix along ``dim``: log2(length) shifted XORs (the
    reference's associative scan)."""
    length = v.shape[dim]
    shift = 1
    while shift < length:
        head = v.narrow(dim, 0, shift)
        tail = v.narrow(dim, shift, length - shift) \
            ^ v.narrow(dim, 0, length - shift)
        v = torch.cat([head, tail], dim=dim)
        shift *= 2
    return v


def _measure_z(t: PackedTableau, q: int, rand_bit: torch.Tensor):
    """One Z measurement of qubit q with collapse bits ``rand_bit`` [B]:
    the reference's branch-masked algorithm with rowsums over words."""
    B, two_n, W = t.x.shape
    n = t.n
    dev = t.x.device
    row_ids = torch.arange(two_n, device=dev)
    bidx = torch.arange(B, device=dev)

    xq = _col_bit(t.x, q)  # [B, 2n]
    stab_anti = xq[:, n:] == 1
    is_random = stab_anti.any(dim=1)

    # ---- random branch: argmax takes the first (lowest) anticommuting row
    p_row = n + torch.argmax(stab_anti.to(torch.uint8), dim=1)
    px, pz, pr = t.x[bidx, p_row], t.z[bidx, p_row], t.r[bidx, p_row]

    targets = (xq == 1) & (row_ids[None, :] != p_row[:, None])
    g = _g_sum_words(px[:, None, :], pz[:, None, :], t.x, t.z)  # [B, 2n]
    r4 = (2 * t.r.to(torch.int32) + 2 * pr.to(torch.int32)[:, None] + g) % 4
    new_r = torch.where(targets, (r4 // 2).to(torch.uint8), t.r)
    new_x = torch.where(targets[:, :, None], t.x ^ px[:, None, :], t.x)
    new_z = torch.where(targets[:, :, None], t.z ^ pz[:, None, :], t.z)

    dest = row_ids[None, :] == (p_row - n)[:, None]
    new_x = torch.where(dest[:, :, None], px[:, None, :], new_x)
    new_z = torch.where(dest[:, :, None], pz[:, None, :], new_z)
    new_r = torch.where(dest, pr[:, None], new_r)

    at_p = row_ids[None, :] == p_row[:, None]
    w, b = _addr(q)
    zq_word = torch.zeros(W, dtype=torch.int32, device=dev)
    zq_word[w] = _mask(b)
    new_x = torch.where(at_p[:, :, None], torch.zeros_like(new_x), new_x)
    new_z = torch.where(at_p[:, :, None], zq_word, new_z)
    new_r = torch.where(at_p, rand_bit[:, None], new_r)
    random_state = PackedTableau(new_x, new_z, new_r, n)

    # ---- deterministic branch: the closed-form commuting-product phase
    # (see `tableau._measure_z`); the ordered pair term needs only its
    # parity, so the exclusive prefix of the selected z rows is a
    # cumulative XOR over packed words.
    m = xq[:, :n] == 1  # [B, n] selected stabilizer rows
    sx = torch.where(m[:, :, None], t.x[:, n:, :], 0)
    sz = torch.where(m[:, :, None], t.z[:, n:, :], 0)
    prefix_excl = _prefix_xor(sz, 1) ^ sz
    pair_parity = popcount32(sx & prefix_excl).sum(dim=(1, 2)) & 1
    y = popcount32(t.x[:, n:, :] & t.z[:, n:, :]).sum(-1)
    base = (m.to(torch.int32) * (2 * t.r[:, n:].to(torch.int32) + y)).sum(1)
    det_outcome = (((base + 2 * pair_parity) % 4) // 2).to(torch.uint8)

    outcome = torch.where(is_random, rand_bit, det_outcome)
    return select(is_random, random_state, t), outcome


def measure_z(t: PackedTableau, q: int,
              generator: torch.Generator | None = None, *,
              rand_bit: torch.Tensor | None = None):
    """Batched Z measurement of qubit q (see `tableau.measure_z`); collapse
    bits ``rand_bit`` [B] or drawn from ``generator``."""
    t, out = measure_many(t, [q], generator, rand_bits=None
                          if rand_bit is None else rand_bit[:, None])
    return t, out[:, 0]


def measure_many(t: PackedTableau, qubits,
                 generator: torch.Generator | None = None, *,
                 rand_bits: torch.Tensor | None = None):
    """Measure the qubits in Z, in order: a loop of `measure_z`, the plain
    version of K9. Collapse bits ``rand_bits`` [B, M], or one [B, M] draw
    from ``generator`` (`tableau.collapse_bits`). Returns
    (state, outcomes [B, M] uint8)."""
    qs = host_qubits(qubits)
    bits = tb.resolve_collapse_bits(generator, rand_bits, t.batch,
                                    len(qs), t.x.device)
    outs = []
    for m, q in enumerate(qs):
        t, out = _measure_z(t, q, bits[:, m])
        outs.append(out)
    if not outs:
        return t, bits[:, :0]
    return t, torch.stack(outs, dim=1)


def reset_z(t: PackedTableau, q: int,
            generator: torch.Generator | None = None, *,
            rand_bit: torch.Tensor | None = None) -> PackedTableau:
    return reset_many(t, [q], generator, rand_bits=None
                      if rand_bit is None else rand_bit[:, None])


def reset_many(t: PackedTableau, qubits,
               generator: torch.Generator | None = None, *,
               rand_bits: torch.Tensor | None = None) -> PackedTableau:
    qs = host_qubits(qubits)
    bits = tb.resolve_collapse_bits(generator, rand_bits, t.batch,
                                    len(qs), t.x.device)
    for m, q in enumerate(qs):
        t, outcome = _measure_z(t, q, bits[:, m])
        t = select(outcome, apply_x(t, q), t)
    return t
