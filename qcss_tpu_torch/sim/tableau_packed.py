"""Bit-packed stabilizer tableaus, 32 qubits per word (PyTorch port of
`qcss_tpu.sim.tableau_packed`).

Rows are stored as 32-bit words, so row operations (the heart of CHP
measurement) touch 32 qubits per element, and the Aaronson-Gottesman
phase function is evaluated bit-sliced:

    g-sum = popcount(plus-mask) - popcount(minus-mask)   (mod 4)

with the plus/minus masks built from the Aaronson-Gottesman case
analysis (`_g_sum_words`), word-parallel.

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


def _popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Set bits over the last axis of int32 words, as int32: a byte-wise
    SWAR count on the words' uint8 view (unsigned, one byte an element)."""
    v = words.contiguous().view(torch.uint8)
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    v = (v + (v >> 4)) & 0x0F
    return v.sum(-1, dtype=torch.int32)


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
        _popcount_rows(t.z & gf2_torch.words32(x_flips_packed)[:, None, :])
        + _popcount_rows(t.x & gf2_torch.words32(z_flips_packed)[:, None, :])
    ) & 1
    return t.replace(r=t.r ^ anti.to(torch.uint8))


def select(mask, new: PackedTableau, old: PackedTableau) -> PackedTableau:
    m = mask.to(torch.bool)
    mw = -(m.to(torch.int32))  # all-ones words where set
    return PackedTableau(
        tb._blend(mw[:, None, None], new.x, old.x),
        tb._blend(mw[:, None, None], new.z, old.z),
        tb._blend(-(m.to(torch.uint8))[:, None], new.r, old.r),
        old.n,
    )


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _g_sum_words(x1, z1, x2, z2) -> torch.Tensor:
    """Bit-sliced Aaronson-Gottesman phase sum: sum over qubit positions of
    g(x1, z1, x2, z2), where inputs are packed words. Returns int32 with
    the same leading shape (P - M, each position contributing -1/0/+1).

    The Aaronson-Gottesman case analysis:
      source Y (x1 z1): +1 where target is Z-only, -1 where X-only
      source X        : +1 where target is Y,     -1 where Z-only
      source Z        : +1 where target is X-only, -1 where Y
    """
    nx1, nz1 = ~x1, ~z1
    nx2, nz2 = ~x2, ~z2
    plus = (x1 & z1 & z2 & nx2) | (x1 & nz1 & x2 & z2) | (nx1 & z1 & x2 & nz2)
    minus = (x1 & z1 & x2 & nz2) | (x1 & nz1 & nx2 & z2) | (nx1 & z1 & x2 & z2)
    return _popcount_rows(plus) - _popcount_rows(minus)


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
    the reference's algorithm with rowsums over words."""
    xq = _col_bit(t.x, q)  # [B, 2n]
    is_random = xq[:, t.n:].to(torch.bool).any(dim=1)
    return _measure_column(t, q, xq, is_random, int(is_random.sum()),
                           rand_bit)


def _measure_column(t: PackedTableau, q: int, xq: torch.Tensor,
                    is_random: torch.Tensor, n_random: int,
                    rand_bit: torch.Tensor):
    """`_measure_z` given the bits of x at q, which samples' outcomes are
    random and how many; as in `tableau._measure_column`, each branch
    runs on its own samples only."""
    B, n = t.batch, t.n
    if n_random == 0:
        return t, _deterministic_outcomes(t, xq[:, :, None])[:, 0]
    if n_random == B:
        return _random_branch(t, xq, q, rand_bit)
    rs = is_random.nonzero()[:, 0]
    ds = (~is_random).nonzero()[:, 0]
    sub, out_r = _random_branch(
        PackedTableau(t.x[rs], t.z[rs], t.r[rs], n), xq[rs], q, rand_bit[rs])
    new = t.clone()
    new.x[rs], new.z[rs], new.r[rs] = sub.x, sub.z, sub.r
    outcome = torch.empty_like(rand_bit)
    outcome[rs] = out_r
    outcome[ds] = _deterministic_outcomes(
        PackedTableau(t.x[ds], t.z[ds], t.r[ds], n), xq[ds, :, None])[:, 0]
    return new, outcome


def _random_branch(t: PackedTableau, xq: torch.Tensor, q: int,
                   rand_bit: torch.Tensor):
    """The random branch on samples whose outcome is random (see
    `tableau._random_branch`; every target row but the destabilizer
    p - n commutes with row p, so the phase exponent is even)."""
    B, n, W = t.batch, t.n, t.words
    dev = t.x.device
    bidx = torch.arange(B, device=dev)
    p_row = n + torch.argmax(xq[:, n:], dim=1)
    px, pz, pr = t.x[bidx, p_row], t.z[bidx, p_row], t.r[bidx, p_row]
    targets = xq.clone()  # [B, 2n] 0/1
    targets[bidx, p_row] = 0
    g = _g_sum_words(px[:, None, :], pz[:, None, :], t.x, t.z)  # [B, 2n]
    half = ((g >> 1) & 1).to(torch.uint8)
    new_r = t.r ^ (targets & (pr[:, None] ^ half))
    tw = -(targets.to(torch.int32))[:, :, None]  # all-ones words on targets
    new_x = t.x ^ (tw & px[:, None, :])
    new_z = t.z ^ (tw & pz[:, None, :])
    new_x[bidx, p_row - n] = px
    new_z[bidx, p_row - n] = pz
    new_r[bidx, p_row - n] = pr
    w, b = _addr(q)
    zq_word = torch.zeros(W, dtype=torch.int32, device=dev)
    zq_word[w] = _mask(b)
    new_x[bidx, p_row] = 0
    new_z[bidx, p_row] = zq_word
    new_r[bidx, p_row] = rand_bit
    return PackedTableau(new_x, new_z, new_r, n), rand_bit


def _deterministic_outcomes(t: PackedTableau,
                            cols: torch.Tensor) -> torch.Tensor:
    """The deterministic branch of `_measure_z` for M qubits at once (cols
    = their bits of x, [B, 2n, M]): the closed-form commuting-product
    phase (see `tableau._deterministic_outcomes`); the ordered pair term
    needs only its parity, so the exclusive prefix of the selected z rows
    is a cumulative XOR over packed words. Returns [B, M] uint8."""
    n = t.n
    m = cols[:, :n, :].transpose(1, 2)  # [B, M, n] selected rows, 0/1
    mw = -(m.to(torch.int32))[:, :, :, None]
    sx = t.x[:, None, n:, :] & mw  # [B, M, n, W]
    sz = t.z[:, None, n:, :] & mw
    prefix_excl = _prefix_xor(sz, 2) ^ sz
    pair_parity = _popcount_rows(sx & prefix_excl).sum(dim=2) & 1
    y = _popcount_rows(t.x[:, n:, :] & t.z[:, n:, :])  # [B, n]
    base = (m.to(torch.int32)
            * (2 * t.r[:, n:].to(torch.int32) + y)[:, None, :]).sum(-1)
    return (((base + 2 * pair_parity) % 4) // 2).to(torch.uint8)


def _columns(t: PackedTableau, qs: list[int]) -> torch.Tensor:
    """The bits of x at qubits ``qs``: [B, 2n, M] uint8 (shifts of one
    word column when the qubits share a word, as a block's do)."""
    dev = t.x.device
    words = [q // WORD for q in qs]
    b = torch.tensor([q % WORD for q in qs], device=dev, dtype=torch.int32)
    if len(set(words)) == 1:
        x = t.x[:, :, words[0]:words[0] + 1]
    else:
        x = t.x[:, :, torch.tensor(words, device=dev)]
    return ((x >> b) & 1).to(torch.uint8)


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
    version of K9, in which a run of qubits whose outcomes are
    deterministic in every sample is read at once (measuring such a qubit
    leaves the state as it is).
    Collapse bits ``rand_bits`` [B, M], or one [B, M] draw from
    ``generator`` (`tableau.collapse_bits`). Returns
    (state, outcomes [B, M] uint8)."""
    qs = host_qubits(qubits)
    bits = tb.resolve_collapse_bits(generator, rand_bits, t.batch,
                                    len(qs), t.x.device)
    outs = torch.empty_like(bits)
    n = t.n
    cap = max(1, (1 << 26) // (4 * t.batch * n * t.words))  # [B, M, n, W]
    m = 0
    while m < len(qs):
        cols = _columns(t, qs[m:m + cap])  # [B, 2n, M']
        rnd = cols[:, n:].to(torch.bool).any(dim=1)  # [B, M']
        counts = rnd.sum(dim=0).tolist()  # one host read
        k = next((i for i, c in enumerate(counts) if c), len(counts))
        if k:  # deterministic in every sample: the state stays as it is
            outs[:, m:m + k] = _deterministic_outcomes(t, cols[:, :, :k])
            m += k
        else:
            t, outs[:, m] = _measure_column(t, qs[m], cols[:, :, 0],
                                            rnd[:, 0], counts[0], bits[:, m])
            m += 1
    return t, outs


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
