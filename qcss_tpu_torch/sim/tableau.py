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


def _index(qubits, device):
    """The columns of ``qubits``: a slice (views, no gather) when they are
    a contiguous increasing run, as a code block's are, else an index
    tensor."""
    qs = host_qubits(qubits)
    if qs and qs == list(range(qs[0], qs[0] + len(qs))):
        return slice(qs[0], qs[0] + len(qs))
    return torch.as_tensor(qs, dtype=torch.int64, device=device)


def apply_h_many(t: Tableau, qubits) -> Tableau:
    q = _index(qubits, t.x.device)
    x, z, r = t.clone()
    xq, zq = x[:, :, q].clone(), z[:, :, q].clone()
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


def _blend(m: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """``new`` where the uint8 mask ``m`` (broadcast; 0 or 0xFF) is set,
    else ``old``: two bit operations, where ``torch.where`` on bytes is an
    order of magnitude slower on the CPU."""
    return old ^ ((new ^ old) & m)


def select(mask: torch.Tensor, new: Tableau, old: Tableau) -> Tableau:
    """Per-sample select: take `new` where mask[b] else `old`."""
    m = -(mask.to(torch.bool).to(torch.uint8))  # 0 or 0xFF
    return Tableau(
        _blend(m[:, None, None], new.x, old.x),
        _blend(m[:, None, None], new.z, old.z),
        _blend(m[:, None], new.r, old.r),
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
    xf = x_flips.to(torch.uint8)[:, None, :]
    zf = z_flips.to(torch.uint8)[:, None, :]
    flips = _parity_reduce((t.z[:, :, q] & xf) ^ (t.x[:, :, q] & zf))
    return Tableau(t.x, t.z, t.r ^ flips)


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


def _measure_z(t: Tableau, q: int, rand_bit: torch.Tensor):
    """One Z measurement of qubit q with collapse bits ``rand_bit`` [B]."""
    xq = t.x[:, :, q]  # [B, 2n]
    is_random = xq[:, t.n:].to(torch.bool).any(dim=1)  # [B]
    return _measure_column(t, q, xq, is_random, int(is_random.sum()),
                           rand_bit)


def _measure_column(t: Tableau, q: int, xq: torch.Tensor,
                    is_random: torch.Tensor, n_random: int,
                    rand_bit: torch.Tensor):
    """`_measure_z` given column q of x, which samples' outcomes are
    random (some stabilizer row anticommutes with Z_q) and how many: the
    random samples take the Aaronson-Gottesman row updates, the others
    the closed-form deterministic outcome, each branch on its own samples
    only."""
    B, n = t.batch, t.n
    if n_random == 0:
        return t, _deterministic_outcomes(t, xq[:, :, None])[:, 0]
    if n_random == B:
        return _random_branch(t, xq, q, rand_bit)
    rs = is_random.nonzero()[:, 0]
    ds = (~is_random).nonzero()[:, 0]
    sub, out_r = _random_branch(Tableau(t.x[rs], t.z[rs], t.r[rs]), xq[rs],
                                q, rand_bit[rs])
    x, z, r = t.clone()
    x[rs], z[rs], r[rs] = sub
    outcome = torch.empty_like(rand_bit)
    outcome[rs] = out_r
    outcome[ds] = _deterministic_outcomes(
        Tableau(t.x[ds], t.z[ds], t.r[ds]), xq[ds, :, None])[:, 0]
    return Tableau(x, z, r), outcome


def _random_branch(t: Tableau, xq: torch.Tensor, q: int,
                   rand_bit: torch.Tensor):
    """The random branch of `_measure_z` on samples whose outcome is
    random (xq = column q of x): the first anticommuting stabilizer row p
    is multiplied into every other row with x_iq = 1, copied into its
    destabilizer slot, and becomes +/- Z_q with the collapse bit as its
    sign, which is the outcome."""
    B, n = t.batch, t.n
    dev = t.x.device
    bidx = torch.arange(B, device=dev)
    p_row = n + torch.argmax(xq[:, n:], dim=1)  # the first (lowest) one
    px, pz, pr = t.x[bidx, p_row], t.z[bidx, p_row], t.r[bidx, p_row]
    targets = xq.clone()  # [B, 2n] 0/1
    targets[bidx, p_row] = 0
    # rowsum(i, p): the phase exponent sum_j g(p_j, row_ij), by the kind
    # of the source Pauli at j (Y, X or Z), is
    #   z.(pY - pX) + x.(pZ - pY) + 2 (x & z).(pX - pZ);
    # every target but the destabilizer p - n (overwritten below)
    # commutes with row p, so the exponent is even and the new sign is
    # r_i ^ r_p ^ (exponent / 2 mod 2) (int8 sums wrap mod 256).
    p_y = px & pz
    p_x, p_z = (px ^ p_y).view(torch.int8), (pz ^ p_y).view(torch.int8)
    p_y = p_y.view(torch.int8)
    x8, z8 = t.x.view(torch.int8), t.z.view(torch.int8)
    g = (z8 * (p_y - p_x)[:, None, :] + x8 * (p_z - p_y)[:, None, :]
         + (x8 & z8) * (2 * (p_x - p_z))[:, None, :]).sum(
             dim=-1, dtype=torch.int8)
    half = ((g >> 1) & 1).view(torch.uint8)
    new_r = t.r ^ (targets & (pr[:, None] ^ half))
    new_x = t.x ^ (targets[:, :, None] & px[:, None, :])
    new_z = t.z ^ (targets[:, :, None] & pz[:, None, :])
    # row p into its destabilizer slot, then row p = +/- Z_q
    new_x[bidx, p_row - n] = px
    new_z[bidx, p_row - n] = pz
    new_r[bidx, p_row - n] = pr
    new_x[bidx, p_row] = 0
    new_z[bidx, p_row] = (torch.arange(n, device=dev) == q).to(torch.uint8)
    new_r[bidx, p_row] = rand_bit
    return Tableau(new_x, new_z, new_r), rand_bit


def _deterministic_outcomes(t: Tableau, cols: torch.Tensor) -> torch.Tensor:
    """The deterministic branch of `_measure_z` for M qubits at once
    (cols = their columns of x, [B, 2n, M]; each outcome deterministic):
    the sign of the product of the stabilizer rows n+i whose
    destabilizers anticommute with Z_q. The rows commute, so the ordered
    product's phase is
      i^( sum_i m_i (2 r_i + |x_i & z_i|) + 2 * sum_{j<l} m_j m_l z_j . x_l )
    and only the parity of the pair term counts. The pair term is
    m^T U m with U the strictly upper triangle of the row products
    Z X^T mod 2: integer matmuls in float32, exact while n(n + 2) < 2^24.
    Returns [B, M] uint8."""
    n = t.n
    m = cols[:, :n, :].transpose(1, 2).to(torch.float32)  # [B, M, n]
    xs, zs = t.x[:, n:, :], t.z[:, n:, :]
    products = torch.matmul(zs.to(torch.float32),
                            xs.to(torch.float32).transpose(1, 2))
    upper = torch.triu(torch.remainder(products, 2), diagonal=1)
    pair = (torch.matmul(m, upper) * m).sum(dim=-1)  # [B, M]
    y = (xs & zs).sum(dim=-1, dtype=torch.int32)  # [B, n]
    weight = (2 * t.r[:, n:].to(torch.int32) + y).to(torch.float32)
    base = torch.matmul(m, weight[:, :, None])[:, :, 0]  # [B, M]
    return (((base + 2 * pair).to(torch.int64) >> 1) & 1).to(torch.uint8)


def measure_z(t: Tableau, q: int, generator: torch.Generator | None = None,
              *, rand_bit: torch.Tensor | None = None):
    """Measure qubit q in the Z basis across the batch.

    Per sample: if some stabilizer row anticommutes with Z_q the outcome is
    random (the tableau is updated by the AG row operations, the outcome
    is the sample's collapse bit); otherwise it is deterministic (the sign
    of the product of stabilizers whose destabilizer partners
    anticommute). Each branch runs on its own samples only. The collapse
    bits are ``rand_bit`` [B] or drawn from ``generator``. Returns
    (new_tableau, outcomes [B] uint8)."""
    t, out = measure_many(t, [q], generator, rand_bits=None
                          if rand_bit is None else rand_bit[:, None])
    return t, out[:, 0]


def measure_many(t: Tableau, qubits, generator: torch.Generator | None = None,
                 *, rand_bits: torch.Tensor | None = None):
    """Measure a sequence of qubits in Z, in order. Collapse bits:
    ``rand_bits`` [B, M] or one [B, M] draw from ``generator``; column m
    serves qubit m. Measuring a qubit whose outcome is deterministic in
    every sample leaves the state as it is, so a run of such qubits is
    read at once. Returns (state, outcomes [B, M] uint8)."""
    qs = host_qubits(qubits)
    bits = resolve_collapse_bits(generator, rand_bits, t.batch, len(qs),
                                 t.x.device)
    outs = torch.empty_like(bits)
    n = t.n
    cap = max(1, (1 << 26) // (4 * t.batch * n))  # [B, M, n] float32 temps
    m = 0
    while m < len(qs):
        cols = t.x[:, :, _index(qs[m:m + cap], t.x.device)]  # [B, 2n, M']
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
        # X on q where the outcome was 1: signs of the rows holding Z on q
        t = Tableau(t.x, t.z, t.r ^ (outcome[:, None] & t.z[:, :, q]))
    return t
