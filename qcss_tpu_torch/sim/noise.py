"""Explicit, seeded Pauli noise channels (PyTorch port of `qcss_tpu.sim.noise`).

The noise description (`NoiseModel`) and the threshold layout of the
single-qubit channel are the reference's, so frames and tableaus sampled
here follow the same fault distribution. Randomness comes from an
explicit `torch.Generator`; its stream differs from JAX's threefry keys,
so the two packages agree in distribution, not bit for bit.

`sampled_fault_bits` draws a circuit's gate faults for both simulators:
the frame engines (`sim.frame`) and the tableau's `run_arrays_noisy`
take the same bits from the same draws, so they consume a generator
identically. The channels below it act on a `sim.tableau.Tableau` and
inject their flips through `apply_pauli_frame`. The traced-rate surface
(`flat_rates`/`view`) is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from qcss_tpu_torch.circuits.ir import OPCODES
from qcss_tpu_torch.sim import tableau as tb

_TWO_Q_START = OPCODES["CNOT"]

@dataclass(frozen=True)
class NoiseModel:
    """Circuit-level stochastic Pauli noise.

    p_gate1 / p_gate2: depolarizing probability after each 1q/2q gate
    (uniform over the 3 / 15 non-identity Paulis on the touched qubits).
    p_meas: classical bit-flip probability on each measurement outcome.
    p_reset: probability a reset leaves |1> instead of |0> (applied as an
    X flip after the reset).

    pauli1 / pauli2: optional biased per-qubit Pauli rates (p_x, p_y, p_z)
    that OVERRIDE the uniform split — pauli1 for 1q-gate locations, pauli2
    applied independently to each qubit of a 2q-gate location. When set,
    p_gate1/p_gate2 must hold the corresponding totals (they gate whether
    a noise location is emitted at all); use `from_decoherence`, which
    keeps them consistent.

    p_idle / pauli_idle: idle noise locations, kept for parity with the
    reference's field set; the memory experiment refuses p_idle != 0.
    """

    p_gate1: float = 0.0
    p_gate2: float = 0.0
    p_meas: float = 0.0
    p_reset: float = 0.0
    pauli1: tuple[float, float, float] | None = None
    pauli2: tuple[float, float, float] | None = None
    p_idle: float = 0.0
    pauli_idle: tuple[float, float, float] | None = None

    @property
    def is_trivial(self) -> bool:
        return not (self.p_gate1 or self.p_gate2 or self.p_meas or self.p_reset)

    @property
    def rate1(self):
        """1q-location channel: (p_x, p_y, p_z) if biased, else the scalar
        uniform-depolarizing total."""
        return self.pauli1 if self.pauli1 is not None else self.p_gate1

    @property
    def rate2(self):
        """2q-location channel: (p_x, p_y, p_z) per touched qubit if
        biased, else the scalar 15-way-depolarizing total."""
        return self.pauli2 if self.pauli2 is not None else self.p_gate2

    @classmethod
    def from_decoherence(cls, t1: float, t2: float,
                         gate_time_1q: float = 50e-9,
                         gate_time_2q: float = 150e-9,
                         ro_fidelity: float = 1.0,
                         idle_time: float | None = None) -> "NoiseModel":
        """Pauli-twirled T1/T2 decoherence: over a gate of duration t,
        p_x = p_y = (1 - e^(-t/T1))/4 and
        p_z = (1 - e^(-t/T2))/2 - (1 - e^(-t/T1))/4
        (e.g. Ghosh et al., PRA 86, 062318). Requires t2 <= 2*t1. 2q gates
        decohere both qubits independently for gate_time_2q."""
        if t2 > 2 * t1:
            raise ValueError("unphysical decoherence: T2 must be <= 2*T1")

        def twirl(t):
            gamma = 1.0 - math.exp(-t / t1)
            lam = 1.0 - math.exp(-t / t2)
            px = py = gamma / 4.0
            pz = max(lam / 2.0 - gamma / 4.0, 0.0)
            return (px, py, pz)

        r1 = twirl(gate_time_1q)
        r2 = twirl(gate_time_2q)
        ri = twirl(idle_time) if idle_time is not None else None
        return cls(
            p_gate1=sum(r1), p_gate2=sum(r2),
            p_meas=1.0 - ro_fidelity, p_reset=0.0,
            pauli1=r1, pauli2=r2,
            p_idle=sum(ri) if ri is not None else 0.0,
            pauli_idle=ri,
        )


def _thresholds_1q(p):
    """Cumulative event thresholds (x_hi, z_lo, z_hi) over u ~ U[0,1).
    Event layout: X on [0, p_x), Y on [p_x, p_x+p_y), Z on
    [p_x+p_y, p_x+p_y+p_z); an X-component flip fires for u < x_hi =
    p_x+p_y, a Z-component flip for z_lo = p_x <= u < z_hi = p_x+p_y+p_z.
    Scalar p means the uniform p/3 split."""
    if isinstance(p, tuple):
        px, py, pz = p
        return px + py, px, px + py + pz
    return 2.0 * p / 3.0, p / 3.0, p


def flip_bits(bits: torch.Tensor, p, generator: torch.Generator) -> torch.Tensor:
    """Classical readout noise: flip each bit with probability p."""
    u = torch.rand(bits.shape, generator=generator, device=bits.device)
    return bits ^ (u < p).to(bits.dtype)


def sampled_fault_bits(ops, model: NoiseModel, generator: torch.Generator,
                       batch: int) -> torch.Tensor:
    """[B, 4G] uint8 fault bits, four per gate: (x_a, z_a, x_b, z_b).
    1q gates draw one uniform each (their last two bits stay zero); 2q
    gates draw a hit uniform and a pattern in [1, 16) whose bits 0..3 are
    (x_a, z_a, x_b, z_b) — or, when ``model.pauli2`` is set, one (B, 2)
    biased draw, one per touched qubit. The structure of the reference's
    draws (sim/frame.py `_inject1`/`_inject2`); the numbers are torch's,
    drawn on the generator's device."""
    device = generator.device
    ops = tb.host_qubits(ops)
    G = len(ops)
    out = torch.zeros((batch, 4 * G), dtype=torch.uint8, device=device)
    idx_1q = [g for g, op in enumerate(ops) if op < _TWO_Q_START]
    idx_2q = [g for g, op in enumerate(ops) if op >= _TWO_Q_START]
    if idx_1q:
        x_hi, z_lo, z_hi = _thresholds_1q(model.rate1)
        u = torch.rand((len(idx_1q), batch), generator=generator,
                       device=device)
        base = 4 * torch.as_tensor(idx_1q, device=device)
        out[:, base] = (u < x_hi).T.to(torch.uint8)
        out[:, base + 1] = ((u >= z_lo) & (u < z_hi)).T.to(torch.uint8)
    if idx_2q:
        rate2 = model.rate2
        base = 4 * torch.as_tensor(idx_2q, device=device)
        if isinstance(rate2, tuple):
            x_hi, z_lo, z_hi = _thresholds_1q(rate2)
            u = torch.rand((len(idx_2q), batch, 2), generator=generator,
                           device=device)
            x_hit = (u < x_hi).to(torch.uint8)
            z_hit = ((u >= z_lo) & (u < z_hi)).to(torch.uint8)
            out[:, base] = x_hit[:, :, 0].T
            out[:, base + 1] = z_hit[:, :, 0].T
            out[:, base + 2] = x_hit[:, :, 1].T
            out[:, base + 3] = z_hit[:, :, 1].T
        else:
            hit = (torch.rand((len(idx_2q), batch), generator=generator,
                              device=device) < rate2).to(torch.uint8)
            pat = torch.randint(1, 16, (len(idx_2q), batch),
                                generator=generator, device=device)
            for bit in range(4):
                out[:, base + bit] = (((pat >> bit) & 1).to(torch.uint8)
                                      * hit).T
    return out


# ---------------------------------------------------------------------------
# Channels on a stabilizer tableau
# ---------------------------------------------------------------------------

def _hits_1q(u: torch.Tensor, p):
    """(x_hit, z_hit) of the single-qubit channel from uniforms u."""
    x_hi, z_lo, z_hi = _thresholds_1q(p)
    return u < x_hi, (u >= z_lo) & (u < z_hi)


def _hits_2q(generator: torch.Generator, shape, p):
    """(x1, z1, x2, z2) of the 15-way channel: a hit uniform, then a
    uniform non-identity pattern in [1, 16), two bits per qubit."""
    device = generator.device
    hit = (torch.rand(shape, generator=generator, device=device) < p
           ).to(torch.int64)
    pat = torch.randint(1, 16, shape, generator=generator, device=device)
    return tuple((pat >> k) & 1 & hit for k in range(4))


def depolarize1(t: tb.Tableau, q: int, p,
                generator: torch.Generator) -> tb.Tableau:
    """Single-qubit Pauli channel on qubit q: uniform depolarizing for
    scalar p (X/Y/Z each with probability p/3), biased for p=(px,py,pz)."""
    u = torch.rand((t.batch, 1), generator=generator, device=generator.device)
    return tb.inject_flips(t, [q], *_hits_1q(u, p))


def depolarize2(t: tb.Tableau, q1: int, q2: int, p,
                generator: torch.Generator) -> tb.Tableau:
    """Two-qubit noise location: for scalar p, one of the 15 non-identity
    two-qubit Paulis with probability p/15 each; for p=(px,py,pz), the
    biased 1q channel applied independently to each qubit."""
    if isinstance(p, tuple):
        return depolarize1_many(t, [q1, q2], p, generator)
    x1, z1, x2, z2 = _hits_2q(generator, (t.batch, 1), p)
    return tb.inject_flips(t, [q1, q2], torch.cat([x1, x2], 1),
                   torch.cat([z1, z2], 1))


def depolarize1_many(t: tb.Tableau, qubits, p,
                     generator: torch.Generator) -> tb.Tableau:
    """IID single-qubit Pauli channel on a set of qubits, fused into one
    Pauli-frame injection. p: scalar (uniform) or (px, py, pz) (biased)."""
    m = len(tb.host_qubits(qubits))
    u = torch.rand((t.batch, m), generator=generator, device=generator.device)
    return tb.inject_flips(t, qubits, *_hits_1q(u, p))


def depolarize2_many(t: tb.Tableau, controls, targets, p,
                     generator: torch.Generator) -> tb.Tableau:
    """IID two-qubit noise on m disjoint qubit pairs, fused into one
    Pauli-frame injection. Scalar p: 15-way depolarizing per pair;
    p=(px,py,pz): the biased 1q channel independently on every touched
    qubit."""
    c, q = tb.host_qubits(controls), tb.host_qubits(targets)
    if isinstance(p, tuple):
        return depolarize1_many(t, c + q, p, generator)
    x1, z1, x2, z2 = _hits_2q(generator, (t.batch, len(c)), p)
    return tb.inject_flips(t, c + q, torch.cat([x1, x2], 1),
                           torch.cat([z1, z2], 1))


def noisy_gate(t: tb.Tableau, name: str, qubits: tuple[int, ...],
               model: NoiseModel, generator: torch.Generator) -> tb.Tableau:
    """Apply a gate followed by its depolarizing noise location."""
    t = tb.apply_gate(t, name, *qubits)
    if len(qubits) == 1:
        if model.p_gate1:
            t = depolarize1(t, qubits[0], model.rate1, generator)
    elif model.p_gate2:
        t = depolarize2(t, qubits[0], qubits[1], model.rate2, generator)
    return t


def run_arrays_noisy(t: tb.Tableau, ops, q0, q1, model: NoiseModel,
                     generator: torch.Generator | None = None, *,
                     fault_bits: torch.Tensor | None = None) -> tb.Tableau:
    """An array-lowered circuit with a depolarizing location after every
    gate, on one clone of the tableau. The fault bits come from
    ``fault_bits`` ([B, 4G], `sampled_fault_bits`' layout) or are drawn
    from ``generator`` by `sampled_fault_bits`, exactly as the frame
    engines draw them; gate g's bits flip the signs of the rows that
    anticommute with them (`tableau.apply_pauli_frame` on its qubits)."""
    if model.is_trivial or not (model.p_gate1 or model.p_gate2):
        return tb.run_circuit_scanned(t, ops, q0, q1)
    ops, q0, q1 = tb.host_qubits(ops), tb.host_qubits(q0), tb.host_qubits(q1)
    bits = fault_bits
    if bits is None:
        bits = sampled_fault_bits(ops, model, generator, t.batch)
    x, z, r = t.clone()
    for g, (op, a, b) in enumerate(zip(ops, q0, q1)):
        tb._apply_op(x, z, r, op, a, b)
        r ^= (bits[:, 4 * g, None] & z[:, :, a]) \
            ^ (bits[:, 4 * g + 1, None] & x[:, :, a])
        if op >= _TWO_Q_START:
            r ^= (bits[:, 4 * g + 2, None] & z[:, :, b]) \
                ^ (bits[:, 4 * g + 3, None] & x[:, :, b])
    return tb.Tableau(x, z, r)


def run_circuit_noisy(t: tb.Tableau, circuit, model: NoiseModel,
                      generator: torch.Generator) -> tb.Tableau:
    """Run a circuit inserting a depolarizing location after every gate:
    `run_arrays_noisy` on its array form (the frame sampler's draws)."""
    return run_arrays_noisy(t, *circuit.to_arrays(), model, generator)
