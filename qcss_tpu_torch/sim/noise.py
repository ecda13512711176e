"""Explicit, seeded Pauli noise channels (PyTorch port of `qcss_tpu.sim.noise`).

The noise description (`NoiseModel`) and the threshold layout of the
single-qubit channel are the reference's, so frames sampled here follow
the same fault distribution. Randomness comes from an explicit
`torch.Generator`; its stream differs from JAX's threefry keys, so the
two packages agree in distribution, not bit for bit. The traced-rate
surface (`flat_rates`/`view`) and the tableau channels are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


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
