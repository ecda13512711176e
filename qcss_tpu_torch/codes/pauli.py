"""Pauli operators in symplectic (check-matrix row) form.

The reference represents stabilizers / logical operators as pyQuil
``PauliTerm`` objects (reference: css_code.py:98-172,787-807). Here a Pauli
is a pair of GF(2) vectors (x, z) plus a power-of-i phase — the form the
tableau simulator and all device kernels consume directly; the letter view
(X/Y/Z per site) is derived for display and tests.

Internal convention: ``op = i^phase_pow * X^x * Z^z`` with the single-site
letter map X=(1,0), Z=(0,1), Y=(1,1) and ``Y = i * X * Z``.
"""

from __future__ import annotations

import numpy as np


class PauliOperator:
    __slots__ = ("x", "z", "phase_pow")

    def __init__(self, x, z, phase_pow: int = 0):
        self.x = np.asarray(x, dtype=np.uint8) & 1
        self.z = np.asarray(z, dtype=np.uint8) & 1
        if self.x.shape != self.z.shape or self.x.ndim != 1:
            raise ValueError("x and z must be 1-D vectors of equal length")
        self.phase_pow = phase_pow % 4

    # -- constructors -------------------------------------------------------

    @classmethod
    def identity(cls, n: int) -> "PauliOperator":
        return cls(np.zeros(n, np.uint8), np.zeros(n, np.uint8))

    @classmethod
    def from_letters(cls, n: int, letters: dict[int, str]) -> "PauliOperator":
        """Build from {site: 'X'|'Y'|'Z'} with letter-product coefficient 1."""
        x = np.zeros(n, np.uint8)
        z = np.zeros(n, np.uint8)
        phase = 0
        for q, letter in letters.items():
            if letter == "X":
                x[q] = 1
            elif letter == "Z":
                z[q] = 1
            elif letter == "Y":
                x[q] = 1
                z[q] = 1
                phase += 1  # Y = i X Z
            else:
                raise ValueError(f"unknown Pauli letter {letter!r}")
        return cls(x, z, phase)

    # -- algebra -------------------------------------------------------------

    @property
    def n(self) -> int:
        return self.x.size

    @property
    def coefficient(self) -> complex:
        """Coefficient relative to the tensor product of site letters."""
        n_y = int(np.count_nonzero(self.x & self.z))
        return (1j) ** ((self.phase_pow - n_y) % 4)

    def __mul__(self, other):
        if isinstance(other, PauliOperator):
            if other.n != self.n:
                raise ValueError("operator sizes differ")
            # Commute Z^z1 past X^x2: picks up (-1)^(z1 . x2).
            anti = int(np.dot(self.z.astype(int), other.x.astype(int))) % 2
            return PauliOperator(
                self.x ^ other.x,
                self.z ^ other.z,
                self.phase_pow + other.phase_pow + 2 * anti,
            )
        return self._scale(other)

    def __rmul__(self, other):
        return self._scale(other)

    def _scale(self, scalar) -> "PauliOperator":
        for p in range(4):
            if scalar == (1j) ** p:
                return PauliOperator(self.x, self.z, self.phase_pow + p)
        raise ValueError("can only scale by powers of i")

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PauliOperator)
            and np.array_equal(self.x, other.x)
            and np.array_equal(self.z, other.z)
            and self.phase_pow == other.phase_pow
        )

    def __hash__(self):
        return hash((self.x.tobytes(), self.z.tobytes(), self.phase_pow))

    def letters(self) -> list[tuple[int, str]]:
        out = []
        for q in range(self.n):
            xq, zq = self.x[q], self.z[q]
            if xq and zq:
                out.append((q, "Y"))
            elif xq:
                out.append((q, "X"))
            elif zq:
                out.append((q, "Z"))
        return out

    def __repr__(self):
        coeff = self.coefficient
        prefix = {1: "", -1: "-", 1j: "1j*", -1j: "-1j*"}[complex(coeff)]
        body = "*".join(f"{l}{q}" for q, l in self.letters()) or "I"
        return prefix + body


def pauli_for_row(x_check, z_check) -> PauliOperator:
    """Check-matrix row -> Pauli with letter coefficient 1 (Y where both
    bits set) — mirrors reference: css_code.py:787-807."""
    x_check = np.asarray(x_check)
    z_check = np.asarray(z_check)
    n = x_check.size
    if x_check.shape != (n,) or z_check.shape != (n,):
        raise ValueError("check rows have the wrong dimensions")
    n_y = int(np.count_nonzero((x_check & z_check) & 1))
    return PauliOperator(x_check, z_check, n_y)
