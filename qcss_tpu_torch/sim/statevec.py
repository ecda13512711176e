"""Dense statevector simulator (numpy) — ground truth for tests only.

Covers the same gate set as the tableau simulator. Measurements report the
probability of outcome 1 and collapse to a *forced* outcome, so stochastic
tableau measurements can be replayed exactly. Little-endian qubit order:
qubit q is bit q of the basis-state index.
"""

import numpy as np

_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
_S = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
_I = np.eye(2, dtype=np.complex128)

_1Q = {"I": _I, "X": _X, "Y": _Y, "Z": _Z, "H": _H, "S": _S}


class StateVector:
    def __init__(self, n: int):
        self.n = n
        self.psi = np.zeros(2**n, dtype=np.complex128)
        self.psi[0] = 1.0

    def _apply_1q(self, mat, q: int):
        psi = self.psi.reshape(-1, 2, 1 << q)  # [high, qubit, low]
        self.psi = np.einsum("ab,hbl->hal", mat, psi).reshape(-1)

    def apply(self, name: str, *qubits: int):
        if name in _1Q:
            self._apply_1q(_1Q[name], qubits[0])
        elif name == "CNOT":
            c, t = qubits
            idx = np.arange(2**self.n)
            on = (idx >> c) & 1 == 1
            flipped = idx ^ (1 << t)
            new = self.psi.copy()
            new[idx[on]] = self.psi[flipped[on]]
            self.psi = new
        elif name == "CZ":
            a, b = qubits
            idx = np.arange(2**self.n)
            both = ((idx >> a) & 1) & ((idx >> b) & 1)
            self.psi = np.where(both == 1, -self.psi, self.psi)
        else:
            raise ValueError(f"unknown gate {name}")

    def prob_one(self, q: int) -> float:
        idx = np.arange(2**self.n)
        mask = (idx >> q) & 1 == 1
        return float(np.sum(np.abs(self.psi[mask]) ** 2))

    def collapse(self, q: int, outcome: int):
        """Project onto the given measurement outcome and renormalize."""
        idx = np.arange(2**self.n)
        keep = ((idx >> q) & 1) == outcome
        self.psi = np.where(keep, self.psi, 0)
        norm = np.linalg.norm(self.psi)
        if norm < 1e-12:
            raise ValueError("outcome has zero probability")
        self.psi /= norm

    def run_circuit(self, circuit):
        for g in circuit:
            self.apply(g.name, *g.qubits)
