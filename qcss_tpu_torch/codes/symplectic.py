"""Symplectic (check-matrix) conjugation of Clifford circuits.

The reference verifies encoding networks without any quantum simulation by
conjugating a ``[k, 2n]`` stabilizer check matrix through an H/CNOT circuit
(reference: css_code.py:737-781, used by test/test_css_code.py:61-106).
Here that is a vectorized column update per gate; the full phase-tracking
generalization lives in `qcss_tpu_torch.sim.tableau` (this module is its
destabilizer- and phase-free special case).

Check-matrix layout: columns [0, n) are X components, [n, 2n) are Z
components, one Pauli per row.
"""

import numpy as np

from qcss_tpu_torch.circuits.ir import Circuit, GateInst


def conjugate_h(mat: np.ndarray, qubit: int) -> None:
    """Conjugate by H on `qubit`: swap X and Z columns. Raises
    NotImplementedError if any row carries Y on the qubit (reference:
    css_code.py:757-767 restricts itself to CSS-type rows)."""
    n = mat.shape[1] // 2
    q = qubit
    if np.any(mat[:, q] & mat[:, n + q]):
        raise NotImplementedError("only handles CSS codes (no Y component)")
    mat[:, [q, n + q]] = mat[:, [n + q, q]]


def conjugate_cnot(mat: np.ndarray, control: int, target: int) -> None:
    """Conjugate by CNOT: X propagates control->target, Z propagates
    target->control (reference: css_code.py:769-781)."""
    n = mat.shape[1] // 2
    c, t = control, target
    mat[:, t] ^= mat[:, c]
    mat[:, n + c] ^= mat[:, n + t]


_CONJUGATORS = {"H": conjugate_h, "CNOT": conjugate_cnot}


def transform_stabilisers(mat: np.ndarray, circuit: Circuit) -> None:
    """Conjugate `mat` in place through every gate of `circuit`.

    Only H and CNOT are supported, matching the reference's verifier
    (reference: css_code.py:737-755); other gates raise ValueError.
    """
    _, cols = mat.shape
    n = cols // 2
    for inst in circuit:
        if not isinstance(inst, GateInst):
            raise ValueError("circuit must only contain gates")
        if any(q >= n for q in inst.qubits):
            raise ValueError("qubit index must be within [0, n)")
        fn = _CONJUGATORS.get(inst.name)
        if fn is None:
            raise ValueError(f"cannot conjugate gate {inst.name}")
        fn(mat, *inst.qubits)
