"""The CSS quantum error-correcting code model.

Construction-time math (validation, standard-form reduction with mirrored
qubit swaps, syndrome tables, transversal-gate classification, logical
operator matrices) runs on the host with exact GF(2) kernels and is
bit-exact against the reference (reference: css_code.py:21-201,715-850).

For the device hot path the code exposes cached JAX arrays: the parity
checks (dense int8 and bit-packed uint32), dense ``[2^r, n]`` correction
LUTs, and logical operator rows — consumed by `qcss_tpu_torch.decode` and
`qcss_tpu_torch.sim`.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from qcss_tpu_torch.circuits import encoding
from qcss_tpu_torch.codes.pauli import PauliOperator, pauli_for_row
from qcss_tpu_torch.codes.qecc import QECC
from qcss_tpu_torch.errors import InvalidCodeError
from qcss_tpu_torch.ops import gf2

# Gate-name aliases accepted by `is_transversal`; the reference registers
# the phase gate as 'S' but its own test asks for 'PHASE'
# (reference: css_code.py:199 vs test/test_css_code.py:25) — accept both.
_GATE_ALIASES = {"PHASE": "S"}


class CSSCode(QECC):
    """A Calderbank-Steane-Shor code defined by two classical binary codes
    C_1, C_2 with the dual of C_2 a subspace of C_1.

    Physical qubits form a codeword of C_1 in the X basis and of C_2 in the
    Z basis (the reference's convention — reference: css_code.py:21-31).

    Parameters
    ----------
    parity_check_c1, parity_check_c2:
        Binary parity-check matrices of equal width n.
    max_table_weight:
        Bound syndrome-table enumeration (LUT decoding is exponential in the
        number of checks; large-distance codes only need syndrome
        *extraction*). None = enumerate until the unique-decoding threshold
        is found, as the reference does.
    t:
        Explicit unique-decoding threshold. When given together with
        ``max_table_weight=0``, table construction is skipped entirely.
    require_k1:
        The reference supports only k=1 codes (reference: css_code.py:74-75)
        and the FT transpiler relies on it; pass False to construct k>1
        codes (e.g. toric) for syndrome-extraction / decoding use only.
    """

    def __init__(
        self,
        parity_check_c1,
        parity_check_c2,
        *,
        max_table_weight: int | None = None,
        t: int | None = None,
        require_k1: bool = True,
    ):
        h_1 = np.asarray(parity_check_c1)
        h_2 = np.asarray(parity_check_c2)
        r_1, n_1 = h_1.shape
        r_2, n_2 = h_2.shape
        if n_1 != n_2:
            raise ValueError("C_1 and C_2 must have the same code word length")
        if not np.array_equal(h_1 & 1, h_1):
            raise ValueError("C_1 parity check matrix must be binary")
        if not np.array_equal(h_2 & 1, h_2):
            raise ValueError("C_2 parity check matrix must be binary")
        h_1 = h_1.astype(np.uint8)
        h_2 = h_2.astype(np.uint8)

        # Duality: every X check must commute with every Z check.
        if np.any((h_1.astype(np.int64) @ h_2.T.astype(np.int64)) & 1):
            raise ValueError("C_2 dual code must be a subspace of C_1")

        # Standard form: H_1 -> [I A1 A2] (identity at column 0) and
        # H_2 -> [D I E] (identity at column r_1); every column (= qubit)
        # swap in one matrix is mirrored into the other
        # (reference: css_code.py:51-61).
        # The pre-row-reduction checks are kept (with the same qubit
        # relabeling) as raw_parity_check_c*: row reduction destroys check
        # locality, which matching decoders (`decode.uf`) rely on.
        raw_1 = h_1.copy()
        raw_2 = h_2.copy()
        # Net input-order -> internal-order qubit permutation: internal
        # column c corresponds to input column column_perm[c]. Lets callers
        # map auxiliary per-qubit data (e.g. a redundant qLDPC check set)
        # into the code's internal qubit order.
        perm = np.arange(n_1)
        h_1, swaps = gf2.normalize_parity_check(h_1, offset=0)
        for i, j in swaps:
            gf2.swap_columns(h_2, i, j)
            gf2.swap_columns(raw_1, i, j)
            gf2.swap_columns(raw_2, i, j)
            perm[i], perm[j] = perm[j], perm[i]
        h_2, swaps = gf2.normalize_parity_check(h_2, offset=r_1)
        for i, j in swaps:
            gf2.swap_columns(h_1, i, j)
            gf2.swap_columns(raw_1, i, j)
            gf2.swap_columns(raw_2, i, j)
            perm[i], perm[j] = perm[j], perm[i]
        self.column_perm = perm

        self._n = n_1
        self._k = n_1 - r_1 - r_2
        self.r_1 = r_1
        self.r_2 = r_2
        self.parity_check_c1 = h_1
        self.parity_check_c2 = h_2
        self.raw_parity_check_c1 = raw_1
        self.raw_parity_check_c2 = raw_2

        if t is not None and max_table_weight == 0:
            self._t = t
            self.c1_syndromes: dict[int, np.ndarray] = {}
            self.c2_syndromes: dict[int, np.ndarray] = {}
        elif max_table_weight is not None:
            # An explicit weight bound selects the degeneracy-aware
            # minimum-weight decoder tables: the reference's collision-stop
            # enumeration yields a nearly-empty table for degenerate codes
            # (e.g. any surface code, where two weight-1 errors share a
            # syndrome at w=1 — see `gf2.min_weight_table`). t still follows
            # the reference's unique-decoding semantics unless overridden.
            self.c1_syndromes = gf2.min_weight_table(h_1, max_table_weight)
            self.c2_syndromes = gf2.min_weight_table(h_2, max_table_weight)
            if t is None:
                t_1, _ = gf2.syndrome_table(h_1, max_table_weight)
                t_2, _ = gf2.syndrome_table(h_2, max_table_weight)
                t = min(t_1, t_2)
            self._t = t
        else:
            # Reference-faithful default (reference: css_code.py:69-71).
            t_1, self.c1_syndromes = gf2.syndrome_table(h_1)
            t_2, self.c2_syndromes = gf2.syndrome_table(h_2)
            self._t = min(t_1, t_2) if t is None else t

        self._transversal_gates = self._determine_transversal_gates(h_1, h_2)

        if require_k1 and self._k != 1:
            raise InvalidCodeError(
                "currently only supports CSS codes for a single logical qubit"
            )

    # -- basic parameters ----------------------------------------------------

    @property
    def n(self) -> int:
        """Physical qubits per code block."""
        return self._n

    @property
    def k(self) -> int:
        """Logical qubits per code block."""
        return self._k

    @property
    def t(self) -> int:
        """Maximum number of correctable errors per block."""
        return self._t

    # -- stabilizers and logical operators ------------------------------------

    def stabilisers(self) -> list[PauliOperator]:
        """Generators of the stabilizer group: X-type rows from H_1, Z-type
        rows from H_2 (reference: css_code.py:98-111)."""
        zeros = np.zeros(self.n, dtype=np.uint8)
        out = [
            pauli_for_row(self.parity_check_c1[i], zeros) for i in range(self.r_1)
        ]
        out += [
            pauli_for_row(zeros, self.parity_check_c2[i]) for i in range(self.r_2)
        ]
        return out

    def z_operator_matrix(self) -> np.ndarray:
        """Logical Z̄ check rows ``[A2^T 0 I]`` (Z side), per Nielsen & Chuang
        §10.5.7 (reference: css_code.py:124-136)."""
        n, r1, r2, k = self.n, self.r_1, self.r_2, self.k
        mat = np.zeros((k, n), dtype=np.uint8)
        mat[:, 0:r1] = self.parity_check_c1[:, r1 + r2 : n].T
        mat[:, r1 + r2 : n] = np.eye(k, dtype=np.uint8)
        return mat

    def x_operator_matrix(self) -> np.ndarray:
        """Logical X̄ check rows ``[0 E^T I]`` (X side)
        (reference: css_code.py:149-161)."""
        n, r1, r2, k = self.n, self.r_1, self.r_2, self.k
        mat = np.zeros((k, n), dtype=np.uint8)
        mat[:, r1 : r1 + r2] = self.parity_check_c2[:, r1 + r2 : n].T
        mat[:, r1 + r2 : n] = np.eye(k, dtype=np.uint8)
        return mat

    def z_operators(self) -> list[PauliOperator]:
        mat = self.z_operator_matrix()
        zeros = np.zeros(self.n, dtype=np.uint8)
        return [pauli_for_row(zeros, mat[i]) for i in range(self.k)]

    def x_operators(self) -> list[PauliOperator]:
        mat = self.x_operator_matrix()
        zeros = np.zeros(self.n, dtype=np.uint8)
        return [pauli_for_row(mat[i], zeros) for i in range(self.k)]

    def y_operators(self) -> list[PauliOperator]:
        """Ȳ = i X̄ Z̄, with letter coefficient 1
        (reference: css_code.py:163-172)."""
        ops = [
            1j * (x_op * z_op)
            for x_op, z_op in zip(self.x_operators(), self.z_operators())
        ]
        for op in ops:
            assert op.coefficient == 1
        return ops

    # -- transversal gates -----------------------------------------------------

    def is_transversal(self, gate_name: str) -> bool:
        """Whether the logical gate is implementable by qubit-wise physical
        application (reference: css_code.py:174-201). Beyond the
        reference's Clifford set, ``T``/``TDAG`` answer via the
        triorthogonality classification (`transversal_t_power`): True when
        physical T^⊗n realizes an odd logical T power (an odd power
        generates T over the group ⟨T⟩, Cliffords included)."""
        name = _GATE_ALIASES.get(gate_name, gate_name)
        if name in ("T", "TDAG"):
            power = self.transversal_t_power
            return power is not None and power % 2 == 1
        return name in self._transversal_gates

    @staticmethod
    def _determine_transversal_gates(h_1, h_2) -> frozenset[str]:
        # Rationales per Steane, "Efficient fault-tolerant quantum computing".
        found = ["I", "CNOT"]  # I for any stabilizer code; CNOT for any CSS.
        if gf2.codes_equal(h_1, h_2):
            found += ["H", "CZ"]  # Lemma 3, Steane 1998.
            if gf2.is_doubly_even(h_1):
                found.append("S")  # doubly-even self-dual: phase gate.
        return frozenset(found)

    @property
    def transversal_gates(self) -> frozenset[str]:
        return self._transversal_gates

    @cached_property
    def transversal_t_power(self) -> int | None:
        """c such that physical ``T^⊗n`` implements logical ``T^c``, or None
        when transversal T does not preserve the codespace (k=1 codes only —
        see `gf2.transversal_t_power`). The [[15,1,3]] Reed-Muller code
        gives c=7: transversal T† implements logical T. Beyond-reference
        capability — the reference's universal-gate path is a stub that
        supports nothing (reference: css_code.py:433-434)."""
        if self._k != 1:
            return None
        return gf2.transversal_t_power(
            self.parity_check_c1, self.x_operator_matrix()[0]
        )

    # -- encoding networks ------------------------------------------------------

    def noisy_encode_zero(self, qubits=None):
        """Non-FT |0̄⟩ preparation network
        (reference: css_code.py:203-260)."""
        return encoding.encode_zero_network(self, qubits)

    def noisy_encode_plus(self, qubits=None):
        """Non-FT |+̄⟩ preparation network
        (reference: css_code.py:262-312)."""
        return encoding.encode_plus_network(self, qubits)

    # -- cached device-side arrays -----------------------------------------------

    @cached_property
    def device(self) -> "CSSCodeDeviceArrays":
        return CSSCodeDeviceArrays(self)

    def __repr__(self):
        return (
            f"CSSCode(n={self.n}, k={self.k}, t={self.t}, "
            f"r1={self.r_1}, r2={self.r_2})"
        )


class CSSCodeDeviceArrays:
    """Torch tensors derived from a CSSCode, built lazily once on the CPU;
    `to(device)` returns a copy whose tensors live on ``device``."""

    _FIELDS = ("h1", "h2", "h1_packed", "h2_packed", "logical_x",
               "logical_z", "lut_c1", "lut_c2", "flip_z_of_lut_c2",
               "flip_x_of_lut_c1")

    def __init__(self, code: CSSCode | None):
        if code is None:  # filled in by `to`
            return
        import torch

        from qcss_tpu_torch.ops import gf2_torch

        def u8(a):
            return torch.as_tensor(np.asarray(a, dtype=np.uint8))

        self.h1 = u8(code.parity_check_c1)
        self.h2 = u8(code.parity_check_c2)
        self.h1_packed = gf2_torch.pack_bits(code.parity_check_c1)
        self.h2_packed = gf2_torch.pack_bits(code.parity_check_c2)
        self.logical_x = u8(code.x_operator_matrix())
        self.logical_z = u8(code.z_operator_matrix())
        # Dense correction LUTs: syndrome int -> minimum-weight error; the
        # zero row for unknown syndromes reproduces the reference's
        # leave-unchanged behavior (reference: css_code.py:649-685).
        self.lut_c1 = (u8(gf2.correction_lut(code.parity_check_c1,
                                             code.c1_syndromes))
                       if code.c1_syndromes else None)
        self.lut_c2 = (u8(gf2.correction_lut(code.parity_check_c2,
                                             code.c2_syndromes))
                       if code.c2_syndromes else None)

        # Per-syndrome logical-flip parities (see qcss_tpu's
        # decode.montecarlo): flip[s] = parity(lut[s] . logical).
        def _flip_table(lut, logical):
            if lut is None:
                return None
            lut_np = lut.numpy().astype(np.int64)
            log_np = np.asarray(logical, dtype=np.int64)
            return u8((lut_np @ log_np.T) & 1)

        # X-sector corrections come from lut_c2 and flip logical Z̄ parity;
        # Z-sector corrections from lut_c1 flip X̄ parity.
        self.flip_z_of_lut_c2 = _flip_table(self.lut_c2,
                                            code.z_operator_matrix())
        self.flip_x_of_lut_c1 = _flip_table(self.lut_c1,
                                            code.x_operator_matrix())

    def to(self, device) -> "CSSCodeDeviceArrays":
        out = CSSCodeDeviceArrays(None)
        for name in self._FIELDS:
            val = getattr(self, name)
            setattr(out, name, None if val is None else val.to(device))
        return out
