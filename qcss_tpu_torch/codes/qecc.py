"""Abstract QECC interface.

The reference defines a ``QECC`` ABC with n/k/t properties that the FT
transpiler programs against (reference: qecc.py:44-64). The analogue here
is a protocol over the properties plus the hooks `qcss_tpu_torch.ftqc` needs:
encoding-network synthesis and transversal-gate classification. `CSSCode`
is the one concrete family, as in the reference; new code types implement
this protocol to plug into the transpiler.
"""

from __future__ import annotations

import abc


class QECC(abc.ABC):
    """Abstract quantum error-correcting code."""

    @property
    @abc.abstractmethod
    def n(self) -> int:
        """Physical qubits per code block."""

    @property
    @abc.abstractmethod
    def k(self) -> int:
        """Logical qubits per code block."""

    @property
    @abc.abstractmethod
    def t(self) -> int:
        """Maximum number of correctable errors per block."""

    @abc.abstractmethod
    def is_transversal(self, gate_name: str) -> bool:
        """Whether the logical gate applies qubit-wise fault-tolerantly."""

    @abc.abstractmethod
    def noisy_encode_zero(self, qubits=None):
        """Non-FT |0̄⟩ preparation network (a `circuits.ir.Circuit`)."""

    @abc.abstractmethod
    def noisy_encode_plus(self, qubits=None):
        """Non-FT |+̄⟩ preparation network (a `circuits.ir.Circuit`)."""
