"""CSS-code construction: validation, standard-form reduction, stabilizer
generators, logical operators, syndrome tables, transversal-gate
classification, plus a library of standard code families."""

from qcss_tpu_torch.codes.css import CSSCode
from qcss_tpu_torch.codes.pauli import PauliOperator, pauli_for_row
from qcss_tpu_torch.codes.qecc import QECC
from qcss_tpu_torch.codes import families

__all__ = ["CSSCode", "QECC", "PauliOperator", "pauli_for_row", "families"]
