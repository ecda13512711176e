"""Clifford circuit/program IR and encoding-network synthesis."""

from qcss_tpu_torch.circuits.quil import parse_quil
from qcss_tpu_torch.circuits.ir import (
    Block,
    Circuit,
    ClassicalInst,
    CLASSICAL_OPS,
    PragmaInst,
    Program,
    RepeatUntilInst,
    GateInst,
    MeasureInst,
    ResetInst,
    IfThenInst,
    DeclareInst,
    BitRef,
    CLIFFORD_1Q,
    CLIFFORD_2Q,
)

__all__ = [
    "parse_quil",
    "Block",
    "Circuit",
    "ClassicalInst",
    "CLASSICAL_OPS",
    "PragmaInst",
    "RepeatUntilInst",
    "Program",
    "GateInst",
    "MeasureInst",
    "ResetInst",
    "IfThenInst",
    "DeclareInst",
    "BitRef",
    "CLIFFORD_1Q",
    "CLIFFORD_2Q",
]
