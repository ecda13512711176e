"""End-to-end QEC experiments composed from the package's layers."""

from qcss_tpu_torch.experiments.memory import (
    memory_experiment,
    x_extraction_circuit,
    x_memory_experiment,
    z_extraction_circuit,
    z_memory_experiment,
)

__all__ = [
    "memory_experiment",
    "x_extraction_circuit",
    "x_memory_experiment",
    "z_extraction_circuit",
    "z_memory_experiment",
]
