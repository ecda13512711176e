"""End-to-end QEC experiments composed from the package's layers."""

from qcss_tpu_torch.experiments.memory import (
    memory_experiment,
    x_extraction_circuit,
    x_memory_experiment,
    z_extraction_circuit,
    z_memory_experiment,
)
from qcss_tpu_torch.experiments.memory_qldpc import (
    qldpc_memory_experiment,
    qldpc_stream_memory_rate,
)
from qcss_tpu_torch.experiments.memory_xz import xz_memory_experiment

__all__ = [
    "memory_experiment",
    "qldpc_memory_experiment",
    "qldpc_stream_memory_rate",
    "x_extraction_circuit",
    "x_memory_experiment",
    "xz_memory_experiment",
    "z_extraction_circuit",
    "z_memory_experiment",
]
