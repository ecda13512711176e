"""End-to-end QEC experiments composed from the package's layers."""

from qcss_tpu_torch.experiments.memory import (
    memory_experiment,
    x_extraction_circuit,
    x_memory_experiment,
    z_extraction_circuit,
    z_memory_experiment,
)
from qcss_tpu_torch.experiments.erasure import (
    erasure_error_rate,
    erasure_phenomenological_error_rate,
)
from qcss_tpu_torch.experiments.leakage import (
    leakage_circuit_memory,
    leakage_memory_experiment,
)
from qcss_tpu_torch.experiments.memory_qldpc import (
    qldpc_memory_experiment,
    qldpc_stream_memory_rate,
)
from qcss_tpu_torch.experiments.memory_xz import xz_memory_experiment
from qcss_tpu_torch.experiments.soft import (
    soft_bp_phenomenological_error_rate,
    soft_device_memory_rate,
    soft_phenomenological_error_rate,
    soft_qldpc_circuit_memory,
    soft_xz_memory_experiment,
)

__all__ = [
    "erasure_error_rate",
    "erasure_phenomenological_error_rate",
    "leakage_circuit_memory",
    "leakage_memory_experiment",
    "memory_experiment",
    "qldpc_memory_experiment",
    "qldpc_stream_memory_rate",
    "soft_bp_phenomenological_error_rate",
    "soft_device_memory_rate",
    "soft_phenomenological_error_rate",
    "soft_qldpc_circuit_memory",
    "soft_xz_memory_experiment",
    "x_extraction_circuit",
    "x_memory_experiment",
    "xz_memory_experiment",
    "z_extraction_circuit",
    "z_memory_experiment",
]
