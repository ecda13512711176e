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
from qcss_tpu_torch.experiments.patches import (
    Phase,
    Readout,
    build_schedule,
    parity_chain_memory,
    schedule_memory,
)
from qcss_tpu_torch.experiments.surgery_circuit import (
    build_xx_merge_circuit,
    xx_merge_circuit_memory,
)
from qcss_tpu_torch.experiments.surgery_t import (
    t_gadget_memory,
    t_gadget_report,
)
from qcss_tpu_torch.experiments.surgery import (
    build_surgery_cnot,
    build_xx_merge,
    build_xx_merge_split,
    surgery_cnot_memory,
    xx_merge_memory,
    xx_merge_split_memory,
)
from qcss_tpu_torch.experiments.soft import (
    soft_bp_phenomenological_error_rate,
    soft_device_memory_rate,
    soft_phenomenological_error_rate,
    soft_qldpc_circuit_memory,
    soft_xz_memory_experiment,
)

__all__ = [
    "Phase",
    "Readout",
    "build_schedule",
    "build_surgery_cnot",
    "build_xx_merge",
    "build_xx_merge_circuit",
    "build_xx_merge_split",
    "erasure_error_rate",
    "erasure_phenomenological_error_rate",
    "leakage_circuit_memory",
    "leakage_memory_experiment",
    "memory_experiment",
    "parity_chain_memory",
    "qldpc_memory_experiment",
    "qldpc_stream_memory_rate",
    "schedule_memory",
    "soft_bp_phenomenological_error_rate",
    "soft_device_memory_rate",
    "soft_phenomenological_error_rate",
    "soft_qldpc_circuit_memory",
    "soft_xz_memory_experiment",
    "surgery_cnot_memory",
    "t_gadget_memory",
    "t_gadget_report",
    "x_extraction_circuit",
    "x_memory_experiment",
    "xx_merge_circuit_memory",
    "xx_merge_memory",
    "xx_merge_split_memory",
    "xz_memory_experiment",
    "z_extraction_circuit",
    "z_memory_experiment",
]
