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
from qcss_tpu_torch.experiments.injection import (
    factory_report,
    magic_injection_experiment,
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
from qcss_tpu_torch.experiments.concatenated import (
    logical_repetition_memory,
    repetition_spacetime_graph,
)
from qcss_tpu_torch.experiments.logical import LogicalProgram
from qcss_tpu_torch.experiments.resources import (
    fit_suppression,
    logical_resource_report,
    program_stats,
    required_distance,
)
from qcss_tpu_torch.experiments.patches import (
    Phase,
    Readout,
    build_schedule,
    parity_chain_memory,
    schedule_memory,
)
from qcss_tpu_torch.experiments.schedule_circuit import (
    build_circuit_schedule,
    circuit_schedule_memory,
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
    "LogicalProgram",
    "Phase",
    "Readout",
    "build_circuit_schedule",
    "build_schedule",
    "build_surgery_cnot",
    "build_xx_merge",
    "build_xx_merge_circuit",
    "build_xx_merge_split",
    "circuit_schedule_memory",
    "erasure_error_rate",
    "erasure_phenomenological_error_rate",
    "factory_report",
    "fit_suppression",
    "leakage_circuit_memory",
    "leakage_memory_experiment",
    "logical_repetition_memory",
    "logical_resource_report",
    "magic_injection_experiment",
    "memory_experiment",
    "parity_chain_memory",
    "program_stats",
    "qldpc_memory_experiment",
    "qldpc_stream_memory_rate",
    "repetition_spacetime_graph",
    "required_distance",
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
