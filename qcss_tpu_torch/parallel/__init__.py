"""Multi-device scaling: sample-axis data parallelism over a device mesh
(PyTorch port of `qcss_tpu.parallel`).

The reference's only batching mechanism is the QVM numshots loop inside a
single external simulator process (reference: test/test_fidelity.py:67);
its only IPC is pyquil->QVM RPC. Here a `Mesh` is a list of devices (the
cards, or CPU devices named by the caller); each shard samples, extracts
and decodes its part of the Monte-Carlo batch on its device, and the
failure counts are summed once every shard has been queued.
"""

from qcss_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedFrameMemory,
    make_mesh,
    shard_seed,
    sharded_bp_memory,
    sharded_ftqc_run,
    sharded_logical_error_rate,
    sharded_logical_program,
    sharded_magic_factory,
    sharded_mc_step,
    sharded_qldpc_circuit_memory,
    sharded_mld_memory,
    sharded_parallel_window_memory,
    sharded_soft_memory,
    sharded_two_level_memory,
)

__all__ = [
    "Mesh",
    "ShardedFrameMemory",
    "make_mesh",
    "shard_seed",
    "sharded_bp_memory",
    "sharded_ftqc_run",
    "sharded_logical_error_rate",
    "sharded_logical_program",
    "sharded_magic_factory",
    "sharded_mc_step",
    "sharded_qldpc_circuit_memory",
    "sharded_mld_memory",
    "sharded_parallel_window_memory",
    "sharded_soft_memory",
    "sharded_two_level_memory",
]
