"""Fault-tolerant quantum computation: the FT transpiler on the block-level
engines.

`rewrite_program` validates a raw Clifford program and returns an
`EncodedProgram`, whose `run` executes it batched over the shots: by
default as the macro-op rows of `schedule` (FT preparation, Steane or flag
EC after every gate, serial or, on frames, parallel across blocks, 2t+1
majority-vote measurement) on the 'unpacked' or 'packed' tableau engine or
the 'frames' Pauli-frame engine (`engines`; the packed one measures blocks
with K9 on the card), or with ``engine='unrolled'`` as one call of the
protocols of `FTProtocols` (`executor`) per instruction. `flags` builds
flag EC's CNOT orders and hook tables. `magic` holds magic-state
distillation: the exact 15-to-1 map and cascade, its device Monte Carlo
and the circuit-level tier on the frame engine.
"""

from qcss_tpu_torch.ftqc.engines import (
    FrameEngine,
    PackedEngine,
    UnpackedEngine,
)
from qcss_tpu_torch.ftqc.executor import CodeBlock, ExecState, FTProtocols
from qcss_tpu_torch.ftqc.rewrite import (
    EncodedProgram,
    rewrite_program,
    run_program,
)

__all__ = [
    "CodeBlock",
    "EncodedProgram",
    "ExecState",
    "FTProtocols",
    "FrameEngine",
    "PackedEngine",
    "UnpackedEngine",
    "rewrite_program",
    "run_program",
]
