"""qcss_tpu_torch — the PyTorch/CUDA port of `qcss_tpu`, for NVIDIA Hopper.

The JAX package `qcss_tpu` stays the reference; this package carries the
same algorithms on torch tensors, slice by slice (ROADMAP.md). Every
Pallas kernel of a ported slice becomes a CUDA kernel written by hand
(`qcss_tpu_torch/csrc/`, built at first use by `qcss_tpu_torch._cuda`),
with a plain PyTorch version beside it that runs for CPU tensors.

Ported so far: the circuit-level surface-code memory experiment with
sampling and decoding fused on the device
(`experiments.memory.memory_experiment(engine='frames',
decoder='device-dem')`, and the LUT decoders 'vote', 'difference' and
'stlut'), and the code-capacity Monte Carlo
(`decode.logical_error_rate`, `decode.mc_decode_rounds`) over the packed
GF(2) kernels (`ops.cuda_gf2`), the streaming memory, and the stabilizer
tableaus with the FT executor's block engines (`sim.tableau`,
`sim.tableau_packed`, `ftqc.engines`; the fused measurement kernel in
`sim.cuda_measure`). Entry points run on the card unless the
caller passes ``device='cpu'``. This package never imports jax or
qcss_tpu.
"""

from qcss_tpu_torch.errors import (
    InvalidCodeError,
    UnsupportedGateError,
    UnsupportedProgramError,
    UnsupportedQECCError,
)
from qcss_tpu_torch.codes.css import CSSCode
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.circuits.ir import Circuit, Program
from qcss_tpu_torch import (
    circuits,
    codes,
    decode,
    experiments,
    ops,
    sim,
)

__version__ = "0.1.0"

__all__ = [
    "CSSCode",
    "Circuit",
    "Program",
    "families",
    "InvalidCodeError",
    "UnsupportedGateError",
    "UnsupportedProgramError",
    "UnsupportedQECCError",
    "circuits",
    "codes",
    "decode",
    "experiments",
    "ops",
    "sim",
]
