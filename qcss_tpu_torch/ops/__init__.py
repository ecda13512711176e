"""GF(2) linear algebra: `gf2` (exact host-side numpy, copied from the
reference), `gf2_torch` (batched tensor ops) and `cuda_gf2` (the packed
kernels and their plain versions)."""

from qcss_tpu_torch.ops import cuda_gf2, gf2, gf2_torch

__all__ = ["cuda_gf2", "gf2", "gf2_torch"]
