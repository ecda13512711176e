"""GF(2) linear algebra: `gf2` (exact host-side numpy, copied from the
reference) and `gf2_torch` (batched tensor ops)."""

from qcss_tpu_torch.ops import gf2, gf2_torch

__all__ = ["gf2", "gf2_torch"]
