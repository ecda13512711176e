"""Detector assembly for multi-round memory experiments (the
`detector_history` of `qcss_tpu.decode.spacetime`).

A memory experiment measures the same checks for R noisy rounds plus one
perfect final readout; *detectors* are the XOR of consecutive syndrome
rounds, so an isolated data error fires one detector slice and an isolated
measurement error fires two adjacent slices. The spacetime LUT decoder of
the reference module is not ported yet.
"""

from __future__ import annotations

import numpy as np


def detector_history(syns, final_syn):
    """XOR consecutive syndrome rounds into the detector layout the
    spacetime decoders expect: slices [syn[0], syn[1]^syn[0], ...,
    final ^ syn[R-1]] concatenated slice-major.

    Works on torch tensors or numpy arrays. syns: [R, B, r]; final_syn:
    [B, r] from the perfect final readout. Returns [B, (R+1)*r].
    """
    rounds = syns.shape[0]
    slices = [syns[0]]
    for t in range(1, rounds):
        slices.append(syns[t] ^ syns[t - 1])
    slices.append(final_syn ^ syns[rounds - 1])
    if isinstance(syns, np.ndarray):
        return np.concatenate(slices, axis=-1)
    import torch

    return torch.cat(slices, dim=-1)
