"""Vectorized syndrome-table decoding (PyTorch port of `qcss_tpu.decode.lut`).

One mod-2 matrix product (syndrome extraction), one weighted sum
(syndrome bits -> big-endian table index) and one gather (correction
lookup), batched over the samples, on the tensors' device.
"""

from __future__ import annotations

import torch

from qcss_tpu_torch.ops import gf2_torch


def decode_corrections(syndromes: torch.Tensor,
                       lut: torch.Tensor) -> torch.Tensor:
    """Look up corrections for a batch of syndromes.

    syndromes: [..., r] 0/1; lut: [2^r, n] uint8 (zero row for unknown
    syndromes — the reference's leave-unchanged semantics). Returns
    [..., n] uint8 corrections.
    """
    idx = gf2_torch.bits_to_index(syndromes).to(torch.int64)
    return lut[idx]


def correct_errors(measured: torch.Tensor, known_errors: torch.Tensor,
                   parity_check: torch.Tensor, lut: torch.Tensor):
    """Given measured codeword bits [..., n] and the known-error frame
    [..., n], computes the syndrome of (measured XOR known), looks up the
    additional correction, and returns ``(corrected_measured, new_errors)``
    where ``new_errors = known ^ correction`` and ``corrected_measured =
    measured ^ new_errors``."""
    effective = measured ^ known_errors
    syn = gf2_torch.syndromes_dense(effective, parity_check)
    corr = decode_corrections(syn, lut)
    new_errors = known_errors ^ corr
    return measured ^ new_errors, new_errors


def detect_errors(measured: torch.Tensor, known_errors: torch.Tensor,
                  check_matrix: torch.Tensor) -> torch.Tensor:
    """1 where any syndrome bit of (measured XOR known_errors) is set,
    else 0. Returns [...] uint8."""
    syn = gf2_torch.syndromes_dense(measured ^ known_errors, check_matrix)
    return (syn == 1).any(dim=-1).to(torch.uint8)
