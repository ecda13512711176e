"""Batched GF(2) tensor ops (PyTorch), the counterpart of `qcss_tpu.ops.gf2_jax`.

Only what the circuit-level memory path needs: the mod-2 matrix product
behind syndrome extraction and compiled frame propagation, and the
bit-packing of parity-check rows.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def mod2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a @ b) mod 2`` for 0/1 integer tensors, exact; returns uint8.

    The product runs in float32. Its inputs are 0/1 and every sum is at
    most the inner dimension, which stays below 2^24 (the largest on the
    memory path is the 4G = 880 fault rows of the d=11 extraction round),
    so float32 accumulation is exact. TF32, where enabled, rounds only the
    inputs' mantissas, and 0 and 1 survive that unchanged.
    """
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return (out.to(torch.int32) & 1).to(torch.uint8)


def syndromes_dense(errors: torch.Tensor,
                    parity_check: torch.Tensor) -> torch.Tensor:
    """Syndromes ``H e^T mod 2`` for a batch of error vectors.

    errors: [..., n] 0/1; parity_check: [r, n]. Returns [..., r] uint8.
    """
    return mod2_matmul(errors, parity_check.T)


def packed_width(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS


def pack_bits(bits) -> torch.Tensor:
    """Pack a 0/1 array along the last axis into 32-bit words
    (little-endian bit order within each word: bit i of word w is column
    ``32*w + i``). The words are returned as int64 holding the unsigned
    32-bit values, since CPU torch has no shifts or compares on uint32."""
    bits = torch.as_tensor(np.asarray(bits) if not isinstance(
        bits, torch.Tensor) else bits).to(torch.int64)
    *lead, n = bits.shape
    w = packed_width(n)
    pad = w * WORD_BITS - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*lead, w, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return torch.sum(bits << shifts, dim=-1)


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise XOR over the last axis of an integer tensor. Torch has no
    XOR reduction, so the axis is folded in halves: ceil(log2(n)) XORs."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        head = x[..., :half] ^ x[..., half:2 * half]
        x = torch.cat([head, x[..., 2 * half:]], dim=-1) if n % 2 else head
    return x[..., 0]
