"""Batched GF(2) tensor ops (PyTorch), the counterpart of `qcss_tpu.ops.gf2_jax`.

The dense mod-2 matrix product behind syndrome extraction and compiled
frame propagation, big-endian syndrome indices, and the bit-packed forms
(`pack_bits` / `unpack_bits`, `parity32`, `popcount32`,
`syndromes_packed`).

Packed words: CPU torch has no shifts or compares on uint32, so
`pack_bits` returns int64 tensors holding the unsigned 32-bit values.
The CUDA kernels (`ops/cuda_gf2.py`) take the same 32-bit patterns in
int32 storage (`words32`); every function here that reads packed words
accepts either, and reads only their low 32 bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WORD_BITS = 32
_MASK32 = 0xFFFFFFFF


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


@functools.lru_cache(maxsize=256)
def _place_values(r: int, device: str) -> torch.Tensor:
    """[2^(r-1), ..., 2, 1] as int64 on ``device``, built once per (r,
    device): copying a host list to the card waits for the queued work."""
    return torch.tensor([1 << (r - 1 - i) for i in range(r)],
                        dtype=torch.int64, device=device)


def bits_to_index(bits: torch.Tensor) -> torch.Tensor:
    """Big-endian bit vector(s) -> integer index: bits [..., r] -> [...]
    int32, the first bit the most significant."""
    weights = _place_values(bits.shape[-1], str(bits.device))
    return (bits.to(torch.int64) * weights).sum(dim=-1).to(torch.int32)


def packed_width(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS


def pack_bits(bits) -> torch.Tensor:
    """Pack a 0/1 array along the last axis into 32-bit words
    (little-endian bit order within each word: bit i of word w is column
    ``32*w + i``). The words are returned as int64 holding the unsigned
    32-bit values, since CPU torch has no shifts or compares on uint32.

    One pass per bit position within a word (at most 32), each over the
    columns that share it, so no [..., W, 32] intermediate exists."""
    if not isinstance(bits, torch.Tensor):
        bits = torch.as_tensor(np.asarray(bits))
    *lead, n = bits.shape
    w = packed_width(n)
    out = torch.zeros((*lead, w), dtype=torch.int64, device=bits.device)
    for i in range(min(WORD_BITS, n)):
        col = bits[..., i::WORD_BITS].to(torch.int64) & 1
        out[..., :col.shape[-1]] |= col << i
    return out


def words32(words: torch.Tensor) -> torch.Tensor:
    """Packed words (int64 unsigned values, or int32) as int32 tensors
    holding the same 32-bit patterns: the storage the kernels take."""
    if words.dtype == torch.int32:
        return words
    w = words.to(torch.int64) & _MASK32
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `pack_bits`: 32-bit words -> [..., n] uint8 bits."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & _MASK32)[..., :, None] >> shifts) & 1
    *lead, w, _ = bits.shape
    return bits.reshape(*lead, w * WORD_BITS)[..., :n].to(torch.uint8)


def parity32(x: torch.Tensor) -> torch.Tensor:
    """Bitwise parity (popcount mod 2) of each 32-bit word, XOR-fold;
    returns uint8."""
    x = x.to(torch.int64) & _MASK32
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return (x & 1).to(torch.uint8)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of each 32-bit word (SWAR); returns int32."""
    x = x.to(torch.int64) & _MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    # the top byte of the 32-bit product: bits above 32 are dropped
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def syndromes_packed(errors_packed: torch.Tensor,
                     check_packed: torch.Tensor) -> torch.Tensor:
    """Packed syndrome extraction.

    errors_packed: [..., W] words (one error per leading index);
    check_packed: [r, W] words. Returns [..., r] uint8 syndrome bits:
    ``parity(popcount(H_row & e))``, as an AND/XOR chain over the W words
    (no [..., r, W] intermediate).
    """
    w = check_packed.shape[-1]
    acc = errors_packed[..., None, 0] & check_packed[:, 0]
    for i in range(1, w):
        acc = acc ^ (errors_packed[..., None, i] & check_packed[:, i])
    return parity32(acc)


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


def rref_batched(mats: torch.Tensor) -> torch.Tensor:
    """Reduced row echelon form over GF(2) for a batch of dense 0/1
    matrices, on the tensor's own device.

    mats: [B, m, n] 0/1 (values are read mod 2); returns [B, m, n] uint8.
    The reference's branch-free column sweep (gf2_jax.rref_batched): at
    each column the first row >= r with a 1 is the pivot, added into row
    r where row r has a 0 there, then every other row with a 1 in the
    column gets row r added, and r advances where a pivot was found. The
    same canonical form as `ops.gf2.rref`. The rows are bools, so no
    integer arithmetic can wrap; the pivot is the least row index over
    the masked column (the first 1, as `jnp.argmax` picks it).
    """
    mat = (mats.to(torch.uint8) & 1).to(torch.bool)
    B, m, n = mat.shape
    dev = mat.device
    rows = torch.arange(m, device=dev)
    shots = torch.arange(B, device=dev)
    r = torch.zeros(B, dtype=torch.int64, device=dev)
    for c in range(n):
        col = mat[:, :, c]
        masked = col & (rows[None, :] >= r[:, None])
        has_pivot = masked.any(dim=1)
        pivot = torch.where(masked, rows[None, :], m).amin(dim=1)
        # r and the pivot are m where no row is left: clamp the reads,
        # which `has_pivot` then masks out
        r_at = r.clamp(max=m - 1)
        prow = mat[shots, pivot.clamp(max=m - 1)]
        need_add = has_pivot & ~col[shots, r_at]
        mat[shots, r_at] = mat[shots, r_at] ^ (prow & need_add[:, None])
        rrow = mat[shots, r_at]
        elim = mat[:, :, c] & (rows[None, :] != r[:, None]) \
            & has_pivot[:, None]
        mat ^= elim[:, :, None] & rrow[:, None, :]
        r = r + has_pivot.to(torch.int64)
    return mat.to(torch.uint8)
