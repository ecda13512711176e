"""Batched classical bit-vector primitives (PyTorch port of
`qcss_tpu.decode.classical`): each is one batched tensor op on the
vectors' device."""

from __future__ import annotations

import torch

from qcss_tpu_torch.ops import gf2_torch


def _like(pattern, vecs: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(pattern, device=vecs.device).to(vecs.dtype)


def matmul_bits(mat, vecs: torch.Tensor) -> torch.Tensor:
    """``(mat @ v) mod 2`` for a batch of bit vectors: vecs [..., n],
    mat [m, n] -> [..., m] uint8."""
    return gf2_torch.mod2_matmul(vecs, _like(mat, vecs).T)


def string_match(vecs: torch.Tensor, pattern) -> torch.Tensor:
    """1 where the bit-vector equals the constant pattern, else 0:
    vecs [..., n], pattern [n] -> [...] uint8."""
    diff = vecs ^ _like(pattern, vecs)
    return (~(diff != 0).any(dim=-1)).to(torch.uint8)


def conditional_xor(vecs: torch.Tensor, pattern,
                    flags: torch.Tensor) -> torch.Tensor:
    """XOR the constant pattern into each vector whose flag is set:
    vecs [..., n], pattern [n], flags [...] -> [..., n]."""
    return vecs ^ (flags[..., None].to(vecs.dtype) * _like(pattern, vecs))


def majority_vote(bits: torch.Tensor) -> torch.Tensor:
    """Majority over the last axis (must have odd length):
    bits [..., k] -> [...] uint8."""
    k = bits.shape[-1]
    if k % 2 == 0:
        raise ValueError("inputs length must be odd")
    votes = bits.to(torch.int32).sum(dim=-1)
    return (votes >= (k + 1) // 2).to(torch.uint8)
