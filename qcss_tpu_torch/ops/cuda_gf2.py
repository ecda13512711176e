"""The bit-packed GF(2) kernels (`csrc/gf2_packed.cu`), their plain
PyTorch versions and the functions that choose between them: the
counterpart of `qcss_tpu.ops.pallas_gf2`.

Packed words are int32 tensors holding 32-bit patterns (bit i of word w
is column ``32*w + i``; `gf2_torch.words32` converts the port's int64
packing). Each function comes three ways:

* ``*_cuda`` launches the kernel; it takes CUDA tensors only;
* ``*_plain`` computes the same with PyTorch ops, on any device;
* the bare name sends a CUDA tensor to the kernel and a CPU tensor to
  the plain version. No path gives way from the kernel to the plain
  version: what the kernel does not take raises.

The TPU kernels' ``tile_b`` (B a multiple of the VMEM tile) has no
counterpart: the kernels take any batch.
"""

from __future__ import annotations

import ctypes

import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.ops import gf2_torch

#: kernel launches made by the ``*_cuda`` wrappers in this process
launches = {"syndromes_packed": 0, "syndromes_packed_t": 0,
            "decode_residual_packed": 0}

#: the largest syndrome width K8 indexes (its index is an int32)
MAX_LUT_ROWS_LOG2 = 30


def _check_words(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 2-d int32 tensor of packed "
            f"words, got {tuple(t.shape)} {t.dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_PLAN_KEYS = ("instance", "shots_per_thread", "lanes", "tile_shots",
              "smem_bytes", "checks_in_smem", "lut_in_smem",
              "resident_blocks", "registers")


def launch_plan(kernel: str, errors: torch.Tensor,
                checks: torch.Tensor) -> dict:
    """How K6 (``kernel="syndromes_packed"``) or K8
    (``"decode_residual_packed"``) launches on these inputs, with an
    output as its wrapper allocates it: the instance (W for a 16-byte
    aligned ``errors`` with W <= 4, else 0, the generic instance), shots a
    thread a tile, lanes (threads of a block that own shots), shots a
    tile, shared memory a block, whether the checks and the LUT are staged
    in it, the blocks the card holds at once (the persistent grid's cap)
    and registers a thread (`qcss_gf2_packed_config`; needs the card)."""
    which = {"syndromes_packed": 6, "decode_residual_packed": 8}[kernel]
    W = errors.shape[1]
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    # a fresh output from the caching allocator is 16-byte aligned
    _cuda.check(_cuda.load().qcss_gf2_packed_config(
        which, W, checks.shape[0], errors.data_ptr(), 0, out),
        "qcss_gf2_packed_config")
    plan = dict(zip(_PLAN_KEYS, (int(x) for x in out)))
    plan["checks_in_smem"] = bool(plan["checks_in_smem"])
    plan["lut_in_smem"] = bool(plan["lut_in_smem"])
    return plan


# -- K6: syndromes, [B, W] -> [B, R] bits --------------------------------------

def syndromes_packed_plain(errors: torch.Tensor,
                           checks: torch.Tensor) -> torch.Tensor:
    """errors [B, W], checks [R, W] words -> [B, R] uint8 syndrome bits."""
    return gf2_torch.syndromes_packed(errors, checks)


def syndromes_packed_cuda(errors: torch.Tensor,
                          checks: torch.Tensor) -> torch.Tensor:
    """Launch K6 on CUDA tensors; same result as `syndromes_packed_plain`."""
    if not errors.is_cuda:
        raise ValueError("syndromes_packed_cuda takes CUDA tensors")
    _check_words("errors", errors, errors.device)
    _check_words("checks", checks, errors.device)
    B, W = errors.shape
    R = checks.shape[0]
    if checks.shape[1] != W or R < 1 or W < 1:
        raise ValueError(f"checks must be [R >= 1, {W}], got "
                         f"{tuple(checks.shape)}")
    out = torch.empty((B, R), dtype=torch.uint8, device=errors.device)
    err = _cuda.load().qcss_syndromes_packed(
        errors.data_ptr(), checks.data_ptr(), B, W, R, out.data_ptr(),
        _stream(errors))
    _cuda.check(err, "qcss_syndromes_packed")
    launches["syndromes_packed"] += 1
    return out


def syndromes_packed(errors: torch.Tensor,
                     checks: torch.Tensor) -> torch.Tensor:
    """K6 for a CUDA tensor, its plain version for a CPU tensor."""
    if errors.is_cuda:
        return syndromes_packed_cuda(errors, checks)
    return syndromes_packed_plain(errors, checks)


# -- K7: transposed syndromes, [W, B] -> packed [ceil(R/32), B] -----------------

def syndromes_packed_t_plain(errors_t: torch.Tensor,
                             checks: torch.Tensor) -> torch.Tensor:
    """errors_t [W, B] (the transposed pack), checks [R, W] words ->
    [ceil(R/32), B] int32 words: syndrome bit r of shot b is bit r % 32
    of word [r // 32, b]."""
    syn = gf2_torch.syndromes_packed(errors_t.T, checks)  # [B, R]
    return gf2_torch.words32(gf2_torch.pack_bits(syn)).T.contiguous()


def syndromes_packed_t_cuda(errors_t: torch.Tensor,
                            checks: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA tensors; same result as
    `syndromes_packed_t_plain`."""
    if not errors_t.is_cuda:
        raise ValueError("syndromes_packed_t_cuda takes CUDA tensors")
    _check_words("errors_t", errors_t, errors_t.device)
    _check_words("checks", checks, errors_t.device)
    W, B = errors_t.shape
    R = checks.shape[0]
    if checks.shape[1] != W or R < 1 or W < 1:
        raise ValueError(f"checks must be [R >= 1, {W}], got "
                         f"{tuple(checks.shape)}")
    out = torch.empty(((R + 31) // 32, B), dtype=torch.int32,
                      device=errors_t.device)
    err = _cuda.load().qcss_syndromes_packed_t(
        errors_t.data_ptr(), checks.data_ptr(), B, W, R, out.data_ptr(),
        _stream(errors_t))
    _cuda.check(err, "qcss_syndromes_packed_t")
    launches["syndromes_packed_t"] += 1
    return out


def syndromes_packed_t(errors_t: torch.Tensor,
                       checks: torch.Tensor) -> torch.Tensor:
    """K7 for a CUDA tensor, its plain version for a CPU tensor."""
    if errors_t.is_cuda:
        return syndromes_packed_t_cuda(errors_t, checks)
    return syndromes_packed_t_plain(errors_t, checks)


# -- K8: fused syndrome -> LUT row -> residual ---------------------------------

def decode_residual_packed_plain(errors: torch.Tensor, checks: torch.Tensor,
                                 lut: torch.Tensor) -> torch.Tensor:
    """errors [B, W], checks [R, W], lut [2^R, W] words -> [B, W] int32
    residual words ``errors ^ lut[index]``, index the big-endian syndrome
    (row 0 the most significant bit)."""
    idx = gf2_torch.bits_to_index(gf2_torch.syndromes_packed(errors, checks))
    return errors ^ lut[idx.to(torch.int64)]


def decode_residual_packed_cuda(errors: torch.Tensor, checks: torch.Tensor,
                                lut: torch.Tensor) -> torch.Tensor:
    """Launch K8 on CUDA tensors; same result as
    `decode_residual_packed_plain`."""
    if not errors.is_cuda:
        raise ValueError("decode_residual_packed_cuda takes CUDA tensors")
    _check_words("errors", errors, errors.device)
    _check_words("checks", checks, errors.device)
    _check_words("lut", lut, errors.device)
    B, W = errors.shape
    R = checks.shape[0]
    if checks.shape[1] != W or W < 1:
        raise ValueError(f"checks must be [R, {W}], got {tuple(checks.shape)}")
    if not 1 <= R <= MAX_LUT_ROWS_LOG2:
        raise ValueError(f"K8 indexes a LUT of 2^R rows with 1 <= R <= "
                         f"{MAX_LUT_ROWS_LOG2}; got R = {R}")
    if lut.shape != (1 << R, W):
        raise ValueError(f"lut must be [{1 << R}, {W}], got "
                         f"{tuple(lut.shape)}")
    out = torch.empty_like(errors)
    err = _cuda.load().qcss_decode_residual_packed(
        errors.data_ptr(), checks.data_ptr(), lut.data_ptr(), B, W, R,
        out.data_ptr(), _stream(errors))
    _cuda.check(err, "qcss_decode_residual_packed")
    launches["decode_residual_packed"] += 1
    return out


def decode_residual_packed(errors: torch.Tensor, checks: torch.Tensor,
                           lut: torch.Tensor) -> torch.Tensor:
    """K8 for a CUDA tensor, its plain version for a CPU tensor."""
    if errors.is_cuda:
        return decode_residual_packed_cuda(errors, checks, lut)
    return decode_residual_packed_plain(errors, checks, lut)
