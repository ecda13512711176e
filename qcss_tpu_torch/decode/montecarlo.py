"""Monte-Carlo logical-error-rate estimation (PyTorch port of
`qcss_tpu.decode.montecarlo`).

A seeded, batched depolarizing-channel sampler and a fused
sample -> syndrome-extract -> LUT-decode -> residual-logical-check
pipeline, on the generator's device.

Convention (as in the reference): X errors are detected by the Z-type
checks (``parity_check_c2``) and corrected against the C2 table; Z
errors by the X-type checks (``parity_check_c1``). A residual X-type
operator flips the logical qubit iff it anticommutes with logical Z̄; a
residual Z-type operator iff it anticommutes with X̄.

Two decodes give the same flags, bit for bit, on the same errors:

* `decode_failures`, the reference's dense form (mod-2 matmuls, a LUT
  gather, optionally per-syndrome flip tables);
* `decode_failures_packed`, the packed form the Monte-Carlo steps run:
  per sector, the errors are packed to 32-bit words, K8
  (`cuda_gf2.decode_residual_packed`) applies the LUT correction and K6
  (`cuda_gf2.syndromes_packed`) takes the residual's parity against the
  logical rows. On the card these are the hand-written kernels; on the
  CPU their plain versions.

The randomness is a `torch.Generator`; its stream differs from JAX's
threefry keys, so rates agree with the reference in distribution. Given
the same raw 32-bit words (`depolarizing_from_words`), the errors are
identical: the thresholds are the reference's float32 ones, including
its cap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.decode.lut import decode_corrections
from qcss_tpu_torch.ops import cuda_gf2, gf2_torch

_KEYS = ("x_fail", "z_fail", "word_fail")


def _threshold(frac) -> int:
    """``min(frac * 2^32, float32(2^32 - 1))`` in float32, converted to
    uint32 as XLA converts: saturating. float32(2^32 - 1) rounds to 2^32,
    which saturates to 2^32 - 1, so p = 1 fires with probability
    1 - 2^-32, as in the reference (a plain cast would give 2^32)."""
    v = np.minimum(np.float32(frac) * np.float32(2.0**32),
                   np.float32(2.0**32 - 1))
    if not v > 0:  # negative or NaN
        return 0
    return min(int(v), (1 << 32) - 1)


def depolarizing_thresholds(p) -> tuple[int, int, int]:
    """(t1, t2, t3): the uint32 thresholds of p/3, 2p/3 and p, computed
    in float32 exactly as the reference computes them."""
    p = np.float32(p)
    return (_threshold(p / np.float32(3.0)),
            _threshold(np.float32(2.0) * p / np.float32(3.0)),
            _threshold(p))


def depolarizing_from_words(u: torch.Tensor, p):
    """Depolarizing errors from raw 32-bit words u [B, n] (int64 in
    [0, 2^32)): X-or-Y <=> u < t2, Y-or-Z <=> t1 <= u < t3. Returns
    (x_err, z_err), each [B, n] uint8."""
    t1, t2, t3 = depolarizing_thresholds(p)
    x_err = (u < t2).to(torch.uint8)
    z_err = ((u >= t1) & (u < t3)).to(torch.uint8)
    return x_err, z_err


def sample_depolarizing(generator: torch.Generator, batch: int, n: int, p):
    """IID single-qubit depolarizing noise: each qubit suffers X, Y or Z
    with probability p/3 each, drawn on the generator's device. Returns
    (x_err, z_err), each [batch, n] uint8."""
    u = torch.randint(0, 1 << 32, (batch, n), generator=generator,
                      device=generator.device, dtype=torch.int64)
    return depolarizing_from_words(u, p)


def decode_failures(x_err, z_err, h1, h2, lut1, lut2, logical_x, logical_z,
                    flip_z_of_lut2=None, flip_x_of_lut1=None) -> dict:
    """Decode a batch of Pauli errors and report per-sample logical flips
    (the reference's dense form).

    All inputs are 0/1 tensors; x_err/z_err are [B, n]. Returns uint8 [B]
    flags ``x_fail`` (logical bit flip), ``z_fail`` (logical phase flip)
    and ``word_fail`` (either). With the per-syndrome flip tables
    (``flip_z_of_lut2[s] = L_Z · lut2[s]``, [2^r, k]) the residual check
    ``parity(L · (e ^ lut[s]))`` is computed as ``parity(L · e) ^ flip[s]``:
    the same flags.
    """
    def sector(err, checks, lut, logical, flip):
        syn = gf2_torch.syndromes_dense(err, checks)
        err_flip = gf2_torch.mod2_matmul(err, logical.T)  # [B, k]
        if flip is not None:
            corr_flip = flip[gf2_torch.bits_to_index(syn).to(torch.int64)]
        else:
            corr = decode_corrections(syn, lut)
            corr_flip = gf2_torch.mod2_matmul(corr, logical.T)
        return (err_flip ^ corr_flip).any(dim=-1).to(torch.uint8)

    x_fail = sector(x_err, h2, lut2, logical_z, flip_z_of_lut2)
    z_fail = sector(z_err, h1, lut1, logical_x, flip_x_of_lut1)
    return {"x_fail": x_fail, "z_fail": z_fail, "word_fail": x_fail | z_fail}


class PackedSector(NamedTuple):
    """One Pauli sector's tables as int32 words: checks [r, W], the
    correction LUT [2^r, W] and the logical rows [k, W] it is judged by."""

    checks: torch.Tensor
    lut: torch.Tensor
    logicals: torch.Tensor


def packed_sectors(code, device) -> tuple[PackedSector, PackedSector]:
    """(X sector: Z checks, C2 LUT, Z̄ rows; Z sector: X checks, C1 LUT,
    X̄ rows) of ``code``, packed, on ``device``."""
    dev = code.device
    if dev.lut_c1 is None or dev.lut_c2 is None:
        raise ValueError("code has no syndrome tables; pass max_table_weight")

    def words(a):
        return gf2_torch.words32(gf2_torch.pack_bits(a)).to(device)

    return (PackedSector(words(dev.h2), words(dev.lut_c2),
                         words(dev.logical_z)),
            PackedSector(words(dev.h1), words(dev.lut_c1),
                         words(dev.logical_x)))


def _sector_fail_packed(err: torch.Tensor, sec: PackedSector):
    words = gf2_torch.words32(gf2_torch.pack_bits(err))
    resid = cuda_gf2.decode_residual_packed(words, sec.checks, sec.lut)
    flips = cuda_gf2.syndromes_packed(resid, sec.logicals)  # [B, k]
    return flips.any(dim=-1).to(torch.uint8)


def decode_failures_packed(x_err, z_err, x_sector: PackedSector,
                           z_sector: PackedSector) -> dict:
    """`decode_failures` through the packed kernels (K8, then K6 on the
    residual): the same uint8 [B] flags."""
    x_fail = _sector_fail_packed(x_err, x_sector)
    z_fail = _sector_fail_packed(z_err, z_sector)
    return {"x_fail": x_fail, "z_fail": z_fail, "word_fail": x_fail | z_fail}


def _summed(steps) -> dict:
    """The per-key sum of the steps' device counts (nothing read back)."""
    total = dict.fromkeys(_KEYS, 0)
    for counts in steps:
        total = {k: total[k] + counts[k] for k in _KEYS}
    return total


def _rates(total: dict, n_samples: int) -> dict[str, float]:
    """Device counts -> rates, in one host read; plus the sample count."""
    counts = torch.stack([total[k] for k in _KEYS]).tolist()
    out = {k: c / n_samples for k, c in zip(_KEYS, counts)}
    out["samples"] = n_samples
    return out


def _mc_step(generator, p, batch: int, n: int, sectors) -> dict:
    x_err, z_err = sample_depolarizing(generator, batch, n, p)
    fails = decode_failures_packed(x_err, z_err, *sectors)
    return {k: v.sum(dtype=torch.int64) for k, v in fails.items()}


def mc_decode_step(code, generator: torch.Generator, batch: int, p) -> dict:
    """One fused Monte-Carlo round on the generator's device: sample
    ``batch`` depolarizing errors at physical rate p, decode both Pauli
    sectors, count logical failures. Returns 0-d int64 device tensors."""
    return _mc_step(generator, p, batch, code.n,
                    packed_sectors(code, generator.device))


def mc_decode_rounds(code, generator: torch.Generator, batch: int,
                     rounds: int, p) -> dict:
    """``rounds`` fused Monte-Carlo rounds (the reference's lax.scan: a
    Python loop here) with the counts summed on the device, so nothing is
    read back between rounds; the form the throughput benchmark
    (`benchmarks/steane_mc.py`) runs. Returns 0-d int64 device tensors."""
    sectors = packed_sectors(code, generator.device)
    return _summed(_mc_step(generator, p, batch, code.n, sectors)
                   for _ in range(rounds))


def logical_error_rate(code, p, *, samples: int = 1 << 20,
                       batch: int = 1 << 18, seed: int = 0,
                       device="cuda") -> dict[str, float]:
    """Estimate logical error rates at physical error rate p: ceil(samples
    / batch) fused rounds on ``device`` from a generator seeded with
    ``seed``, one host read at the end. Returns the rates plus the sample
    count actually used."""
    device = _cuda.resolve_device(device)
    rounds = -(-samples // batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _rates(mc_decode_rounds(code, gen, batch, rounds, p),
                  rounds * batch)
