"""Repeated syndrome extraction with majority vote (PyTorch port of
`qcss_tpu.decode.multiround`).

Data errors are sampled once, each round re-extracts the syndrome through
an independent measurement-noise channel, votes run per bit, and the
voted syndrome feeds the LUT decoder (phenomenological measurement noise,
static data error).
"""

from __future__ import annotations

import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.decode.montecarlo import (
    _rates,
    _summed,
    sample_depolarizing,
)
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim.noise import flip_bits


def noisy_syndromes(errors, parity_check, q_meas, generator, rounds: int):
    """Extract the syndrome ``rounds`` times, each through an independent
    bit-flip channel of rate q_meas. errors [B, n] -> [rounds, B, r]."""
    true_syn = gf2_torch.syndromes_dense(errors, parity_check)
    return torch.stack([flip_bits(true_syn, q_meas, generator)
                        for _ in range(rounds)])


def vote_syndromes(syndromes: torch.Tensor) -> torch.Tensor:
    """Per-bit majority over the leading rounds axis (odd round count)."""
    rounds = syndromes.shape[0]
    if rounds % 2 == 0:
        raise ValueError("round count must be odd")
    votes = syndromes.to(torch.int32).sum(dim=0)
    return (votes >= (rounds + 1) // 2).to(torch.uint8)


def _multiround_step(generator, p, q, batch, rounds, dev) -> dict:
    x_err, z_err = sample_depolarizing(generator, batch, dev.h1.shape[1], p)

    def sector(err, check, flip_tab, logical):
        voted = vote_syndromes(
            noisy_syndromes(err, check, q, generator, rounds))
        # A voted syndrome that differs from the true one applies a wrong
        # correction; corr_flip is looked up from the voted syndrome, so
        # the comparison below accounts for it exactly.
        corr_flip = flip_tab[gf2_torch.bits_to_index(voted).to(torch.int64)]
        err_flip = gf2_torch.mod2_matmul(err, logical.T)
        return (err_flip ^ corr_flip).any(dim=-1).to(torch.uint8)

    x_fail = sector(x_err, dev.h2, dev.flip_z_of_lut_c2, dev.logical_z)
    z_fail = sector(z_err, dev.h1, dev.flip_x_of_lut_c1, dev.logical_x)
    return {"x_fail": x_fail.sum(dtype=torch.int64),
            "z_fail": z_fail.sum(dtype=torch.int64),
            "word_fail": (x_fail | z_fail).sum(dtype=torch.int64)}


def multiround_error_rate(code, p, q_meas, *, rounds: int | None = None,
                          samples: int = 1 << 18, batch: int = 1 << 18,
                          seed: int = 0, device="cuda") -> dict[str, float]:
    """Logical error rate with noisy syndrome measurement, decoded from the
    per-bit majority over ``rounds`` repeated extractions (default 2t+1),
    on ``device`` from a generator seeded with ``seed``."""
    if code.device.lut_c1 is None or code.device.lut_c2 is None:
        raise ValueError("code has no syndrome tables; pass max_table_weight")
    device = _cuda.resolve_device(device)
    dev = code.device.to(device)
    rounds = 2 * code.t + 1 if rounds is None else rounds
    n_rounds = -(-samples // batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = _summed(_multiround_step(gen, p, q_meas, batch, rounds, dev)
                    for _ in range(n_rounds))
    return _rates(total, n_rounds * batch)
