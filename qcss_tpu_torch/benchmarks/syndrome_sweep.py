"""Surface-code distance sweep: batched syndrome-extraction throughput on
the card (PyTorch port of `benchmarks/syndrome_sweep.py`).

For rotated surface codes d = 3..11 it times X-sector syndrome extraction
over a batch of random errors in three forms:

* ``dense``: `gf2_torch.syndromes_dense`, a float32 `torch.matmul` on
  the unpacked [B, n] bits;
* ``packed_torch``: `gf2_torch.syndromes_packed`, the AND/XOR-parity
  chain in plain PyTorch over [B, W] packed words;
* ``packed_kernel``: K7 (`cuda_gf2.syndromes_packed_t`), packed words in
  and packed syndromes out, samples on the fast axis.

Each form runs as a chain of ``iters`` data-dependent applications (the
syndromes are folded back into the errors elementwise, so no application
can be skipped), timed with CUDA events after one warm-up chain.

    python -m qcss_tpu_torch.benchmarks.syndrome_sweep [--batch B]

prints one JSON line per (distance, form), with the card's name.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ops import cuda_gf2, gf2_torch

DISTANCES = (3, 5, 7, 9, 11)
BATCH = 1 << 20
ITERS = 30


def _fold(carry: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """carry [B, cols] ^ the first cols syndrome bits (zero-padded)."""
    cols = carry.shape[-1]
    bump = s[:, :cols]
    if bump.shape[-1] < cols:
        bump = torch.nn.functional.pad(bump, (0, cols - bump.shape[-1]))
    return carry ^ bump.to(carry.dtype)


def chain_ms(fn, x, h, fold, iters: int = ITERS) -> float:
    """Milliseconds per application over a chain of ``iters`` dependent
    applications (CUDA events), after one warm-up chain."""
    def chain():
        carry = x
        for _ in range(iters):
            carry = fold(carry, fn(carry, h))
        return carry

    chain()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def run(distances=DISTANCES, batch: int = BATCH, iters: int = ITERS,
        seed: int = 0) -> list[dict]:
    """One result per (distance, form); needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the syndrome sweep measures the card and needs "
                           "a CUDA device")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    rng = np.random.default_rng(seed)
    out = []
    for d in distances:
        code = families.rotated_surface(d)
        h = code.parity_check_c2
        errors = rng.integers(0, 2, size=(batch, code.n), dtype=np.uint8)
        e = torch.as_tensor(errors, device=dev)
        hd = torch.as_tensor(h, device=dev)
        ep = gf2_torch.words32(gf2_torch.pack_bits(e))
        hp = gf2_torch.words32(gf2_torch.pack_bits(hd))
        ep_t = ep.T.contiguous()
        forms = {
            "dense": chain_ms(gf2_torch.syndromes_dense, e, hd, _fold, iters),
            "packed_torch": chain_ms(gf2_torch.syndromes_packed, ep, hp,
                                     _fold, iters),
            # carry [W, B], s [WR, B]: the first packed syndrome word is
            # folded into every error word
            "packed_kernel": chain_ms(cuda_gf2.syndromes_packed_t, ep_t,
                                      hp, lambda c, s: c ^ s[0:1, :], iters),
        }
        for form, ms in forms.items():
            out.append({
                "metric": "surface_syndrome_extraction", "distance": d,
                "n": code.n, "checks": int(h.shape[0]), "form": form,
                "batch": batch, "ms": ms,
                "samples_per_sec": batch / (ms * 1e-3), "device": card,
            })
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--distances", type=int, nargs="+",
                    default=list(DISTANCES))
    args = ap.parse_args()
    for row in run(args.distances, args.batch):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
