"""Batched GF(2) RREF throughput (PyTorch port of the JAX package's
benchmarks/gf2_bench.py; this package's `gf2_bench.py` times K6 and K8).

Reduces a batch of dense binary matrices to reduced row echelon form on
the device (`ops.gf2_torch.rref_batched`, plain torch, as the reference's
is plain XLA) and reports throughput as Gbit-ops/s, with bit-ops counted as
the dense elimination bound B * n_cols * m * n (one conditional row-XOR
across the full batch per pivot column). Two warm-up calls, then 3 timed
calls, each fenced by a host read of the result.

Usage:
    python -m qcss_tpu_torch.benchmarks.rref_bench [--batch 4096]
        [--shape 64 128] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.ops import gf2_torch


def run(batch: int = 4096, shape=(64, 128), device="cuda",
        reps: int = 3) -> dict:
    """Time ``reps`` calls of `rref_batched` on ``batch`` random [m, n]
    matrices (numpy seed 0) after two warm-ups; returns the JSON row."""
    device = resolve_device(device)
    m, n = shape
    rng = np.random.default_rng(0)
    mats = torch.as_tensor(rng.integers(0, 2, size=(batch, m, n),
                                        dtype=np.uint8), device=device)

    def run_once(x) -> int:
        out = gf2_torch.rref_batched(x)
        return int(out[0, 0, 0]) + int(out.sum())  # host fence

    run_once(mats)
    run_once(mats ^ 1)
    t0 = time.perf_counter()
    for i in range(reps):
        run_once(mats ^ (i % 2))
    dt = time.perf_counter() - t0
    bit_ops = batch * n * m * n  # per reduction
    return {
        "metric": "gf2_rref_batched",
        "batch": batch,
        "shape": [m, n],
        "value": reps * bit_ops / dt / 1e9,
        "unit": "Gbit-ops/s/card",
        "reductions_per_sec": reps * batch / dt,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--shape", type=int, nargs=2, default=[64, 128])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    row = run(args.batch, tuple(args.shape), args.device)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
