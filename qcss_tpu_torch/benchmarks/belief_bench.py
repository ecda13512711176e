"""Belief-matching accuracy benchmark: the same two-sector circuit-level
shots decoded with independent matching, correlated two-pass matching,
and belief-matching (joint-graph BP posteriors as per-shot UF weights,
`decode/belief.py`) — PyTorch port of `benchmarks/belief_bench.py`, with
the same flags, defaults and JSON keys. Sampling and BP run on the card
(``--cpu``: on the CPU); the matching runs on the host.

    python -m qcss_tpu_torch.benchmarks.belief_bench [--d 3 5 7]
        [--batch 16384] [--chunks 1] [--p-gate 2e-3] [--p-meas 5e-3]
        [--iters 32] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from qcss_tpu_torch._cuda import synchronize
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.experiments.memory_xz import xz_memory_experiment
from qcss_tpu_torch.sim.noise import NoiseModel

RATE_KEYS = ("x_fail", "z_fail", "z_fail_corr", "word_fail",
             "word_fail_corr", "x_fail_belief", "z_fail_belief",
             "word_fail_belief")


def run(d: int, batch: int, chunks: int, p_gate: float, p_meas: float,
        iters: int, device, profile: list | None = None) -> dict:
    """One distance: `xz_memory_experiment(belief=iters)` on rotated
    surface d, R=d, over ``chunks`` seeds; the rates averaged over the
    chunks, unrounded, and the wall seconds (graph builds included).
    ``profile``, a list, receives each chunk's stage seconds."""
    noise = NoiseModel(p_gate2=p_gate, p_meas=p_meas)
    code = families.rotated_surface(d)
    acc = dict.fromkeys(RATE_KEYS, 0.0)
    synchronize(device)
    t0 = time.perf_counter()
    for c in range(chunks):
        prof = {}
        out = xz_memory_experiment(code, rounds=d, noise=noise, batch=batch,
                                   seed=c, belief=iters, device=device,
                                   profile=prof)
        for k in RATE_KEYS:
            acc[k] += out[k] / chunks
        if profile is not None:
            profile.append(prof)
    wall = time.perf_counter() - t0
    return {"bench": "belief_matching", "d": d, "rounds": d,
            "batch": batch * chunks, "p_gate2": p_gate, "p_meas": p_meas,
            "bp_iters": iters, "wall_s": wall, **acc}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, nargs="+", default=[3, 5, 7])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--chunks", type=int, default=1,
                    help="independent seeds to accumulate per d")
    ap.add_argument("--p-gate", type=float, default=2e-3)
    ap.add_argument("--p-meas", type=float, default=5e-3)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="sample and run BP on the CPU instead of the card")
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")
    for d in args.d:
        row = run(d, args.batch, args.chunks, args.p_gate, args.p_meas,
                  args.iters, device)
        row["wall_s"] = round(row["wall_s"], 2)
        for k in RATE_KEYS:
            row[k] = round(row[k], 6)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
