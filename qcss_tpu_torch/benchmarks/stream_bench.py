"""Device streaming memory end-to-end rate (PyTorch port of
`benchmarks/stream_bench.py`).

Times `decode.device_streaming.stream_memory_rate` — phenomenological
sampling AND sliding-window union-find decoding interleaved on the card
with O(window) state — and prints one JSON line per distance:

  {"bench": "device_stream", "d": .., "rounds": .., "round_shots_per_sec": ..}

    python -m qcss_tpu_torch.benchmarks.stream_bench --d 7 11 --rounds 800
    python -m qcss_tpu_torch.benchmarks.stream_bench --d 11 --rounds 200 --profile

Each distance runs once at 16 rounds first (which builds the kernels and
the window graphs' tables), then the timed run; the wall time includes
that run's own graph build. The mid-window graphs carry their carry lanes
in spilled chunks, so the run goes through the stencil kernel's chunk
path; ``chunk_launches`` says how many times. With ``--profile``, where
the device time of one run goes instead: the kernels by self CUDA time
(`torch.profiler`), their sum against the run's wall time (the rest is
the device waiting for the host), and the wall time without the profiler.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from qcss_tpu_torch.benchmarks.profiling import device_time_by_kernel
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_uf_cuda
from qcss_tpu_torch.decode.device_streaming import stream_memory_rate


def run(d: int, rounds: int, batch: int, p: float, q: float,
        window: int = 8, commit: int = 4, seed: int = 0) -> dict:
    """One warm run at 16 rounds, then the timed run, on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the streaming benchmark needs a CUDA device")
    code = rotated_surface(d)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    stream_memory_rate(h, lz, p, q, rounds=max(16, window), batch=batch,
                       window=window, commit=commit, seed=seed)
    torch.cuda.synchronize()
    before = (device_uf_cuda.launches, device_uf_cuda.chunk_launches)
    t0 = time.perf_counter()
    out = stream_memory_rate(h, lz, p, q, rounds=rounds, batch=batch,
                             window=window, commit=commit, seed=seed + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {
        "bench": "device_stream", "d": d,
        "rounds": rounds, "batch": batch, "p": p, "q": q,
        "window": window, "commit": commit,
        "round_shots_per_sec": rounds * batch / wall,
        "wall_s": wall,
        "logical_fail": out["logical_fail"],
        "launches": device_uf_cuda.launches - before[0],
        "chunk_launches": device_uf_cuda.chunk_launches - before[1],
        "device": torch.cuda.get_device_name(0),
    }


def profile(d: int, rounds: int, batch: int, p: float, q: float,
            window: int = 8, commit: int = 4, seed: int = 0,
            top: int = 12) -> dict:
    """Device time of one `stream_memory_rate` run by kernel (self CUDA
    time, summed over its launches), after a warm run; needs a CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the streaming benchmark needs a CUDA device")
    code = rotated_surface(d)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()

    def call(s) -> float:
        t0 = time.perf_counter()
        stream_memory_rate(h, lz, p, q, rounds=rounds, batch=batch,
                           window=window, commit=commit, seed=s)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    call(seed)
    plain_ms = call(seed + 1)
    wall_ms, rows = device_time_by_kernel(lambda: call(seed + 2))
    busy = sum(r["self_device_ms"] for r in rows)
    return {
        "bench": "device_stream_profile", "d": d, "rounds": rounds,
        "batch": batch, "p": p, "q": q, "window": window, "commit": commit,
        "wall_ms_unprofiled": plain_ms, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy,
        "stencil_kernel_ms": sum(r["self_device_ms"] for r in rows
                                 if "uf_stencil_full" in r["name"]),
        "device_launches": sum(r["calls"] for r in rows),
        "kernels": rows[:top],
        "device": torch.cuda.get_device_name(0),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, nargs="+", default=[7])
    ap.add_argument("--rounds", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--p", type=float, default=0.004)
    ap.add_argument("--q", type=float, default=0.004)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--commit", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    for d in args.d:
        fn = profile if args.profile else run
        print(json.dumps(fn(d, args.rounds, args.batch, args.p, args.q,
                             args.window, args.commit, args.seed)),
              flush=True)


if __name__ == "__main__":
    main()
