"""Parallel-window vs forward-streaming decode benchmark (PyTorch port of
`benchmarks/pw_bench.py`).

Times `ParallelWindowDecoder.decode_stream` (every window shape one
batched launch of the stencil kernel, whatever the number of rounds)
against `DeviceStreamingDecoder.decode_stream` (R/C dependent windows) on
identical phenomenological streams sampled on the device, with both
failure rates against the sampled logical parities. Prints one JSON line
per distance:

  {"bench": "parallel_window", "d": ..., "rounds": ..., "batch": ...,
   "pw_shots_per_sec": ..., "fw_shots_per_sec": ..., "speedup": ...,
   "pw_fail": ..., "fw_fail": ..., "pw_launches": ..., ...}

    python -m qcss_tpu_torch.benchmarks.pw_bench            # on the card
    python -m qcss_tpu_torch.benchmarks.pw_bench --profile  # where it goes
    python -m qcss_tpu_torch.benchmarks.pw_bench --dmax 5 --batch 256 --cpu

The windows are core = d slices with buf = int(1.5 d) seams, the forward
decoder's window 2d with commit d. Each decoder runs once untimed, then
``--reps`` timed calls, each closed by its host read of the result. On
the card, ``--check`` shots are also decoded by the plain version on the
CPU, which must give the card's observables bit for bit. With
``--profile``, where one call of each decoder spends its device time
instead: the kernels by self CUDA time (`torch.profiler`), their sum
against the call's wall time, and the wall time without the profiler.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from qcss_tpu_torch.benchmarks.profiling import device_time_by_kernel
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_uf_cuda
from qcss_tpu_torch.decode.device_streaming import DeviceStreamingDecoder
from qcss_tpu_torch.decode.parallel_window import ParallelWindowDecoder
from qcss_tpu_torch.decode.streaming import sample_phenomenological_stream


def _timed(dec, dets, reps: int):
    """(seconds a call, observables) over ``reps`` calls after one warm
    call; each call ends in its host read."""
    dec.decode_stream(dets)
    t0 = time.perf_counter()
    for _ in range(reps):
        obs = dec.decode_stream(dets)
    return (time.perf_counter() - t0) / reps, obs


def _setup(d: int, rounds: int, batch: int, p: float, device):
    """(stream [B, R+1, r], parities [B], parallel-window decoder, forward
    decoder) at distance d, the stream sampled from a generator seeded d."""
    code = rotated_surface(d)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    gen = torch.Generator(device=device).manual_seed(d)
    dets, par = sample_phenomenological_stream(gen, p, p, batch, rounds, h,
                                               lz)
    pw = ParallelWindowDecoder(h, lz, core=d, buf=int(1.5 * d),
                               device=device)
    fw = DeviceStreamingDecoder(h, lz, window=2 * d, commit=d, device=device)
    return dets, par[:, 0].cpu().numpy(), pw, fw


def run(d: int, rounds: int = 96, batch: int = 4096, p: float = 0.004,
        reps: int = 3, check: int = 0, device="cuda") -> dict:
    """One distance: both decoders on one stream of ``batch`` shots."""
    device = torch.device(device)
    dets, par, pw, fw = _setup(d, rounds, batch, p, device)
    before = (device_uf_cuda.launches, device_uf_cuda.chunk_launches)
    dt_pw, obs_pw = _timed(pw, dets, reps)
    pw_launches = device_uf_cuda.launches - before[0]
    pw_chunk_launches = device_uf_cuda.chunk_launches - before[1]
    dt_fw, obs_fw = _timed(fw, dets, reps)
    out = {"bench": "parallel_window", "d": d, "rounds": rounds,
           "batch": batch, "p": p, "core": d, "buf": int(1.5 * d),
           "device": str(device),
           "pw_shots_per_sec": batch / dt_pw,
           "fw_shots_per_sec": batch / dt_fw,
           "speedup": dt_fw / dt_pw,
           "pw_fail": float(np.mean((obs_pw & 1) != par)),
           "fw_fail": float(np.mean((obs_fw & 1) != par)),
           "pw_fw_agree": float(np.mean((obs_pw & 1) == (obs_fw & 1))),
           # the parallel window's own, over the warm call and the timed
           # ones, and per decode_stream call
           "pw_launches_total": pw_launches,
           "pw_chunk_launches_total": pw_chunk_launches,
           "pw_launches": pw_launches / (reps + 1),
           "pw_chunk_launches": pw_chunk_launches / (reps + 1)}
    if check:
        cpu = ParallelWindowDecoder(pw.h, pw._logicals, core=d,
                                    buf=int(1.5 * d), device="cpu")
        obs_cpu = cpu.decode_stream(dets[:check].cpu())
        out["check_shots"] = check
        out["check_equal"] = bool(np.array_equal(obs_cpu, obs_pw[:check]))
    return out


def profile(d: int, rounds: int = 96, batch: int = 4096, p: float = 0.004,
            top: int = 8) -> dict:
    """Device time of one `decode_stream` call of each decoder by kernel
    (self CUDA time, summed over its launches), after a warm call; needs
    a CUDA device."""
    dets, _, pw, fw = _setup(d, rounds, batch, p, torch.device("cuda"))
    out = {"bench": "parallel_window_profile", "d": d, "rounds": rounds,
           "batch": batch, "p": p}
    for name, dec in (("pw", pw), ("fw", fw)):
        dec.decode_stream(dets)
        t0 = time.perf_counter()
        dec.decode_stream(dets)
        wall = (time.perf_counter() - t0) * 1e3
        _, rows = device_time_by_kernel(lambda: dec.decode_stream(dets))
        out[name] = {
            "wall_ms_unprofiled": wall,
            "device_busy_ms": sum(r["self_device_ms"] for r in rows),
            "stencil_kernel_ms": sum(r["self_device_ms"] for r in rows
                                     if "uf_stencil_full" in r["name"]),
            "device_launches": sum(r["calls"] for r in rows),
            "kernels": rows[:top]}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="sample and decode on the CPU (plain versions)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=96)
    ap.add_argument("--dmax", type=int, default=11)
    ap.add_argument("--p", type=float, default=0.004)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check", type=int, default=256,
                    help="shots the CPU re-decodes to check the card")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    for d in (5, 7, 11):
        if d > args.dmax:
            break
        if args.profile:
            row = profile(d, args.rounds, args.batch, args.p)
        else:
            row = run(d, args.rounds, args.batch, args.p, args.reps,
                      0 if args.cpu else args.check, device)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
