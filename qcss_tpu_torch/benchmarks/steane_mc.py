"""The headline throughput benchmark: the fused Steane Monte-Carlo decode
(PyTorch port of `bench.py::bench_steane`).

Steane [[7,1,3]], depolarizing p = 0.01, ``rounds`` fused rounds of
``batch`` samples per call of `decode.montecarlo.mc_decode_rounds`
(defaults: B = 2^22, 64 rounds, the reference's configuration, nothing
cut). Two warm-up calls, then ``reps`` timed calls, each fenced by a host
read of its failure count.

    python -m qcss_tpu_torch.benchmarks.steane_mc [--profile]

prints one JSON line (samples/s on the card, with its name); with
``--profile``, where the device time of one call goes instead: the
kernels by self CUDA time (`torch.profiler`), their sum against the
call's wall time, and the call's wall time without the profiler.
`decode_forms` times one round's decode in each of its forms.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.benchmarks.profiling import device_time_by_kernel
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.decode import montecarlo

BATCH = 1 << 22
ROUNDS = 64
P_PHYS = 0.01


def run(batch: int = BATCH, rounds: int = ROUNDS, p: float = P_PHYS,
        reps: int = 3, seed: int = 0, device="cuda") -> dict:
    """Time ``reps`` calls of `mc_decode_rounds` after two warm-ups.
    Returns samples/s (on a CUDA device; on the CPU the rate of the plain
    versions), the word-failure rate over the timed calls, and the
    counts."""
    device = resolve_device(device)
    code = families.steane()
    gen = torch.Generator(device=device).manual_seed(seed)

    def run_once() -> int:
        counts = montecarlo.mc_decode_rounds(code, gen, batch, rounds, p)
        return int(counts["word_fail"])

    run_once()
    run_once()
    t0 = time.perf_counter()
    fails = sum(run_once() for _ in range(reps))
    elapsed = time.perf_counter() - t0
    samples = reps * rounds * batch
    return {
        "bench": "steane_mc_decode_throughput", "batch": batch,
        "rounds": rounds, "reps": reps, "p": p,
        "samples_per_sec": samples / elapsed,
        "word_fail": fails / samples, "word_fail_count": fails,
        "samples": samples,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def profile(batch: int = BATCH, rounds: int = ROUNDS, p: float = P_PHYS,
            seed: int = 0, top: int = 12) -> dict:
    """Device time of one `mc_decode_rounds` call by kernel (self CUDA
    time, summed over its launches), after a warm-up call; needs a CUDA
    device."""
    device = resolve_device("cuda")
    code = families.steane()
    gen = torch.Generator(device=device).manual_seed(seed)

    def call() -> float:
        t0 = time.perf_counter()
        counts = montecarlo.mc_decode_rounds(code, gen, batch, rounds, p)
        int(counts["word_fail"])
        return (time.perf_counter() - t0) * 1e3

    call()
    plain_ms = call()
    wall_ms, rows = device_time_by_kernel(call)
    busy = sum(r["self_device_ms"] for r in rows)
    return {
        "bench": "steane_mc_profile", "batch": batch, "rounds": rounds,
        "p": p, "wall_ms_unprofiled": plain_ms, "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy, "kernels": rows[:top],
        "device": torch.cuda.get_device_name(device),
    }


def decode_forms(batch: int = BATCH, p: float = P_PHYS, reps: int = 10,
                 seed: int = 0) -> dict[str, float]:
    """Milliseconds per round of each decode form, on one draw of Steane
    errors (both sectors; CUDA events over ``reps`` calls after a warm-up;
    needs a CUDA device): ``packed`` (`decode_failures_packed`, what
    `mc_decode_rounds` runs: pack, K8, K6), ``dense_flip_tables`` (the
    reference's form: mod-2 matmuls and the per-syndrome flip tables) and
    ``dense_gather`` (the correction-gather branch). Raises unless the
    three give the same flags."""
    device = resolve_device("cuda")
    code = families.steane()
    dev = code.device.to(device)
    sectors = montecarlo.packed_sectors(code, device)
    x_err, z_err = montecarlo.sample_depolarizing(
        torch.Generator(device=device).manual_seed(seed), batch, code.n, p)
    tables = (dev.h1, dev.h2, dev.lut_c1, dev.lut_c2, dev.logical_x,
              dev.logical_z)
    forms = {
        "packed": lambda: montecarlo.decode_failures_packed(
            x_err, z_err, *sectors),
        "dense_flip_tables": lambda: montecarlo.decode_failures(
            x_err, z_err, *tables, dev.flip_z_of_lut_c2,
            dev.flip_x_of_lut_c1),
        "dense_gather": lambda: montecarlo.decode_failures(
            x_err, z_err, *tables),
    }
    flags = {name: fn() for name, fn in forms.items()}
    for name, got in flags.items():
        if not all(torch.equal(got[k], flags["packed"][k]) for k in got):
            raise RuntimeError(f"decode form {name} gives other flags")
    out = {}
    for name, fn in forms.items():
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(stop) / reps
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    print(json.dumps(profile() if args.profile else run()))
