"""Where a call's device time goes, shared by the benchmarks' ``--profile``
modes (`steane_mc`, `stream_bench`), and the timers and the roofline bound
shared by `gf2_bench` and `chip_smoke.py`."""

from __future__ import annotations

import subprocess
import time

import torch

# the least time the card could take: device memory at 3.35 TB/s (NVIDIA's
# H100 SXM data sheet); 32-bit integer instructions at 64 lanes per SM per
# clock (the Hopper SM), times the SM count and the card's top SM clock as
# `int_ops_per_s` reads them. The data sheet gives no integer rate.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def int_ops_per_s() -> float:
    """The card's integer rate: SMs x 64 lanes x its top SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bound(nbytes: float, ops: float = 0.0,
          ops_per_s: float = float("inf")) -> tuple[float, str]:
    """(bound in ms, what bounds it): the larger of the bytes over the
    memory rate and the integer operations over ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` back to back on the card (CUDA
    events), after one warm-up call. Calls shorter than the host's time to
    issue them measure the host."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _events_ms(run, reps)


def graph_ms(launches: list, reps: int) -> float:
    """Device milliseconds per launch: ``reps`` calls, taken from
    ``launches`` in turn, captured into one CUDA graph and replayed (CUDA
    events around the replay), so the host's time to issue them is not in
    it. Each call launches on `torch.cuda.current_stream()` as it is at
    the call and has run once before (no set-up inside the capture)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(reps):
            launches[k % len(launches)]()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, reps)


def host_ms(fn, reps: int) -> float:
    """The host's milliseconds per call of ``fn`` (no synchronisation
    inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_time_by_kernel(call) -> tuple[object, list[dict]]:
    """Run ``call()`` under `torch.profiler` and return (its result, one row
    per device kernel: name, launches, self device time in ms summed over
    them), longest first. Needs a CUDA device."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        result = call()
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue  # host-side ops; their kernels are listed themselves
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append({"name": ev.key[:90], "calls": ev.count,
                         "self_device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["self_device_ms"])
    return result, rows
