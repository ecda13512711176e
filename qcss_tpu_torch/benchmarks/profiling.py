"""Where a call's device time goes, shared by the benchmarks' ``--profile``
modes (`steane_mc`, `stream_bench`)."""

from __future__ import annotations

import torch


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
