"""Profiling and throughput instrumentation.

`trace` wraps `torch.profiler.profile` so hot paths can be captured as a
Chrome trace (chrome://tracing, Perfetto); `Throughput` is the
samples/sec counter used by the benchmark harnesses.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block with `torch.profiler` (CPU and, where
    the build has it, CUDA activity) when `log_dir` is given, and write
    its Chrome trace there as ``trace_<pid>_<ns>.json``; no-op otherwise."""
    if log_dir is None:
        yield
        return
    import torch

    acts = [a for a in (torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA)
            if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class Throughput:
    """Wall-clock samples/sec counter.

    >>> meter = Throughput()
    >>> with meter.measure(n_samples=batch):
    ...     run_step()
    >>> meter.samples_per_sec
    """

    total_samples: int = 0
    total_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    @contextlib.contextmanager
    def measure(self, n_samples: int):
        t0 = time.perf_counter()
        yield
        self.total_seconds += time.perf_counter() - t0
        self.total_samples += n_samples

    @property
    def samples_per_sec(self) -> float:
        return self.total_samples / self.total_seconds if self.total_seconds else 0.0
