"""Tracing and step timing (port of dex_tts_tpu/utils/profiling.py).

  * `trace(dir)`: `torch.profiler` over the enclosed block, CPU activity
    and, where CUDA is available, the card's (kernels, copies); a Chrome
    trace (Perfetto, chrome://tracing) written into ``dir`` at the end;
  * `annotate(name)`: a named span in such a trace;
  * `StepTimer`: host wall times per step, warm-up steps left out. The
    card runs asynchronously: a step timed on the host ends with a
    synchronisation (a host read of a result) inside the ``with``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with `torch.profiler`; the Chrome trace goes
    to ``<log_dir>/trace_<pid>_<ns>.json``. Yields the profiler, whose
    ``trace_path`` is set once the block has ended."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """Named span visible in profiler traces."""
    return record_function(name)


class StepTimer:
    """Accumulates per-step wall times, skipping the first ``warmup`` steps
    (builds, caches, allocator growth)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._seen = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def total_steps(self) -> int:
        return self._seen

    def summary(self) -> str:
        if not self.times:
            return f"{self._seen} steps (all warmup)"
        return (
            f"{self._seen} steps | mean {self.mean * 1e3:.1f} ms"
            f" | min {min(self.times) * 1e3:.1f} ms"
            f" | max {max(self.times) * 1e3:.1f} ms"
        )
