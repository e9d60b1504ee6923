"""Profiling and throughput instrumentation (port of
`graphax/utils/profiling.py`): a `torch.profiler` trace around a region,
written as a Chrome trace, and an edges/s (or any unit/s) meter."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def profile_trace(log_dir: str = "./graphax-trace", enabled: bool = True):
    """Trace the region under ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write it into ``log_dir`` as a
    Chrome trace, ``trace.json`` (viewable in Perfetto or
    chrome://tracing). Yields the profiler, or None when disabled. A
    failure of the profiler raises: a trace that was asked for is never
    skipped silently (graphax's version swallows them)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """edges/s (or any unit/s) accumulated over the regions it wraps.

    The meter reads the host clock. The card runs its work asynchronously,
    so the time covers the card's work only if the caller synchronises the
    device before the region ends (``torch.cuda.synchronize()`` inside the
    ``with``)."""

    def __init__(self, units_per_call: float):
        self.units = units_per_call
        self.total_units = 0.0
        self.total_time = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total_time += time.perf_counter() - self._t0
        self.total_units += self.units
        return False

    @property
    def rate(self) -> float:
        return self.total_units / self.total_time if self.total_time else 0.0
