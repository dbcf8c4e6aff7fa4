"""Profiling hooks: torch.profiler traces and step timing.

Port of pixart_sigma_tpu/utils/profiling.py, whose trace is XLA's profiler:
here `trace` records the host and, on the card, the device activity with
`torch.profiler` and writes a Chrome trace; `StepTimer` times steps after a
warm-up, synchronising the card before it reads the clock (launches return
before the card has run them); `annotate` names a span of the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, *, enabled: bool = True) -> Iterator[Optional[torch.profiler.profile]]:
    """Record the enclosed steps; writes `<log_dir>/trace.json`, a Chrome
    trace (chrome://tracing or Perfetto). Yields the profiler (its
    `key_averages()` for a table), or None when not `enabled`."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock per-step timing, skipping the first `skip_first` steps
    (builds and warm-up). The card is synchronised at each step's start and
    end, so a step's time covers its device work."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.skip_first:
            self.total += dt

    @property
    def mean_ms(self) -> float:
        steps = max(1, self.count - self.skip_first)
        return self.total / steps * 1000.0


def annotate(name: str):
    """A named span in the trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
