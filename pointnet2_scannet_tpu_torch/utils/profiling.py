"""Profiling and tracing (the JAX package's utils/profiling.py).

  - StepTimer: named wall-clock segments (fetch / forward / step ...), the
    accounting the Solver reports, as a reusable utility.
  - trace(log_dir): torch.profiler over the host and, where there is one,
    the card; the Chrome / TensorBoard trace file goes into log_dir when the
    context closes.
  - device_memory_stats(): torch.cuda.memory_stats of each visible card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StepTimer:
    """Accumulates named wall-clock segments (fetch/forward/step/...)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def summary(self) -> dict[str, float]:
        return {k: self.mean(k) for k in self.totals}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def trace(log_dir, *, cuda: bool | None = None):
    """`with trace("outputs/run/trace"): step()`: a torch.profiler context
    over host activity and, with cuda (None: where a card is visible), the
    card's; it writes one *.pt.trace.json into log_dir on exit."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)))


def device_memory_stats() -> list[dict]:
    """torch.cuda.memory_stats (allocated.all.current etc., bytes) of each
    visible card, with its name under "device"; [] without one."""
    if not torch.cuda.is_available():
        return []
    return [{"device": f"cuda:{i}", **torch.cuda.memory_stats(i)} for i in range(torch.cuda.device_count())]
