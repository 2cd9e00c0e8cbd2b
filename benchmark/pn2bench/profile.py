"""The traced window: torch.profiler over a few units of the cell's own
work, reduced to device intervals, the benchmark's spans and the host's
top-level operations.

The benchmark's spans are torch.profiler.record_function ranges named
"bench:<what>", so they share the trace's clock. Device operations are the
trace's CUDA activities (kernels, copies, fills); "busy" is the union of
their intervals inside the window span ("bench:window"), and an idle gap
is named by the span and the outermost host operation running at its
middle ("python" where the host ran no traced operation: numpy, the
interpreter).
"""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]  # ns
    kernels: list[tuple[str, int, int]]  # (name, start, end) ns, sorted by start
    spans: list[tuple[str, int, int]]  # benchmark spans, without the window
    host_ops: list[tuple[str, int, int]]  # top-level host operations of the main thread
    units: int  # units of work (train steps, scenes) inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def clipped(self) -> list[tuple[str, int, int]]:
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.kernels if e > lo and s < hi]

    def busy_intervals(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for _, s, e in sorted(self.clipped(), key=lambda k: k[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        out, cur = [], lo
        for s, e in self.busy_intervals():
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            out.append((cur, hi))
        return out

    def activity_at(self, t: int) -> str:
        def at(items, starts):
            i = bisect.bisect_right(starts, t) - 1
            return items[i][0] if i >= 0 and items[i][2] >= t else None

        if not hasattr(self, "_starts"):
            self._starts = ([s for _, s, _ in self.spans], [s for _, s, _ in self.host_ops])
        span = at(self.spans, self._starts[0]) or "bench:window"
        op = at(self.host_ops, self._starts[1]) or "python"
        return f"{span[len('bench:'):]}/{op}"

    def device_ops(self, top: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for n, s, e in self.clipped():
            total[n] = total.get(n, 0.0) + (e - s) / 1e9
        return [[n[:160], t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for s, e in self.gaps():
            name = self.activity_at((s + e) // 2)
            total[name] = total.get(name, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def device_s(self, match) -> float:
        """Device seconds of the kernels whose name `match` accepts."""
        return sum(e - s for n, s, e in self.clipped() if match(n)) / 1e9


def traced(fn, units: int) -> Trace:
    """Run fn (which opens its own "bench:window" span and ends with a
    synchronise) under torch.profiler and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    main = next((e for e in events if e.name() == "bench:window"), None)
    if main is None:
        raise RuntimeError("the trace holds no bench:window span")
    window = (main.start_ns(), main.start_ns() + main.duration_ns())
    kernels, spans, ops = [], [], []
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith("bench:"):  # a span's mirror on the device's timeline is no operation
                kernels.append((name, s, end))
        elif name.startswith("bench:"):
            if name != "bench:window":
                spans.append((name, s, end))
        elif e.start_thread_id() == main.start_thread_id():
            ops.append((name, s, end))
    ops.sort(key=lambda o: (o[1], -o[2]))
    top, last_end = [], -1
    for o in ops:  # the outermost operations: each starts after the last one ended
        if o[1] >= last_end:
            top.append(o)
            last_end = o[2]
    return Trace(window, sorted(kernels, key=lambda k: k[1]), sorted(spans, key=lambda k: k[1]), top, units)
