"""A traced window under ``torch.profiler`` and what it is reduced to.

The device's busy time is the union of the time ranges of every kernel,
copy and memset on any stream (an instant where several run counts once);
the window is the host-clock length of the traced requests, from a
synchronised start to a synchronised end. Idle gaps are the stretches of
the window in which nothing ran on the device, each named after the
innermost host operation under way at its middle ("host python" where
none was).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

Interval = Tuple[float, float]  # seconds, on the profiler's clock


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, end
    copies: List[Tuple[str, float, float]] = field(default_factory=list)  # memcpy and memset
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # host op, seconds

    def device_seconds(self, prefix: str) -> float:
        return sum(e - s for n, s, e in self.copies if n.startswith(prefix))

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels + self.copies:
            total[name] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, s in self.gaps:
            total[name] += s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def union(ranges: List[Interval]) -> List[Interval]:
    """Merge overlapping ranges (sorted by start) into disjoint ones."""
    merged: List[List[float]] = []
    for start, end in sorted(ranges):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def name_gaps(gaps: List[Interval], host: List[Tuple[str, float, float]]) -> List[Tuple[str, float]]:
    """Each gap with the innermost host op (the latest started one still
    running) at its middle."""
    host = sorted(host, key=lambda h: h[1])
    out, active, i = [], [], 0
    for s, e in sorted(gaps):
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        out.append((active[-1][0] if active else "host python", e - s))
    return out


def profile(run: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Trace ``run()`` (the requests of the window) with CPU and CUDA
    activities and reduce it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        window = time.perf_counter() - t0
    kernels, copies, host = [], [], []
    for ev in prof.events():
        item = (ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if ev.device_type.name == "CUDA":
            (copies if ev.name.startswith(("Memcpy", "Memset")) else kernels).append(item)
        elif ev.device_type.name == "CPU":
            host.append(item)
    busy = union([(s, e) for _, s, e in kernels + copies])
    busy_s = sum(e - s for s, e in busy)
    # the device's gaps between its first and last operation of the window
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    return Trace(window, busy_s, kernels, copies, name_gaps(gaps, host))
