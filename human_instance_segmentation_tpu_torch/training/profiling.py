"""Tracing and timing helpers.

Counterpart of the JAX package's ``training/profiling.py``:
- :func:`trace` records ``torch.profiler`` over its block and writes a
  Chrome trace (``trace.json``) into ``log_dir``;
- :class:`StepTimer` keeps an EMA of step time and images per second (a
  copy of JAX's);
- :func:`chained_time` times ``iters`` calls one after another: between two
  CUDA events on the card (the calls queue on one stream, so each starts
  when the one before it ends, as JAX's chained ``fori_loop`` does), or with
  ``perf_counter`` on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where the card is
    there); yields the profiler, and writes ``log_dir/trace.json`` at exit
    (open it in Perfetto or ``chrome://tracing``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class StepTimer:
    """EMA step timing + images/sec for host loops."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._avg: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._avg = dt if self._avg is None else self.ema * self._avg + (1 - self.ema) * dt
        return dt

    @property
    def avg_step_s(self) -> float:
        return self._avg or 0.0

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self._avg if self._avg else 0.0


def chained_time(fn: Callable, *args, iters: int = 10) -> float:
    """Seconds per call of ``fn(*args)``, over ``iters`` calls in a row after
    one warm-up call: between CUDA events when the first argument is a CUDA
    tensor, else with ``perf_counter``."""
    import torch

    fn(*args)
    dev = args[0].device if args and isinstance(args[0], torch.Tensor) else None
    if dev is not None and dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
