"""Tracing: :func:`trace` records ``torch.profiler`` over its block with the
port's spans on, and writes a Chrome trace (``trace.json``) and the span
records (``spans.jsonl``) into ``log_dir``. Counterpart of the JAX
package's ``training/profiling.py``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

from .. import tracing


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where the card is
    there) with :mod:`..tracing` on, so the trace shows the serving stages
    by name; yields the profiler, and writes ``log_dir/trace.json`` (open it
    in Perfetto or ``chrome://tracing``) and ``log_dir/spans.jsonl`` at exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof, \
            tracing.recording(str(Path(log_dir) / "spans.jsonl")):
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
