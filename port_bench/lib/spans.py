"""The program's spans on the device's clock: a second traced window, served
with the port's tracing on, and what it is reduced to.

A span (``hiseg.<stage>``, ``human_instance_segmentation_tpu_torch.tracing``)
is a ``record_function`` range: under the profiler it is a host event on the
clock of the device's kernels, and also a device event (a user annotation)
that is no work of the device. :func:`reduce` keeps those annotations apart
from kernels, copies and memsets, so busy time and the top ops are what
``trace.py`` makes of the same window without spans.

Each device op (kernel, copy, memset) belongs to the spans open on the host
when it was launched: its launch is the CUDA API call (``cuda*``, ``cu*``)
with its correlation id; where none is found, the device annotation
ranges that hold it (one stream runs the stages in turn). A stage's device time is the
union of its ops' ranges. Each idle gap belongs to the spans open on the
host at its middle: ``engine.forward`` (the switches and the host's dispatch
of the stages), else ``engine.call`` (pad, upload, download), else none.

The window is served by an engine built anew after the run (a metric reader
sees only the run's context): the cell and seed of the command line, the
same weights, calibration, warm-up and requests, in the order of the first
traced window. Its wall time a request, against the first window's, bounds
the cost of the spans when on.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .trace import Trace, name_gaps, union

PREFIX = "hiseg."  # the port's span prefix (``tracing.PREFIX``)


@dataclass(frozen=True)
class Event:
    """One profiler event: seconds on the profiler's clock; ``id`` the
    correlation id that ties a device op to its launch (a CUDA API call,
    ``cuda*`` or ``cu*``); ``annotation`` None where the profiler does not
    say."""
    name: str
    device: str  # "CPU" or "CUDA"
    start: float
    end: float
    id: int = 0
    annotation: Optional[bool] = None


@dataclass
class Spans:
    trace: Trace  # busy time, ops and named gaps, annotations left out
    requests: int  # ``engine.call`` spans
    stage_s: Dict[str, float]  # span name (no prefix) -> device busy seconds of its ops
    idle_s: Dict[str, float]  # "forward", "engine", "outside" -> gap seconds
    busy_outside_s: float  # busy seconds of ops launched outside every span
    annotations: int
    counters: List[dict] = field(default_factory=list)  # each ``engine.call``'s

    def per_request_ms(self, seconds: float) -> Optional[float]:
        return seconds / self.requests * 1e3 if self.requests else None


def from_profiler(events) -> List[Event]:
    """``prof.events()`` as :class:`Event` records."""
    return [Event(ev.name, ev.device_type.name, ev.time_range.start * 1e-6,
                  ev.time_range.end * 1e-6, int(ev.id), getattr(ev, "is_user_annotation", None))
            for ev in events]


def _annotation(ev: Event) -> bool:
    return ev.annotation if ev.annotation is not None else ev.name.startswith(PREFIX)


def _open(spans: Sequence[Tuple[str, float, float]], t: float) -> set:
    return {name for name, s, e in spans if s <= t <= e}


def reduce(events: Sequence[Event], window_s: float) -> Spans:
    """The window's busy time, gaps and ops (as ``trace.profile`` reduces
    them, annotations set apart), each stage's device time and the idle
    time by the stage under way on the host."""
    kernels, copies, host, spans, annotations = [], [], [], [], []
    launched: Dict[int, float] = {}
    for ev in events:
        item = (ev.name, ev.start, ev.end)
        if ev.device == "CUDA":
            if _annotation(ev):
                if ev.name.startswith(PREFIX):
                    annotations.append((ev.name[len(PREFIX):], ev.start, ev.end))
            else:
                (copies if ev.name.startswith(("Memcpy", "Memset")) else kernels).append(
                    (*item, ev.id))
        elif ev.device == "CPU":
            host.append(item)
            if ev.name.startswith(PREFIX):
                spans.append((ev.name[len(PREFIX):], ev.start, ev.end))
            elif ev.name.startswith("cu"):
                launched[ev.id] = ev.start
    ops = kernels + copies
    busy = union([(s, e) for _, s, e, _ in ops])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    trace = Trace(window_s, sum(e - s for s, e in busy), [k[:3] for k in kernels],
                  [c[:3] for c in copies], name_gaps(gaps, host))

    by_span: Dict[str, List[Tuple[float, float]]] = {}
    outside: List[Tuple[float, float]] = []
    for _, s, e, cid in ops:
        t = launched.get(cid)
        names = _open(spans, t) if t is not None else _open(annotations, 0.5 * (s + e))
        for name in names:
            by_span.setdefault(name, []).append((s, e))
        if not names:
            outside.append((s, e))
    stage_s = {k: sum(e - s for s, e in union(v)) for k, v in by_span.items()}
    idle_s = {"forward": 0.0, "engine": 0.0, "outside": 0.0}
    for s, e in gaps:
        names = _open(spans, 0.5 * (s + e))
        where = "forward" if "engine.forward" in names else (
            "engine" if "engine.call" in names else "outside")
        idle_s[where] += e - s
    return Spans(trace, sum(1 for name, _, _ in spans if name == "engine.call"), stage_s,
                 idle_s, sum(e - s for s, e in union(outside)), len(annotations))


def second_window(cell: dict, seed: int, start: int, device) -> Optional[Spans]:
    """``trace_requests`` requests of the cell from ``start`` in its order,
    served with the port's tracing on under the profiler by an engine built
    as the run builds it; None where the port has no tracing."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from . import runner, traffic, weights
    from .system import parameter_shapes

    config, mix = cell["config"], cell["traffic"]
    image_size = tuple(config["model"]["image_size"])
    w = weights.draw(parameter_shapes(config), seed, device)
    system = runner.port_system(config, w, traffic.calibration(mix, image_size, seed), device)
    # the port's tracing, reached through the served engine's module, so that
    # lib/system.py stays the one module that imports the port
    tracing = getattr(inspect.getmodule(system), "tracing", None)
    if tracing is None:
        return None
    pool, order = traffic.pool(mix, image_size, seed), traffic.order(mix, seed)
    for req in {(r.images.shape[0], r.rois.shape[0]): r for r in pool}.values():
        for _ in range(2):
            system(req.images, req.rois)
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU, *([ProfilerActivity.CUDA] if cuda else [])]
    runner._sync(device)
    with torch_profile(activities=activities) as prof:
        runner._sync(device)
        with tracing.recording() as records:
            t0 = time.perf_counter()
            for j in range(int(mix["trace_requests"])):
                req = pool[order[(start + j) % len(order)]]
                system(req.images, req.rois)
            runner._sync(device)
            window_s = time.perf_counter() - t0
    out = reduce(from_profiler(prof.events()), window_s)
    out.counters = [r["counters"] for r in records if r["name"] == PREFIX + "engine.call"]
    del system, w, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _command_line() -> Optional[Tuple[str, int]]:
    """The cell and seed of ``port_bench.run``'s command line, if this is one."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    try:
        args, _ = p.parse_known_args(sys.argv[1:])
    except SystemExit:
        return None
    return None if args.workload is None or args.seed is None else (args.workload, args.seed)


def served(ctx) -> Optional[Spans]:
    """The run's second traced window, served once and kept on ``ctx``: None
    without a traced first window, a CUDA device or the command line's cell."""
    if not hasattr(ctx, "spans"):
        ctx.spans = None
        found = _command_line()
        if ctx.trace is not None and ctx.traced and found and torch.cuda.is_available():
            from . import spec

            ctx.spans = second_window(spec.cell(found[0]), found[1], ctx.window["next"],
                                      "cuda:0")
    return ctx.spans
