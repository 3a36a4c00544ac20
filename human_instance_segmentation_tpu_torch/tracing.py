"""Spans and counters on the serving path, off unless a block turns them on.

``span(name)`` marks a stage (``with tracing.span("model.stage2"):``),
``count(name, n)`` adds to the open request's counters, and
``recording(path=None)`` turns both on for its block, keeps the records in
memory and yields them (the list fills as spans close), writing them as
JSON lines at exit when given a path.

Off (the default) a span is one check of a module-level flag and returns a
shared no-op context: no profiler range, no record. On, each span

* records its name (with :data:`PREFIX`), the request it belongs to (every
  span nested in one outermost span, an ``engine.call``, shares its id),
  the index of its parent record, host start and end from
  ``time.perf_counter_ns`` and its self time (duration less its children's);
* opens a ``torch.profiler.record_function`` range of the same name, so that
  under the profiler it lies on the clock of the device's kernels. The
  profiler also shows the range on the device's timeline (a user
  annotation): a reader that sums device events has to set those apart.

The outermost open span is the request: :func:`count` adds to its
``counters``, and at its close they gain the launches of every kernel family
made inside it (the delta of each entry point's ``.launches``, of
``QConv.int8_calls`` and of ``QConv.operand_builds``, see
:func:`launch_counts`). One serving thread is assumed.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from torch.autograd.profiler import record_function

PREFIX = "hiseg."

_on = False
_records: List[dict] = []
_stack: List["_Span"] = []  # open spans, outermost first
_requests = 0
_NULL = contextlib.nullcontext()


def launch_counts() -> Dict[str, int]:
    """The always-on counters of the kernel entry points, by family."""
    from .ops import (cuda_head, cuda_kernels, cuda_mbconv, cuda_norm, cuda_roi_align, cuda_tail,
                      quant)

    fns = (quant.qconv2d, quant.s8_matmul, cuda_head.conv_ln_act, cuda_head.conv_ln_act_s8,
           cuda_tail.tail, cuda_tail.tail_q, cuda_mbconv.mbconv_sums, cuda_mbconv.mbconv_apply,
           cuda_roi_align.roi_align, cuda_kernels.bilateral_filter, cuda_kernels.edge_smooth,
           cuda_norm.ln_act)
    out = {f"launches.{f.__name__}": f.launches for f in fns}
    out["int8_calls"] = quant.QConv.int8_calls
    out["operand_builds"] = quant.QConv.operand_builds
    return out


class _Span:
    __slots__ = ("record", "index", "children_ns", "range", "launches")

    def __init__(self, name: str):
        global _requests
        parent = _stack[-1] if _stack else None
        if parent is None:
            _requests += 1
        self.record = {"name": PREFIX + name,
                       "request": parent.record["request"] if parent else _requests,
                       "parent": parent.index if parent else None,
                       "start_ns": 0, "end_ns": 0, "self_ns": 0}
        if parent is None:
            self.record["counters"] = {}
        self.index = len(_records)
        self.children_ns = 0
        self.launches = launch_counts() if parent is None else None
        _records.append(self.record)

    def __enter__(self) -> dict:
        _stack.append(self)
        self.range = record_function(self.record["name"])
        self.range.__enter__()
        self.record["start_ns"] = time.perf_counter_ns()
        return self.record

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _stack.pop()
        rec = self.record
        rec["end_ns"] = end
        duration = end - rec["start_ns"]
        rec["self_ns"] = duration - self.children_ns
        if _stack:
            _stack[-1].children_ns += duration
        if self.launches is not None:
            for k, v in launch_counts().items():
                rec["counters"][k] = rec["counters"].get(k, 0) + v - self.launches[k]


def enabled() -> bool:
    """Whether spans and counters are on (inside :func:`recording`)."""
    return _on


def span(name: str):
    """A context marking the stage ``name``: a no-op unless tracing is on."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open request's counter ``name`` (nothing when off or
    outside every span)."""
    if _on and _stack:
        counters = _stack[0].record["counters"]
        counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def recording(path: Optional[str] = None) -> Iterator[List[dict]]:
    """Turn spans and counters on for the block; yields the list of records
    (each span's, in the order they opened) and writes them to ``path`` as
    JSON lines at exit."""
    global _on, _records
    _on, _records = True, []
    records = _records
    try:
        yield records
    finally:
        _on = False
        _stack.clear()
        if path is not None:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in records)
