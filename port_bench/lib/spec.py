"""Cells by name: everything a run needs is found from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a file of its own, and so is each cell's table of limits and each
metric's reader:

* ``port_bench/configs/<config>.json``: the served model's and engine's
  keyword arguments, every one given, with the source, ``reduced``,
  ``assumed``, the conv groups served in int8 and the reference's name;
* ``port_bench/traffic/<traffic>.json``: the parameters that
  :mod:`port_bench.lib.traffic` turns into requests;
* ``port_bench/limits/<cell>.json``: the numbers compared with the
  reference and the limit of each;
* ``port_bench/endtoend/<metric>.py`` and ``port_bench/metrics/<metric>.py``
  (or the part of the name before its first dot): ``read(ctx)``.

Adding a cell, a configuration, a mix or a metric is adding files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports: ``{"workload", "config", "traffic", "limits",
    "end_to_end", "per_layer"}``."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return {"workload": w,
            "config": load_json(BENCH_DIR / "configs" / f"{w['config']}.json"),
            "traffic": load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(BENCH_DIR / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def reader(kind: str, name: str) -> Callable:
    """``read`` of ``port_bench/<kind>/<name>.py``, or of the file named by
    the part of ``name`` before its first dot (one reader for a quantity
    split by the end-to-end metric it moves)."""
    for stem in (name, name.split(".")[0]):
        path = BENCH_DIR / kind / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for {kind} metric {name!r}")


def metric_values(kind: str, metrics: List[dict], ctx) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(kind, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
