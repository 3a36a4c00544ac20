"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference and the result line.

Set-up (``setup_s``) runs from the process's start to the first timed
request: the weights drawn on the device from the seed, the served model
and engine built (the kernels load from, or the first time build into,
``build/`` in the checkout), one ``engine.calibrate`` on a seeded request of
the cell's largest shape, the requests made, and each request shape of the
pool served twice.

The window is a closed loop with one caller: request after request of the
pool, in a seeded order, each ``engine(images, rois)`` with numpy in and
numpy out, until the first request that ends at or after ``--seconds`` (and
at least once through the pool, so every request compared was served);
the window's length is the time from the first call to that request's end.
With ``--trace 1`` the same window runs, then ``trace_requests`` more
under the profiler.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, spec, traffic, weights as weights_mod
from .trace import profile
from .work import count


def port_system(config: dict, weights: Dict[str, torch.Tensor], calibration: traffic.Request,
                device):
    """The served engine, calibrated once on the calibration request where
    it serves int8."""
    from .system import build_engine

    engine = build_engine(config, weights, device)
    if config["engine"].get("quantize") == "int8":
        engine.calibrate(calibration.images, calibration.rois)
    return engine


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def logits_source(system) -> Callable[[], Optional[torch.Tensor]]:
    """The class logits (N, mh, mw, 3) of the system's last call: the served
    model's output, kept by a forward hook on ``system.model`` (before the
    engine's post-processing), or the ``last_logits`` a system without a
    served model keeps."""
    model = getattr(system, "model", None)
    if not isinstance(model, torch.nn.Module):
        return lambda: system.last_logits
    held: Dict[str, torch.Tensor] = {}
    model.register_forward_hook(lambda module, args, out: held.__setitem__("logits", out[0]))
    return lambda: held.get("logits")


def served_logits(logits: Optional[torch.Tensor], n: int) -> Optional[np.ndarray]:
    return None if logits is None else logits[:n].float().cpu().numpy()


def malformed(req: traffic.Request, inst, binary) -> bool:
    """An answer without a mask for each RoI or a binary mask for each image."""
    return (inst.shape[0] != req.rois.shape[0] or binary is None
            or binary.shape[0] != req.images.shape[0])


def _window(system, logits, pool, order, seconds: float, keep: dict) -> dict:
    """Closed loop over ``pool`` in ``order`` until the first request ending
    at or after ``seconds``, once through the pool at the least."""
    images, rois, failed, i = 0, 0, 0, 0
    t_open = time.perf_counter()
    while True:
        k = order[i % len(order)]
        req = pool[k]
        inst, binary = system(req.images, req.rois)
        t1 = time.perf_counter()
        keep[k] = (inst, binary, logits())
        failed += malformed(req, inst, binary)
        images += req.images.shape[0]
        rois += req.rois.shape[0]
        i += 1
        if t1 - t_open >= seconds and i >= len(order):
            break
    return {"requests": i, "images": images, "rois": rois, "failed": failed,
            "seconds": t1 - t_open, "next": i}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_system: Callable = port_system) -> Tuple[dict, List[str]]:
    """The result line's object and the lines comparing each number with its
    limit."""
    config, mix = cell["config"], cell["traffic"]
    from .system import parameter_shapes

    image_size = tuple(config["model"]["image_size"])
    w = weights_mod.draw(parameter_shapes(config), seed, device)
    calib = traffic.calibration(mix, image_size, seed)
    system = make_system(config, w, calib, device)
    logits = logits_source(system)
    pool = traffic.pool(mix, image_size, seed)
    order = traffic.order(mix, seed)
    seen = set()
    for req in pool:
        shape = (req.images.shape[0], req.rois.shape[0])
        if shape not in seen:
            seen.add(shape)
            for _ in range(2):
                system(req.images, req.rois)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    keep: Dict[int, tuple] = {}
    win = _window(system, logits, pool, order, seconds, keep)
    ctx = SimpleNamespace(setup_s=setup_s, window=win, trace=None, traced=None, work=None)
    attempted, failed = win["requests"], win["failed"]
    if trace:
        traced: List[Tuple[int, int]] = []
        bad: List[bool] = []

        def traced_requests():
            for j in range(int(mix["trace_requests"])):
                k = order[(win["next"] + j) % len(order)]
                req = pool[k]
                keep[k] = (*system(req.images, req.rois), logits())
                bad.append(malformed(req, *keep[k][:2]))
                traced.append((req.images.shape[0], req.rois.shape[0]))

        ctx.trace = profile(traced_requests, lambda: _sync(device))
        ctx.traced = traced
        attempted += len(traced)
        failed += sum(bad)
    device_info = device_block(device, ctx.trace)
    served = {k: (inst, binary, served_logits(lg, pool[k].rois.shape[0]))
              for k, (inst, binary, lg) in keep.items()}
    del system, logits, keep
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    compared = traffic.checked(mix, seed)
    refs = check.run_reference(config, w, [pool[k] for k in compared], device)
    numbers = check.compare([(served[k], r) for k, r in zip(compared, refs)])
    ok, lines = check.verdict(numbers, cell["limits"])

    if trace:
        ctx.work = count(config)
        metrics = spec.metric_values("metrics", cell["per_layer"], ctx)
    else:
        metrics = spec.metric_values("endtoend", cell["end_to_end"], ctx)
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(), "idle_gaps": ctx.trace.top_gaps()}
    result["checks"] = {k: {"value": numbers[k], "limit": float(cell["limits"][k]["limit"])}
                        for k in check.NUMBERS}
    return result, lines


def device_block(device, tr: Optional[object]) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info
