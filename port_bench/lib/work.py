"""The useful work of a request, counted on the reference at the cell's
shapes: operations of every conv (2 per multiply-add) and the bytes that
must cross the card at least once.

Stage 1 is counted per image and stage 2 per real RoI (padded RoIs of a
bucket are no useful work). A conv counts as int8 where its path lies under
one of the configuration's ``int8_groups`` and its contraction reaches
``int8_min_contraction``, the served model's rule; every other conv counts
as bf16. Bytes are the request's float32 images and RoIs, the weights at
their served width (1 byte int8, 2 bytes otherwise) and the float32
outputs.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class Work:
    image_ops: Dict[str, float]  # kind -> operations of stage 1 for one image
    roi_ops: Dict[str, float]  # kind -> operations of stage 2 for one RoI
    weight_bytes: float
    image_size: tuple
    mask_size: tuple

    def ops(self, images: int, rois: int) -> Dict[str, float]:
        kinds = set(self.image_ops) | set(self.roi_ops)
        return {k: images * self.image_ops.get(k, 0.0) + rois * self.roi_ops.get(k, 0.0)
                for k in kinds}

    def request_bytes(self, images: int, rois: int) -> float:
        h, w = self.image_size
        mh, mw = self.mask_size
        return (images * h * w * 3 * 4 + rois * 5 * 4 + self.weight_bytes
                + rois * mh * mw * 4 + images * h * w * 4)


def reference_module(config: dict):
    return importlib.import_module(f"port_bench.reference.{config['reference']}")


def count(config: dict) -> Work:
    ref_mod = reference_module(config)
    model = ref_mod.build(config, "meta")
    groups = tuple(config["int8_groups"])
    least = int(config["int8_min_contraction"])

    def kind(path: str, contraction: int) -> str:
        return "int8" if path.startswith(groups) and contraction >= least else "bf16"

    tally: Dict[str, float] = {}
    hooks = []
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, ref_mod.Conv):
            def hook(m, args, out, path=path):
                k = kind(path, m.contraction)
                tally[k] = tally.get(k, 0.0) + 2.0 * out.numel() * m.contraction
        elif isinstance(mod, ref_mod.Deconv):
            def hook(m, args, out, path=path):
                tally["bf16"] = tally.get("bf16", 0.0) + 2.0 * args[0].numel() * m.weight[0].numel()
        else:
            continue
        hooks.append(mod.register_forward_hook(hook))
    h, w = config["model"]["image_size"]
    rh, rw = config["model"]["roi_size"]
    try:
        with torch.no_grad():
            model.stage1(torch.empty(1, h, w, 3, device="meta"))
            image_ops, tally = tally, {}
            model.from_crops(torch.empty(1, 3, rh, rw, device="meta"),
                             torch.empty(1, 1, rh, rw, device="meta"))
            roi_ops = tally
    finally:
        for hk in hooks:
            hk.remove()
    weight_bytes = 0.0
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        for pname, p in mod.named_parameters(recurse=False):
            conv = isinstance(mod, ref_mod.Conv) and pname == "weight"
            weight_bytes += p.numel() * (1 if conv and kind(path, mod.contraction) == "int8"
                                         else 2)
    return Work(image_ops, roi_ops, weight_bytes, tuple(config["model"]["image_size"]),
                tuple(config["model"]["mask_size"]))
