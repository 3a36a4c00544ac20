"""The useful work of the head's bg/fg EnhancedUNet, counted as
:mod:`.work` counts a request's, restricted to the reference's modules under
``head/base_head/bg_vs_fg_unet/``: operations of each conv and transposed
conv there for one RoI (a conv int8 where the configuration's rule says so,
the rest bf16) and the bytes of its weights at their served width.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from .work import reference_module

UNET = "head/base_head/bg_vs_fg_unet/"


@dataclass
class UnetWork:
    roi_ops: Dict[str, float]  # kind -> operations of the UNet for one RoI
    weight_bytes: float

    def ops(self, rois: int) -> Dict[str, float]:
        return {k: rois * v for k, v in self.roi_ops.items()}


def count(config: dict) -> UnetWork:
    ref_mod = reference_module(config)
    model = ref_mod.build(config, "meta")
    groups = tuple(config["int8_groups"])
    least = int(config["int8_min_contraction"])

    def kind(path: str, contraction: int) -> str:
        return "int8" if path.startswith(groups) and contraction >= least else "bf16"

    tally: Dict[str, float] = {}
    hooks = []
    weight_bytes = 0.0
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if not path.startswith(UNET):
            continue
        conv = isinstance(mod, ref_mod.Conv)
        for pname, p in mod.named_parameters(recurse=False):
            int8 = conv and pname == "weight" and kind(path, mod.contraction) == "int8"
            weight_bytes += p.numel() * (1 if int8 else 2)
        if conv:
            def hook(m, args, out, path=path):
                k = kind(path, m.contraction)
                tally[k] = tally.get(k, 0.0) + 2.0 * out.numel() * m.contraction
        elif isinstance(mod, ref_mod.Deconv):
            def hook(m, args, out):
                tally["bf16"] = tally.get("bf16", 0.0) + 2.0 * args[0].numel() * m.weight[0].numel()
        else:
            continue
        hooks.append(mod.register_forward_hook(hook))
    rh, rw = config["model"]["roi_size"]
    try:
        with torch.no_grad():
            model.from_crops(torch.empty(1, 3, rh, rw, device="meta"),
                             torch.empty(1, 1, rh, rw, device="meta"))
    finally:
        for hk in hooks:
            hk.remove()
    return UnetWork(tally, weight_bytes)
