"""The control of the comparison: the reference put in the served model's
place, computed one precision step below what the configuration states.

The configuration serves its ``int8_groups`` convs (contraction at least
``int8_min_contraction``) in int8; the control computes exactly those convs
on 4-bit symmetric codes (per-tensor input scales from the abs-max the
reference records on the cell's calibration request, per-channel weight
scales) and everything else in float32. A comparison that passes the
control cannot tell int8 from int4 and is too loose.
"""

from __future__ import annotations

from typing import Dict

import torch

from .check import reference_outputs
from .traffic import Request
from .work import reference_module

BITS = 4


class Control:
    """``control(images, rois)`` -> numpy (instance masks, binary masks), as
    ``InferenceEngine.__call__`` returns them; ``last_logits`` holds the
    class logits (N, mh, mw, 3) of the last call."""

    def __init__(self, config: dict, weights: Dict[str, torch.Tensor], calibration: Request,
                 device):
        ref_mod = reference_module(config)
        self.config, self.device = config, device
        self.ref = ref_mod.build(config, device)
        ref_mod.load(self.ref, weights)
        blocks = config["reference_blocks"]
        self.blocks = (blocks["images"], blocks["rois"])
        self.tf32_off()
        self.last_logits = None
        with ref_mod.record_ranges(self.ref) as ranges:
            reference_outputs(self.ref, calibration, device, *self.blocks)
        self.quantized = ref_mod.quantize_convs(self.ref, ranges, config["int8_groups"],
                                                config["int8_min_contraction"], BITS)

    @staticmethod
    def tf32_off() -> None:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __call__(self, images, rois):
        self.tf32_off()
        logits, inst, binary = reference_outputs(self.ref, Request(images, rois), self.device,
                                                 *self.blocks)
        self.last_logits = torch.from_numpy(logits).permute(0, 2, 3, 1)
        return inst, binary
