"""Deploy-time post-processing: the mask dilation logit boost (NHWC)."""

from __future__ import annotations

import torch

from ..ops.morphology import dilate


def mask_dilation_logit_boost(logits: torch.Tensor, dilation_pixels: int = 1) -> torch.Tensor:
    """softmax -> dilate the target-class probability by a (2d+1) max pool
    -> +2.0 on the target logit where the dilated probability exceeds the
    original by more than 0.1. logits (N, H, W, 3)."""
    if dilation_pixels <= 0:
        return logits
    target = torch.softmax(logits, dim=-1)[..., 1:2]
    dilated = dilate(target, dilation_pixels)
    boost = torch.where(dilated - target > 0.1, 2.0, 0.0).to(logits.dtype)
    return torch.cat([logits[..., 0:1], logits[..., 1:2] + boost, logits[..., 2:]], dim=-1)
