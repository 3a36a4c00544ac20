"""Student UNet with a projected stride-8 encoder feature, for YOLO-feature
distillation.

Counterpart of the JAX package's ``models/yolo_distill.py``: the
people-segmentation UNet plus a projection head on the stride-8 encoder
feature (``feats[2]``; 40 channels at 80 x 80 for a 640 x 640 B0):
``proj_conv0`` 1x1 to ``projection_hidden_dim`` -> ``proj_bn`` (BatchNorm,
momentum 0.9, eps 1e-5) -> ReLU -> ``proj_conv1`` 1x1 to
``yolo_feature_dim`` (the YOLOv9 ``layer_34`` width, 1024). With
``projection_hidden_dim`` None or 0 the head is ``proj_conv1`` alone.

The module is a :class:`.unet.PeopleSegmentationUNet` with those modules
added, so its ``encoder``, ``decoder{i}`` and ``seg_head`` keys are the
deployed UNet's: :func:`strip_projector` drops the ``proj_*`` keys and the
rest loads ``strict=True`` into a ``PeopleSegmentationUNet``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm2d
from .efficientnet import encoder_feature_channels
from .unet import PeopleSegmentationUNet


class YOLOFeatureDistillStudent(PeopleSegmentationUNet):
    """``forward(images (B, 3, H, W) in [0, 1], return_features=False)`` ->
    logits (B, classes, H, W), and with ``return_features`` also the
    projected feature (B, yolo_feature_dim, H / 8, W / 8)."""

    def __init__(self, encoder_variant: str = "b0",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16), classes: int = 1,
                 projection_hidden_dim: Optional[int] = 768, yolo_feature_dim: int = 1024,
                 normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406),
                 normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)):
        super().__init__(encoder_variant, decoder_channels, classes, normalize_mean,
                         normalize_std)
        ch = encoder_feature_channels(encoder_variant)[2]
        if projection_hidden_dim:
            self.proj_conv0 = nn.Conv2d(ch, projection_hidden_dim, 1)
            self.proj_bn = BatchNorm2d(projection_hidden_dim, eps=1e-5, momentum=0.9)
            ch = projection_hidden_dim
        else:
            self.proj_conv0 = self.proj_bn = None
        self.proj_conv1 = nn.Conv2d(ch, yolo_feature_dim, 1)

    def forward(self, images: torch.Tensor, return_features: bool = False):
        feats = self.encoder(self.normalize(images))
        projected = None
        if return_features:
            h = feats[2]  # the stride-8 feature
            if self.proj_conv0 is not None:
                h = F.relu(self.proj_bn(self.proj_conv0(h)))
            projected = self.proj_conv1(h)
        skips = list(feats[:-1])[::-1]
        h = feats[-1]
        for i in range(self.n_decoders):
            h = getattr(self, f"decoder{i}")(h, skips[i] if i < len(skips) else None)
        logits = self.seg_head(h)
        return (logits, projected) if return_features else logits


def strip_projector(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A student's ``state_dict`` without the ``proj_*`` keys: the deployed
    ``PeopleSegmentationUNet``'s (the projector is train-time only)."""
    return {k: v for k, v in state.items() if not k.split(".")[0].startswith("proj_")}
