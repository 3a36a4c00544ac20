"""The baseline single-scale ROI segmentation model.

Counterpart of the JAX package's ``models/baseline.py``: RoIAlign of one
feature map (28 x 28) -> 1x1 in-projection -> two residual blocks -> two
2x transposed convs (k 4, stride 2; flax's SAME padding, torch's
``padding=1``) to 112 x 112, the 56 x 56 map fused with the 112 x 112 one
resized down -> 3-class logits, resized to the mask size. The feature map
is the model's own :class:`.multiscale.ConvFeaturePyramid` ``layer_34``
(1024 channels at stride 8) or one passed as ``features=``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.sampling import resize_bilinear, roi_align
from .blocks import ConvNormAct, ResidualBlock
from .multiscale import ConvFeaturePyramid

_NCHW = (2, 3)


class ROISegmentationHead(nn.Module):
    """features (B, h, w, C) NHWC and rois (N, 5) -> logits (N, 3, mh, mw)."""

    def __init__(self, in_channels: int = 1024, mid_channels: int = 256, num_classes: int = 3,
                 roi_size: Tuple[int, int] = (28, 28), mask_size: Tuple[int, int] = (56, 56),
                 norm: str = "layernorm2d", norm_groups: int = 8, activation: str = "relu",
                 activation_beta: float = 1.0):
        super().__init__()
        kw = dict(norm=norm, norm_groups=norm_groups, activation=activation,
                  activation_beta=activation_beta)
        mc = mid_channels
        self.roi_size, self.mask_size = tuple(roi_size), tuple(mask_size)
        self.conv_in = ConvNormAct(in_channels, mc, kernel=1, **kw)
        self.res1 = ResidualBlock(mc, **kw)
        self.res2 = ResidualBlock(mc, **kw)
        self.up1 = nn.ConvTranspose2d(mc, mc, 4, stride=2, padding=1)
        self.up1_na = ConvNormAct(mc, mc, kernel=1, **kw)
        self.refine1 = ResidualBlock(mc, **kw)
        self.up2 = nn.ConvTranspose2d(mc, mc // 2, 4, stride=2, padding=1)
        self.up2_na = ConvNormAct(mc // 2, mc // 2, kernel=1, **kw)
        self.refine2a = ConvNormAct(mc // 2, mc // 2, **kw)
        self.refine2b = ConvNormAct(mc // 2, mc // 2, **kw)
        self.final_conv = ConvNormAct(mc // 2, mc // 4, **kw)
        self.fusion = nn.Conv2d(mc + mc // 4, mc // 2, 1)
        self.classifier = nn.Conv2d(mc // 2, num_classes, 1)

    def forward(self, features: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        rh, rw = self.roi_size
        mh, mw = self.mask_size
        h, w = features.shape[1:3]
        x = roi_align(features, rois, rh, rw, spatial_scale=(float(h), float(w)), aligned=True)
        x = self.res2(self.res1(self.conv_in(x.permute(0, 3, 1, 2))))
        x56 = self.refine1(self.up1_na(self.up1(x)))
        x112 = self.refine2b(self.refine2a(self.up2_na(self.up2(x56))))
        x112 = self.final_conv(x112)
        x112_down = resize_bilinear(x112, x56.shape[2], x56.shape[3], axes=_NCHW)
        logits = self.classifier(self.fusion(torch.cat([x56, x112_down], dim=1)))
        if tuple(logits.shape[2:]) != (mh, mw):
            logits = resize_bilinear(logits, mh, mw, axes=_NCHW)
        return logits


class ROISegmentationModel(nn.Module):
    """``forward(images (B, H, W, 3), rois (N, 5), features=None) ->
    (logits (N, mh, mw, 3), {"features": (B, h, w, C)})``, NHWC. With
    ``pyramid=False`` the model holds no ``pyramid`` (the JAX tree of a
    model initialised with ``features=``) and needs ``features=``."""

    def __init__(self, feature_channels: int = 1024, roi_size: Tuple[int, int] = (28, 28),
                 mask_size: Tuple[int, int] = (56, 56), norm: str = "layernorm2d",
                 norm_groups: int = 8, pyramid: bool = True):
        super().__init__()
        self.roi_size, self.mask_size = tuple(roi_size), tuple(mask_size)
        self.pyramid = (ConvFeaturePyramid(("layer_34",), norm=norm, norm_groups=norm_groups)
                        if pyramid else None)
        self.head = ROISegmentationHead(feature_channels, roi_size=roi_size, mask_size=mask_size,
                                        norm=norm, norm_groups=norm_groups)

    def forward(self, images: torch.Tensor, rois: torch.Tensor,
                features: Optional[torch.Tensor] = None):
        if features is None:
            if self.pyramid is None:
                raise ValueError("a model built with pyramid=False needs features=")
            features = self.pyramid(images.permute(0, 3, 1, 2))["layer_34"].permute(0, 2, 3, 1)
        logits = self.head(features, rois)
        return logits.permute(0, 2, 3, 1), {"features": features}
