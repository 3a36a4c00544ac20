"""Full-image people-segmentation UNet, stage 1 (NCHW, plain form).

Counterpart of the JAX package's ``models/unet.py`` without the phase-form
serving rewrites (``fused_tail``, ``encoder_s2d_front``, ``pallas_tail``,
``n4_tail``): ImageNet normalisation, the EfficientNet encoder, five smp
decoder stages (2x upsample, skip concat, (conv3x3-BN-ReLU) x 2, BN eps
1e-5) and a 3x3 segmentation head with bias.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm2d
from ..ops.quant import QConv
from ..ops.s2d import upsample_2x_nearest
from ..ops.sampling import resize_bilinear
from .efficientnet import EfficientNetEncoder, encoder_feature_channels

_NCHW = (2, 3)


class DecoderBlock(nn.Module):
    """2x upsample -> concat skip -> (conv-BN-ReLU) x 2."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 upsample_mode: str = "bilinear"):
        super().__init__()
        if upsample_mode not in ("bilinear", "nearest"):
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}")
        self.upsample_mode = upsample_mode
        self.conv0 = QConv(in_channels + skip_channels, features, 3, padding=1, bias=False)
        self.bn0 = BatchNorm2d(features)
        self.conv1 = QConv(features, features, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
        h, w = x.shape[2:]
        if self.upsample_mode == "nearest":
            x = upsample_2x_nearest(x, _NCHW)
        else:
            x = resize_bilinear(x, 2 * h, 2 * w, axes=_NCHW)
        if skip is not None:
            if x.shape[2:] != skip.shape[2:]:
                x = resize_bilinear(x, skip.shape[2], skip.shape[3], axes=_NCHW)
            x = torch.cat([x, skip], dim=1)
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


class PeopleSegmentationUNet(nn.Module):
    """EfficientNet-UNet: images in [0, 1] (B, 3, H, W) -> logits
    (B, classes, H, W); ImageNet normalisation inside."""

    def __init__(self, encoder_variant: str = "b0",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16), classes: int = 1,
                 normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406),
                 normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225),
                 upsample_mode: str = "bilinear"):
        super().__init__()
        self.normalize_mean = tuple(normalize_mean)
        self.normalize_std = tuple(normalize_std)
        self.encoder = EfficientNetEncoder(encoder_variant)
        taps = encoder_feature_channels(encoder_variant)
        skips = list(taps[:-1])[::-1]  # s16, s8, s4, s2
        ch = taps[-1]
        self.n_decoders = len(decoder_channels)
        for i, out_ch in enumerate(decoder_channels):
            skip_ch = skips[i] if i < len(skips) else 0
            self.add_module(f"decoder{i}", DecoderBlock(ch, skip_ch, out_ch, upsample_mode))
            ch = out_ch
        self.seg_head = nn.Conv2d(ch, classes, 3, padding=1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.normalize_mean, dtype=images.dtype, device=images.device)
        std = torch.tensor(self.normalize_std, dtype=images.dtype, device=images.device)
        x = (images - mean[:, None, None]) / std[:, None, None]
        feats = self.encoder(x)
        skips = list(feats[:-1])[::-1]
        h = feats[-1]
        for i in range(self.n_decoders):
            skip = skips[i] if i < len(skips) else None
            h = getattr(self, f"decoder{i}")(h, skip)
        return self.seg_head(h)


class PeopleSegUNetWrapper(nn.Module):
    """1ch -> 2ch linear map initialised to [+x, -x] (a real 1x1 conv, so
    perturbed checkpoints stay loadable). ``softmax(...)[:, 0]`` is the
    deployed binary mask."""

    def __init__(self):
        super().__init__()
        self.output_conv = nn.Conv2d(1, 2, 1)
        with torch.no_grad():
            self.output_conv.weight.copy_(torch.tensor([1.0, -1.0]).reshape(2, 1, 1, 1))
            self.output_conv.bias.zero_()

    def forward(self, x1: torch.Tensor) -> torch.Tensor:
        return self.output_conv(x1)
