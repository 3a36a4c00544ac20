"""EfficientNet encoders (NCHW) with the five UNet feature taps.

Counterpart of the JAX package's ``models/efficientnet.py`` in its plain
form (no fused MBConv kernel, no space-to-depth front): MBConv + squeeze-
excite, SiLU, BatchNorm eps 1e-3, and TF ``'SAME'`` padding. At stride 2
SAME padding is asymmetric (480 -> 240 with k=3 pads (0, 1), with k=5
(1, 2)); a symmetric ``padding=k//2`` would shift every stride-2 output by
a pixel, so :class:`Conv2dSame` pads explicitly and convolves unpadded.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import BatchNorm2d
from ..ops.quant import QConv

# (expand_ratio, kernel, stride, out_channels, num_repeat) for B0
_B0_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

# (width_mult, depth_mult, default drop_rate)
VARIANTS = {
    "tiny": (0.25, 0.25, 0.0),  # test variant: 7 blocks, 8-ch stem
    "b0": (1.0, 1.0, 0.2),
    "b1": (1.0, 1.1, 0.2),
    "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3),
    "b4": (1.4, 1.8, 0.4),
    "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5),
    "b7": (2.0, 3.1, 0.5),
}

_BN_EPS = 1e-3


def round_channels(c: float, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Conv2d with TF/XLA 'SAME' padding (explicit, possibly asymmetric)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        top, bottom = _same_pads(x.shape[-2], kh, sh)
        left, right = _same_pads(x.shape[-1], kw, sw)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, squeeze_channels, 1)
        self.expand = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation (eval form).

    The SE squeeze width is ``int(in_ch * se_ratio)`` of the block input,
    not of the expanded width.
    """

    def __init__(self, in_channels: int, out_channels: int, expand_ratio: int, kernel: int,
                 stride: int, se_ratio: float = 0.25):
        super().__init__()
        mid = in_channels * expand_ratio
        self.residual = stride == 1 and in_channels == out_channels
        if expand_ratio != 1:
            self.expand_conv = QConv(in_channels, mid, 1, bias=False)
            self.bn0 = BatchNorm2d(mid, _BN_EPS)
        else:
            self.expand_conv = None
        self.dw_conv = Conv2dSame(mid, mid, kernel, stride=stride, groups=mid, bias=False)
        self.bn1 = BatchNorm2d(mid, _BN_EPS)
        self.se = (SqueezeExcite(mid, max(1, int(in_channels * se_ratio)))
                   if se_ratio > 0 else None)
        self.project_conv = QConv(mid, out_channels, 1, bias=False)
        self.bn2 = BatchNorm2d(out_channels, _BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = F.silu(self.bn0(self.expand_conv(h)))
        h = F.silu(self.bn1(self.dw_conv(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn2(self.project_conv(h))
        return h + x if self.residual else h


class EfficientNetEncoder(nn.Module):
    """EfficientNet backbone returning five maps: stem@s2, stage1@s4,
    stage2@s8, stage4@s16, stage6@s32 (the smp encoder contract)."""

    _TAP_AFTER = (1, 2, 4, 6)

    def __init__(self, variant: str = "b0", in_channels: int = 3):
        super().__init__()
        width, depth, _ = VARIANTS[variant]
        stem_ch = round_channels(32, width)
        self.stem_conv = Conv2dSame(in_channels, stem_ch, 3, stride=2, bias=False)
        self.stem_bn = BatchNorm2d(stem_ch, _BN_EPS)
        self.stages: List[List[str]] = []
        ch = stem_ch
        for stage_i, (e, k, s, c, r) in enumerate(_B0_STAGES):
            out_ch = round_channels(c, width)
            names = []
            for j in range(round_repeats(r, depth)):
                name = f"stage{stage_i}_block{j}"
                self.add_module(name, MBConv(ch, out_ch, e, k, s if j == 0 else 1))
                names.append(name)
                ch = out_ch
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = F.silu(self.stem_bn(self.stem_conv(x)))
        features = [h]
        for stage_i, names in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            if stage_i in self._TAP_AFTER:
                features.append(h)
        return tuple(features)


def encoder_feature_channels(variant: str) -> Tuple[int, ...]:
    """Channel counts of the five taps (s2, s4, s8, s16, s32)."""
    width, _, _ = VARIANTS[variant]
    chans = [round_channels(c, width) for (_, _, _, c, _) in _B0_STAGES]
    return (round_channels(32, width), chans[1], chans[2], chans[4], chans[6])
