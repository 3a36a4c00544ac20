"""Full-image people-segmentation UNet, stage 1 (NCHW, plain form).

Counterpart of the JAX package's ``models/unet.py`` without the phase-form
serving rewrites (``fused_tail``, ``encoder_s2d_front``, ``n4_tail``):
ImageNet normalisation, the EfficientNet encoder, five smp decoder stages
(2x upsample, skip concat, (conv3x3-BN-ReLU) x 2, BN eps 1e-5) and a 3x3
segmentation head with bias.

``pallas_tail=True`` (the JAX flag's name) computes the last decoder stage
and the seg head as one fused unit, ``ops/cuda_tail.tail``: a hand-written
CUDA kernel on a CUDA tensor, its plain version on the CPU. The parameters
are the same by name, so checkpoints swap between the two forms.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_tail
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
                 upsample_mode: str = "bilinear", pallas_tail: bool = False):
        super().__init__()
        self.classes = classes
        self.upsample_mode = upsample_mode
        self.pallas_tail = pallas_tail
        self.tail_use_kernel = True  # False: the fused tail's plain version on any device
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

    def _tail_active(self, last_skip: Optional[torch.Tensor]) -> bool:
        """Whether the fused tail replaces the last stage: what is semantic
        of the JAX gate (eval mode, bilinear upsample, a skip-free last
        stage, one class), without its TPU tiling conditions."""
        if not (self.pallas_tail and not self.training and self.upsample_mode == "bilinear"
                and last_skip is None and self.classes == 1):
            return False
        last = getattr(self, f"decoder{self.n_decoders - 1}")
        if last.conv0.calib_amax is not None:
            return False  # a calibration pass records the unfused convs' inputs
        if last.conv0.runs_int8 or last.conv1.runs_int8:
            raise NotImplementedError(
                "pallas_tail with int8 serving needs the s8 fused tail "
                "(the JAX package's ops/pallas_tail_q.py::tail_with_borders_q), which is not "
                "ported yet; serve pallas_tail in float32/bfloat16 or int8 without it")
        return True

    def _fused_tail(self, h: torch.Tensor) -> torch.Tensor:
        """Decoder output (B, Ci, h, w) -> dense logits (B, 2h, 2w)."""
        last = getattr(self, f"decoder{self.n_decoders - 1}")

        def hwio(conv):
            return conv.weight.permute(2, 3, 1, 0)

        def bn(m):
            return (m.weight, m.bias, m.running_mean, m.running_var)

        fn = cuda_tail.tail if self.tail_use_kernel else cuda_tail.tail_plain
        return fn(h.permute(0, 2, 3, 1), hwio(last.conv0), bn(last.bn0), hwio(last.conv1),
                  bn(last.bn1), hwio(self.seg_head), self.seg_head.bias)

    def forward(self, images: torch.Tensor, raw: bool = False):
        """Logits (B, classes, H, W). With ``raw=True`` returns ``(form,
        tensor)``: ``("dense", (B, H, W))`` when the fused tail ran (the
        one-class logit map without a channel axis), else ``("plain",
        (B, classes, H, W))``."""
        mean = torch.tensor(self.normalize_mean, dtype=images.dtype, device=images.device)
        std = torch.tensor(self.normalize_std, dtype=images.dtype, device=images.device)
        x = (images - mean[:, None, None]) / std[:, None, None]
        feats = self.encoder(x)
        skips = list(feats[:-1])[::-1]
        h = feats[-1]
        for i in range(self.n_decoders):
            skip = skips[i] if i < len(skips) else None
            if i == self.n_decoders - 1 and self._tail_active(skip):
                y = self._fused_tail(h)
                return ("dense", y) if raw else y[:, None]
            h = getattr(self, f"decoder{i}")(h, skip)
        y = self.seg_head(h)
        return ("plain", y) if raw else y


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
