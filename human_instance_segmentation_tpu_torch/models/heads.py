"""Hierarchical ROI segmentation heads, stage 2 (NCHW).

Counterpart of the JAX package's ``models/heads.py``: ``EnhancedUNet``,
``HierarchicalHeadV2`` with its unfused mask branch, ``ContourBranch``,
``DistanceTransformDecoder`` and ``RefinedHierarchicalHead`` with the
contour and distance branches. Heads return ``(final_logits, aux)`` with
NCHW tensors; the assembly turns them into the JAX package's NHWC.
``HierarchicalHeadV2`` drops whole channels (:class:`.blocks.Dropout2d`)
where the JAX head does (heads.py:198-252): after ``shared_in`` and
``shared_res0`` (``shared_drop0/1``), after ``gate0`` at half the rate
(``gate_drop``), and around the ``tnt`` upsample (``tnt_drop0/1``); in eval
mode these are the identity, and they hold no parameters.

The 1x1/3x3 convs the JAX package builds as ``QConv`` are
:class:`..ops.quant.QConv` here too, and the producer-side int8
quantization points (``prequantize_for``) sit where the JAX heads put them
(heads.py:96, :107, :117, :123, :230-233).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..ops.activations import get_activation
from ..ops.norms import get_normalization
from ..ops.quant import QConv
from ..ops.sampling import resize_bilinear
from .blocks import (ConvNormAct, ConvTranspose2x, Dropout2d, ResidualBlock, max_pool_2x,
                     prequantize_for)

_NCHW = (2, 3)


def _resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if tuple(x.shape[2:]) == (h, w):
        return x
    return resize_bilinear(x, h, w, axes=_NCHW)


class EnhancedUNet(nn.Module):
    """Depth-N UNet with two residual blocks per level and a sigmoid
    attention bottleneck; 2-class (bg/fg) logits."""

    def __init__(self, in_channels: int, base_channels: int = 96, depth: int = 3,
                 norm: str = "layernorm2d", activation: str = "relu"):
        super().__init__()
        kw = dict(norm=norm, activation=activation)
        chans = [base_channels * (2 ** i) for i in range(depth)]
        self.depth = depth
        for i in range(depth):
            if i == 0:
                self.enc0_in = ConvNormAct(in_channels, chans[0], **kw)
                self.enc0_res0 = ResidualBlock(chans[0], **kw)
                self.enc0_res1 = ResidualBlock(chans[0], **kw)
            else:
                self.add_module(f"enc{i}_res0", ResidualBlock(chans[i - 1], **kw))
                self.add_module(f"enc{i}_res1", ResidualBlock(chans[i - 1], **kw))
                self.add_module(f"enc{i}_out", ConvNormAct(chans[i - 1], chans[i], **kw))
        self.bott_res0 = ResidualBlock(chans[-1], **kw)
        self.bott_res1 = ResidualBlock(chans[-1], **kw)
        self.bott_cna = ConvNormAct(chans[-1], chans[-1], **kw)
        self.bott_att = QConv(chans[-1], chans[-1], 1)
        self.bott_conv = QConv(chans[-1], chans[-1], 3, padding=1)
        for d, i in enumerate(range(depth - 1, 0, -1)):
            self.add_module(f"up{d}", ConvTranspose2x(chans[i], chans[i - 1]))
            self.add_module(f"dec{d}_in", ConvNormAct(2 * chans[i - 1], chans[i - 1], **kw))
            self.add_module(f"dec{d}_res0", ResidualBlock(chans[i - 1], **kw))
            self.add_module(f"dec{d}_res1", ResidualBlock(chans[i - 1], **kw))
        self.final_cna = ConvNormAct(chans[0], chans[0] // 2, **kw)
        self.final_out = QConv(chans[0] // 2, 2, 1)

    def _run(self, x: torch.Tensor, *names: str) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.depth):
            if i == 0:
                x = self._run(x, "enc0_in", "enc0_res0", "enc0_res1")
            else:
                x = self._run(x, f"enc{i}_res0", f"enc{i}_res1")
                cna = getattr(self, f"enc{i}_out")
                x = cna(prequantize_for(cna.conv, x))
            skips.append(x)
            if i < self.depth - 1:
                x = max_pool_2x(x)
        a = self._run(x, "bott_res0", "bott_res1", "bott_cna")
        a = torch.sigmoid(self.bott_att(prequantize_for(self.bott_att, a, k=1)))
        x = self.bott_conv(x) * a
        for d, i in enumerate(range(self.depth - 1, 0, -1)):
            skip = skips[i - 1]
            x = _resize_to(getattr(self, f"up{d}")(x), skip.shape[2], skip.shape[3])
            x = torch.cat([x, skip], dim=1)
            cna = getattr(self, f"dec{d}_in")
            x = self._run(cna(prequantize_for(cna.conv, x)), f"dec{d}_res0", f"dec{d}_res1")
        x = self.final_cna(x)
        return self.final_out(prequantize_for(self.final_out, x, k=1))


class HierarchicalHeadV2(nn.Module):
    """Shared trunk -> (a) EnhancedUNet bg/fg logits, 2x deconv to the mask
    size; (b) an fg gate from the low-res bg/fg logits on the shared
    features for the target/non-target branch. Combine:
        final[0] = bgfg[0]
        final[1] = bgfg[1] + tnt[0] * P(fg)
        final[2] = bgfg[1] + tnt[1] * P(fg)
    """

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), norm: str = "layernorm2d",
                 activation: str = "relu", base_channels: int = 96, depth: int = 3,
                 dropout_rate: float = 0.1):
        super().__init__()
        kw = dict(norm=norm, activation=activation)
        mc = mid_channels
        self.mask_size = tuple(mask_size)
        self.act = get_activation(activation)
        self.shared_in = ConvNormAct(in_channels, mc, **kw)
        self.shared_drop0 = Dropout2d(dropout_rate)
        self.shared_res0 = ResidualBlock(mc, **kw)
        self.shared_drop1 = Dropout2d(dropout_rate)
        self.shared_res1 = ResidualBlock(mc, **kw)
        self.bg_vs_fg_unet = EnhancedUNet(mc, base_channels, depth, **kw)
        self.upsample_deconv = ConvTranspose2x(2, 32)
        self.upsample_norm = get_normalization(norm, 32)
        self.upsample_out = QConv(32, 2, 1)
        self.gate0 = QConv(2, mc // 4, 1)
        self.gate_drop = Dropout2d(dropout_rate * 0.5)
        self.gate1 = QConv(mc // 4, mc // 2, 1)
        self.gate2 = QConv(mc // 2, mc, 1)
        self.tnt_res0 = ResidualBlock(mc, **kw)
        self.tnt_drop0 = Dropout2d(dropout_rate)
        self.tnt_deconv = ConvTranspose2x(mc, mc // 2)
        self.tnt_norm = get_normalization(norm, mc // 2)
        self.tnt_drop1 = Dropout2d(dropout_rate)
        self.tnt_res1 = ResidualBlock(mc // 2, **kw)
        self.tnt_out = QConv(mc // 2, 2, 1)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        act = self.act
        mh, mw = self.mask_size
        shared = self.shared_drop0(self.shared_in(features))
        shared = self.shared_res1(self.shared_drop1(self.shared_res0(shared)))

        bg_fg_low = self.bg_vs_fg_unet(shared)
        up = act(self.upsample_norm(self.upsample_deconv(bg_fg_low)))
        bg_fg_logits = _resize_to(self.upsample_out(up), mh, mw)
        bg_fg_probs = torch.softmax(bg_fg_logits, dim=1)

        g = self.gate_drop(act(self.gate0(bg_fg_low)))
        g = act(self.gate1(prequantize_for(self.gate1, g, k=1)))
        fg_attention = torch.sigmoid(self.gate2(prequantize_for(self.gate2, g, k=1)))

        t = self.tnt_drop0(self.tnt_res0(shared * fg_attention))
        t = act(self.tnt_norm(self.tnt_deconv(t)))
        t = self.tnt_res1(self.tnt_drop1(t))
        tnt_logits = _resize_to(self.tnt_out(t), mh, mw)

        fg_p = bg_fg_probs[:, 1:2]
        final = torch.cat([
            bg_fg_logits[:, 0:1],
            bg_fg_logits[:, 1:2] + tnt_logits[:, 0:1] * fg_p,
            bg_fg_logits[:, 1:2] + tnt_logits[:, 1:2] * fg_p,
        ], dim=1)
        aux = {
            "bg_fg_logits": bg_fg_logits,
            "bg_fg_logits_low": bg_fg_low,
            "target_nontarget_logits": tnt_logits,
            "fg_attention": fg_attention,
            "shared_features": shared,
        }
        return final, aux


class ContourBranch(nn.Module):
    """Single-channel sigmoid contour map."""

    def __init__(self, in_channels: int, contour_channels: int = 64,
                 norm: str = "layernorm2d", activation: str = "relu"):
        super().__init__()
        kw = dict(norm=norm, activation=activation)
        self.c0 = ConvNormAct(in_channels, contour_channels, **kw)
        self.c1 = ConvNormAct(contour_channels, contour_channels, **kw)
        self.out = QConv(contour_channels, 1, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.out(self.c1(self.c0(features))))


class DistanceTransformDecoder(nn.Module):
    """Distance-map regression with a learned sharp-sigmoid threshold."""

    def __init__(self, in_channels: int, distance_channels: int = 128,
                 norm: str = "layernorm2d", activation: str = "relu"):
        super().__init__()
        kw = dict(norm=norm, activation=activation)
        self.d0 = ConvNormAct(in_channels, distance_channels, **kw)
        self.d_res = ResidualBlock(distance_channels, **kw)
        self.out = QConv(distance_channels, 1, 1)
        self.threshold = nn.Parameter(torch.tensor(0.3))

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        distance_map = self.out(self.d_res(self.d0(features)))
        mask = torch.sigmoid((distance_map - self.threshold) * 10.0)
        return mask, distance_map


class RefinedHierarchicalHead(nn.Module):
    """HierarchicalHeadV2 plus the contour and distance branches (the
    flagship's refinement set; the JAX package's attention module and
    boundary, progressive and sub-pixel refinements are not ported yet)."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), use_contour_detection: bool = False,
                 use_distance_transform: bool = False, norm: str = "layernorm2d",
                 activation: str = "relu", base_channels: int = 96, depth: int = 3):
        super().__init__()
        kw = dict(norm=norm, activation=activation)
        self.mask_size = tuple(mask_size)
        self.base_head = HierarchicalHeadV2(
            in_channels, mid_channels, mask_size, base_channels=base_channels, depth=depth,
            **kw)
        self.contour = ContourBranch(mid_channels, **kw) if use_contour_detection else None
        self.distance = (DistanceTransformDecoder(mid_channels, **kw)
                         if use_distance_transform else None)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mh, mw = self.mask_size
        logits, aux = self.base_head(features)
        shared = aux["shared_features"]
        if self.contour is not None:
            aux["contours"] = _resize_to(self.contour(shared), mh, mw)
        if self.distance is not None:
            dmask, dmap = self.distance(shared)
            aux["distance_mask"] = _resize_to(dmask, mh, mw)
            aux["distance_map"] = _resize_to(dmap, mh, mw)
        return logits, aux
