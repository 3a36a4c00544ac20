"""Experimental model families: cascade, class-specific decoder, auxiliary
fg/bg multi-task.

Counterpart of the JAX package's ``models/extras.py``. The modules run
NCHW (features (N, C, h, w) in, logits (N, classes, h, w) out); the two
losses take NHWC logits, as every loss of the package does.

- :class:`CascadeSegmentationHead`: coarse decode ->
  :class:`CascadeBoundaryRefinement` -> :class:`InstanceSeparationModule`
  (dilated 3x3 context at dilations 2 and 4 after a 5x5 conv), with
  :func:`cascade_loss`, stage-weighted CE + Dice;
- :class:`ClassSpecificDecoder`: one pathway per class and a 1x1
  cross-class interaction;
- :class:`AuxiliaryFgBgHead`: a binary fg/bg logit, with
  :func:`multi_task_loss`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..losses.segmentation import cross_entropy, dice_loss
from ..ops.norms import get_normalization
from ..ops.sampling import resize_bilinear
from .blocks import ConvNormAct, ResidualBlock


class CascadeBoundaryRefinement(nn.Module):
    """Stage 2: a residual refinement of the coarse logits over [features,
    softmax(coarse)]."""

    def __init__(self, in_channels: int, feature_channels: int = 128, num_classes: int = 3,
                 norm: str = "layernorm2d", norm_groups: int = 8):
        super().__init__()
        kw = dict(norm=norm, norm_groups=norm_groups)
        fc = feature_channels
        self.edge0 = ConvNormAct(in_channels + num_classes, fc, **kw)
        self.edge1 = ConvNormAct(fc, fc, **kw)
        self.ref0 = ResidualBlock(fc, **kw)
        self.ref1 = ResidualBlock(fc, **kw)
        self.out = nn.Conv2d(fc, num_classes, 1)

    def forward(self, features: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        x = torch.cat([features, torch.softmax(coarse, dim=1)], dim=1)
        x = self.ref1(self.ref0(self.edge1(self.edge0(x))))
        return coarse + self.out(x)


class InstanceSeparationModule(nn.Module):
    """Stage 3: a residual instance separation over [features,
    softmax(refined)] with dilated context."""

    def __init__(self, in_channels: int, feature_channels: int = 128, num_classes: int = 3,
                 norm: str = "layernorm2d", norm_groups: int = 8):
        super().__init__()
        fc = feature_channels
        self.inst_conv = nn.Conv2d(in_channels + num_classes, fc, 5, padding=2)
        self.inst_norm = get_normalization(norm, fc, norm_groups)
        self.ctx1 = nn.Conv2d(fc, fc, 3, padding=2, dilation=2)
        self.ctx1_norm = get_normalization(norm, fc, norm_groups)
        self.ctx2 = nn.Conv2d(fc, fc, 3, padding=4, dilation=4)
        self.ctx2_norm = get_normalization(norm, fc, norm_groups)
        self.sep0 = ResidualBlock(fc, norm=norm, norm_groups=norm_groups)
        self.sep1 = ResidualBlock(fc, norm=norm, norm_groups=norm_groups)
        self.out = nn.Conv2d(fc, num_classes, 1)

    def forward(self, features: torch.Tensor, refined: torch.Tensor) -> torch.Tensor:
        x = torch.cat([features, torch.softmax(refined, dim=1)], dim=1)
        x = F.relu(self.inst_norm(self.inst_conv(x)))
        c1 = F.relu(self.ctx1_norm(self.ctx1(x)))
        c2 = F.relu(self.ctx2_norm(self.ctx2(c1)))
        return refined + self.out(self.sep1(self.sep0(c2)))


class CascadeSegmentationHead(nn.Module):
    """Coarse decode -> boundary refinement -> instance separation;
    ``forward -> (separated, {"stage_outputs": (coarse, refined,
    separated)})``."""

    def __init__(self, in_channels: int, mid_channels: int = 256, num_classes: int = 3,
                 norm: str = "layernorm2d", norm_groups: int = 8):
        super().__init__()
        kw = dict(norm=norm, norm_groups=norm_groups)
        self.coarse_in = ConvNormAct(in_channels, mid_channels, **kw)
        self.coarse_res = ResidualBlock(mid_channels, **kw)
        self.coarse_out = nn.Conv2d(mid_channels, num_classes, 1)
        self.boundary = CascadeBoundaryRefinement(mid_channels, num_classes=num_classes, **kw)
        self.separation = InstanceSeparationModule(mid_channels, num_classes=num_classes, **kw)

    def forward(self, roi_features: torch.Tensor):
        x = self.coarse_res(self.coarse_in(roi_features))
        coarse = self.coarse_out(x)
        refined = self.boundary(x, coarse)
        separated = self.separation(x, refined)
        return separated, {"stage_outputs": (coarse, refined, separated)}


def cascade_loss(
    stage_outputs: Sequence[torch.Tensor],
    targets: torch.Tensor,
    stage_weights: Sequence[float] = (0.3, 0.3, 0.4),
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-weighted CE + target-class Dice over NHWC stage logits
    (N, H, W, C) and (N, H, W) labels; metrics ``stage{i}_loss`` and
    ``total_loss``."""
    total = 0.0
    metrics = {}
    for i, (out, w) in enumerate(zip(stage_outputs, stage_weights)):
        stage = (cross_entropy(out, targets, valid=valid)
                 + dice_loss(out, targets, class_indices=(1,), valid=valid))
        metrics[f"stage{i}_loss"] = stage
        total = total + w * stage
    metrics["total_loss"] = total
    return total, metrics


class ClassSpecificDecoder(nn.Module):
    """Per-class pathways (3x3 unit, residual block, 1x1 to one channel),
    stacked, plus a 1x1 cross-class interaction."""

    def __init__(self, in_channels: int, mid_channels: int = 128, num_classes: int = 3,
                 norm: str = "layernorm2d", norm_groups: int = 8):
        super().__init__()
        kw = dict(norm=norm, norm_groups=norm_groups)
        self.num_classes = num_classes
        for c in range(num_classes):
            self.add_module(f"class{c}_in", ConvNormAct(in_channels, mid_channels, **kw))
            self.add_module(f"class{c}_res", ResidualBlock(mid_channels, **kw))
            self.add_module(f"class{c}_out", nn.Conv2d(mid_channels, 1, 1))
        self.cross_class = nn.Conv2d(num_classes, num_classes, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        outs = []
        for c in range(self.num_classes):
            x = getattr(self, f"class{c}_res")(getattr(self, f"class{c}_in")(features))
            outs.append(getattr(self, f"class{c}_out")(x))
        stacked = torch.cat(outs, dim=1)
        return stacked + self.cross_class(stacked)


class AuxiliaryFgBgHead(nn.Module):
    """Two 3x3 units and a 1x1 to one binary fg/bg logit."""

    def __init__(self, in_channels: int, mid_channels: int = 128, norm: str = "layernorm2d",
                 norm_groups: int = 8):
        super().__init__()
        kw = dict(norm=norm, norm_groups=norm_groups)
        self.c0 = ConvNormAct(in_channels, mid_channels, **kw)
        self.c1 = ConvNormAct(mid_channels, mid_channels // 2, **kw)
        self.out = nn.Conv2d(mid_channels // 2, 1, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.out(self.c1(self.c0(features)))


def multi_task_loss(
    main_loss: torch.Tensor,
    aux_logits: torch.Tensor,
    targets: torch.Tensor,
    aux_weight: float = 0.3,
    pos_weight: Optional[float] = None,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``main_loss + aux_weight *`` the weighted BCE of the NHWC aux logits
    (N, h, w, 1) against the foreground (labels > 0) of ``targets``
    (N, H, W), pooled to (h, w) by a bilinear resize and thresholded at 0.5
    where the sizes differ."""
    fg = (targets > 0).to(aux_logits.dtype)[..., None]
    if fg.shape[1:3] != aux_logits.shape[1:3]:
        fg = resize_bilinear(fg, aux_logits.shape[1], aux_logits.shape[2])
        fg = (fg > 0.5).to(aux_logits.dtype)
    pw = 1.0 if pos_weight is None else pos_weight
    bce = -(pw * fg * F.logsigmoid(aux_logits) + (1.0 - fg) * F.logsigmoid(-aux_logits))
    if valid is not None:
        vw = valid.to(bce.dtype)[:, None, None, None]
        aux = torch.sum(bce * vw) / torch.clamp(torch.sum(vw * torch.ones_like(bce)), min=1.0)
    else:
        aux = torch.mean(bce)
    total = main_loss + aux_weight * aux
    return total, {"total_loss": total, "aux_fg_bg_loss": aux, "main_loss": main_loss}
