"""Distance-aware segmentation loss with a distance transform on the device.

Counterpart of the JAX package's ``losses/distance_aware.py``: boundary
distance weights from an iterated-erosion count (``ops.morphology``), an
extra weight where target and non-target instances meet, and a weighted
CE + Dice. NHWC like the JAX functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.morphology import dilate, erode
from .segmentation import cross_entropy, dice_loss


def approximate_distance_transform(mask: torch.Tensor, max_distance: int = 10) -> torch.Tensor:
    """Distance of each foreground pixel to the mask boundary, counted in
    erosions. mask: (N, H, W, 1) binary {0, 1}; distances saturate at
    ``max_distance``."""
    d = torch.zeros_like(mask)
    cur = mask
    for _ in range(max_distance):
        d = d + cur
        cur = erode(cur, 1)
    return d


def boundary_distance_weights(
    targets: torch.Tensor,
    num_classes: int = 3,
    boundary_weight: float = 3.0,
    decay: float = 0.5,
    max_distance: int = 8,
) -> torch.Tensor:
    """Per-pixel weights that decay exponentially with distance from any
    class boundary: w = 1 + (boundary_weight - 1) * exp(-decay * dist)."""
    onehot = F.one_hot(targets.long(), num_classes).to(torch.float32)
    band = torch.zeros(targets.shape + (1,), dtype=torch.float32, device=targets.device)
    for c in range(num_classes):
        m = onehot[..., c:c + 1]
        band = torch.maximum(band, dilate(m, 1) - erode(m, 1))
    dist_to_boundary = approximate_distance_transform(1.0 - band, max_distance)
    w = 1.0 + (boundary_weight - 1.0) * torch.exp(-decay * dist_to_boundary)
    return w[..., 0]


def instance_separation_weights(
    targets: torch.Tensor,
    separation_weight: float = 2.0,
    radius: int = 2,
) -> torch.Tensor:
    """Extra weight where target (1) and non-target (2) instances are within
    ``radius`` pixels of each other."""
    t = (targets == 1).to(torch.float32)[..., None]
    nt = (targets == 2).to(torch.float32)[..., None]
    near_both = dilate(t, radius) * dilate(nt, radius)
    return 1.0 + (separation_weight - 1.0) * near_both[..., 0]


@dataclass(frozen=True)
class DistanceAwareLossConfig:
    boundary_weight: float = 3.0
    separation_weight: float = 2.0
    decay: float = 0.5
    max_distance: int = 8
    dice_weight: float = 1.0
    ce_weight: float = 1.0


def distance_aware_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    cfg: DistanceAwareLossConfig = DistanceAwareLossConfig(),
    class_weights: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Distance-weighted CE + Dice."""
    w = boundary_distance_weights(
        targets, predictions.shape[-1], cfg.boundary_weight, cfg.decay, cfg.max_distance)
    w = w * instance_separation_weights(targets, cfg.separation_weight)
    if valid is not None:
        w = w * valid.to(w.dtype)[:, None, None]
    ce_map = cross_entropy(predictions, targets, class_weights=class_weights, reduction="none")
    ce = torch.sum(ce_map * w) / torch.clamp(torch.sum(w), min=1.0)
    dl = dice_loss(predictions, targets, class_indices=(1,), valid=valid)
    total = cfg.ce_weight * ce + cfg.dice_weight * dl
    return total, {"total_loss": total, "weighted_ce": ce, "dice_loss": dl}
