"""Core segmentation losses: Dice, focal, weighted CE.

Counterpart of the JAX package's ``losses/segmentation.py``, on NHWC
logits like it. Every loss accepts an optional ``valid`` (N,) mask so
padded ROI buckets contribute zero.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _valid_weights(valid: Optional[torch.Tensor], n: int, like: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones((n,), dtype=like.dtype, device=like.device)
    return valid.to(like.dtype)


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Weighted softmax cross-entropy (torch ``F.cross_entropy`` semantics:
    with class weights, the mean is normalised by the summed weights).

    Args:
      logits: (N, H, W, C); targets: (N, H, W) int in [0, C).
    """
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights[targets.long()]
    else:
        w = torch.ones_like(nll)
    vw = _valid_weights(valid, logits.shape[0], nll)[:, None, None]
    w = w * vw
    if reduction == "none":
        return nll * w
    if reduction == "sum":
        return torch.sum(nll * w)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-8)


def dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    class_indices: Sequence[int] = (1, 2),
    smooth: float = 1e-6,
    apply_softmax: bool = True,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-class Dice: per-sample dice over (H, W), mean over samples, mean
    over the selected classes."""
    probs = torch.softmax(logits, dim=-1) if apply_softmax else logits
    onehot = F.one_hot(targets.long(), logits.shape[-1]).to(probs.dtype)
    vw = _valid_weights(valid, logits.shape[0], probs)
    losses = []
    for c in class_indices:
        p = probs[..., c]
        t = onehot[..., c]
        inter = torch.sum(p * t, dim=(1, 2))
        denom = torch.sum(p, dim=(1, 2)) + torch.sum(t, dim=(1, 2))
        dice = (2.0 * inter + smooth) / (denom + smooth)
        per_sample = 1.0 - dice
        losses.append(torch.sum(per_sample * vw) / torch.clamp(torch.sum(vw), min=1.0))
    return torch.mean(torch.stack(losses))


def focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 2.0,
    alpha: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Focal loss: ``(1 - pt)^gamma * ce``, optionally alpha-weighted by
    class."""
    ce = cross_entropy(logits, targets, reduction="none")
    pt = torch.exp(-ce)
    fl = (1.0 - pt) ** gamma * ce
    if alpha is not None:
        fl = alpha[targets.long()] * fl
    vw = _valid_weights(valid, logits.shape[0], fl)[:, None, None]
    return torch.sum(fl * vw) / torch.clamp(torch.sum(vw * torch.ones_like(fl)), min=1.0)


def segmentation_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    ce_weight: float = 1.0,
    dice_weight: float = 1.0,
    dice_classes: Sequence[int] = (1,),
    use_focal: bool = False,
    focal_gamma: float = 2.0,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted CE (or focal) + Dice."""
    if use_focal:
        ce = focal_loss(logits, targets, gamma=focal_gamma, alpha=class_weights, valid=valid)
    else:
        ce = cross_entropy(logits, targets, class_weights=class_weights, valid=valid)
    dl = dice_loss(logits, targets, class_indices=dice_classes, valid=valid)
    total = ce_weight * ce + dice_weight * dl
    return total, {"total_loss": total, "ce_loss": ce, "dice_loss": dl}


def class_weights_from_pixel_ratios(
    pixel_ratios: Dict[str, float], use_log_weights: bool = True
) -> Tuple[float, float, float]:
    """[bg, target, non_target] class weights from dataset pixel ratios:
    log-inverse (or plain inverse) frequency, normalised to sum to 3. A
    plain tuple of floats."""
    eps = 1e-3
    keys = ("background", "target", "non_target")
    if use_log_weights:
        w = [math.log(1.0 / (pixel_ratios[k] + eps)) for k in keys]
    else:
        w = [1.0 / (pixel_ratios[k] + eps) for k in keys]
    s = sum(w)
    return tuple(v / s * 3.0 for v in w)
