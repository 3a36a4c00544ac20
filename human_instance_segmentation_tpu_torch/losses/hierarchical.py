"""Hierarchical and refined hierarchical losses with explicit EMA state.

Counterpart of the JAX package's ``losses/hierarchical.py``. The dynamic
class-balance weights are an EMA kept in :class:`HierarchicalLossState`
(tensors on the device), handed in and returned by every call, so the loss
and its state update need no host sync. NHWC like the JAX functions; each
``clip(..., None, 10.0)`` of the refinement terms is kept where it stands.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.morphology import max_pool2d
from .distance_aware import DistanceAwareLossConfig, distance_aware_loss
from .segmentation import cross_entropy, dice_loss, focal_loss


@dataclass
class HierarchicalLossState:
    """The EMA of the dynamic class-balance weights: float32 scalars and the
    ``initialized`` flag (a bool scalar), all on the loss's device."""

    ema_bg: torch.Tensor
    ema_fg: torch.Tensor
    ema_target: torch.Tensor
    ema_nontarget: torch.Tensor
    initialized: torch.Tensor

    @classmethod
    def create(cls, device="cpu") -> "HierarchicalLossState":
        def one():
            return torch.ones((), dtype=torch.float32, device=device)

        return cls(ema_bg=one(), ema_fg=one(), ema_target=one(), ema_nontarget=one(),
                   initialized=torch.zeros((), dtype=torch.bool, device=device))

    FIELDS = ("ema_bg", "ema_fg", "ema_target", "ema_nontarget", "initialized")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.FIELDS}

    @classmethod
    def from_state_dict(cls, d: Dict[str, torch.Tensor], device=None) -> "HierarchicalLossState":
        return cls(**{k: torch.as_tensor(d[k]).to(device) if device is not None
                      else torch.as_tensor(d[k]) for k in cls.FIELDS})


@dataclass(frozen=True)
class HierarchicalLossConfig:
    bg_weight: float = 1.0
    fg_weight: float = 1.0
    target_weight: float = 1.0
    consistency_weight: float = 0.1
    use_dynamic_weights: bool = True
    dice_weight: float = 1.0
    ce_weight: float = 1.0
    ema_alpha: float = 0.9
    use_focal: bool = False
    focal_gamma: float = 2.0
    # [bg, target, non_target] weights of the final 3-class term
    final_class_weights: Optional[Tuple[float, float, float]] = None


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def hierarchical_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    aux: Dict[str, torch.Tensor],
    state: HierarchicalLossState,
    cfg: HierarchicalLossConfig = HierarchicalLossConfig(),
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, HierarchicalLossState, Dict[str, torch.Tensor]]:
    """The four-term hierarchical loss.

    Args:
      predictions: (N, H, W, 3) final logits.
      targets: (N, H, W) int labels {0 bg, 1 target, 2 non-target}.
      aux: needs ``bg_fg_logits`` (N, H, W, 2) and
        ``target_nontarget_logits`` (N, H, W, 2).
      valid: optional (N,) validity mask for padded ROI buckets.
    Returns: (total_loss, new_state, metrics).
    """
    f32 = predictions.dtype
    dev = predictions.device
    vw = (torch.ones((targets.shape[0],), dtype=f32, device=dev) if valid is None
          else valid.to(f32))
    pix_w = vw[:, None, None]

    bg_mask = (targets == 0).to(f32) * pix_w
    fg_mask = (targets > 0).to(f32) * pix_w
    target_mask = (targets == 1).to(f32) * pix_w
    nontarget_mask = (targets == 2).to(f32) * pix_w
    bg_fg_targets = (targets > 0).long()

    # dynamic bg/fg class weights with the EMA on the device
    if cfg.use_dynamic_weights:
        bg_count = torch.sum(bg_mask)
        fg_count = torch.sum(fg_mask)
        total = bg_count + fg_count
        bg_w = torch.clamp(total / (2.0 * torch.clamp(bg_count, min=1.0)), 0.5, 3.0)
        fg_w = torch.clamp(
            total / (2.0 * torch.clamp(fg_count, min=1.0)) * cfg.target_weight, 0.5, 3.0)
        a = cfg.ema_alpha
        ema_bg = torch.where(state.initialized, a * state.ema_bg + (1 - a) * bg_w, bg_w)
        ema_fg = torch.where(state.initialized, a * state.ema_fg + (1 - a) * fg_w, fg_w)
        bgfg_weights = torch.stack([ema_bg, ema_fg])
    else:
        ema_bg, ema_fg = _scalar(1.0, predictions), _scalar(cfg.target_weight, predictions)
        bgfg_weights = torch.stack([ema_bg, ema_fg])

    bg_fg_loss = cross_entropy(
        aux["bg_fg_logits"], bg_fg_targets, class_weights=bgfg_weights, valid=valid)

    # target vs non-target on foreground pixels
    tn_targets = (targets == 2).long()
    t_count = torch.sum(target_mask)
    nt_count = torch.sum(nontarget_mask)
    fg_total = t_count + nt_count
    if cfg.use_dynamic_weights:
        t_w = torch.clamp(fg_total / (2.0 * torch.clamp(t_count, min=1.0)), 0.5, 3.0)
        nt_w = torch.clamp(fg_total / (2.0 * torch.clamp(nt_count, min=1.0)), 0.5, 3.0)
        a = cfg.ema_alpha
        ema_t = torch.where(state.initialized, a * state.ema_target + (1 - a) * t_w, t_w)
        ema_nt = torch.where(state.initialized, a * state.ema_nontarget + (1 - a) * nt_w, nt_w)
        tn_weights = torch.stack([ema_t, ema_nt])
    else:
        ema_t = _scalar(1.0, predictions)
        ema_nt = _scalar(1.0, predictions)
        tn_weights = torch.ones((2,), dtype=f32, device=dev)

    tn_ce = cross_entropy(
        aux["target_nontarget_logits"], tn_targets, class_weights=tn_weights, reduction="none")
    target_nontarget_loss = torch.sum(tn_ce * fg_mask) / torch.clamp(torch.sum(fg_mask), min=1.0)
    target_nontarget_loss = torch.where(fg_total > 0, target_nontarget_loss,
                                        torch.zeros_like(target_nontarget_loss))

    # final 3-class CE (or focal) + consistency + Dice(target)
    fcw = (torch.tensor(cfg.final_class_weights, dtype=f32, device=dev)
           if cfg.final_class_weights is not None else None)
    if cfg.use_focal:
        final_loss = focal_loss(predictions, targets, gamma=cfg.focal_gamma, alpha=fcw,
                                valid=valid)
    else:
        final_loss = cross_entropy(predictions, targets, class_weights=fcw, valid=valid)

    bg_fg_probs = torch.softmax(aux["bg_fg_logits"], dim=-1)
    final_probs = torch.softmax(predictions, dim=-1)
    fg_from_final = final_probs[..., 1] + final_probs[..., 2]
    fg_from_branch = bg_fg_probs[..., 1]
    sq = (fg_from_branch - fg_from_final) ** 2 * pix_w
    consistency_loss = torch.sum(sq) / torch.clamp(torch.sum(pix_w * torch.ones_like(sq)),
                                                   min=1.0)

    dice = dice_loss(predictions, targets, class_indices=(1,), valid=valid)

    total = (cfg.bg_weight * bg_fg_loss
             + cfg.fg_weight * target_nontarget_loss
             + cfg.ce_weight * final_loss
             + cfg.dice_weight * dice
             + cfg.consistency_weight * consistency_loss)

    # aux metrics
    with torch.no_grad():
        bg_fg_preds = torch.argmax(aux["bg_fg_logits"], dim=-1)
        correct = (bg_fg_preds == bg_fg_targets).to(f32) * pix_w
        aux_fg_accuracy = torch.sum(correct) / torch.clamp(
            torch.sum(pix_w * torch.ones_like(correct)), min=1.0)
        fg_pred = (bg_fg_preds == 1).to(f32) * pix_w
        fg_true = bg_fg_targets.to(f32) * pix_w
        inter = torch.sum(fg_pred * fg_true)
        union = torch.sum(torch.clamp(fg_pred + fg_true, max=1.0))
        aux_fg_iou = inter / torch.clamp(union, min=1.0)

    if cfg.use_dynamic_weights:
        new_state = HierarchicalLossState(
            ema_bg=ema_bg.detach(), ema_fg=ema_fg.detach(), ema_target=ema_t.detach(),
            ema_nontarget=ema_nt.detach(),
            initialized=torch.ones((), dtype=torch.bool, device=dev))
    else:
        new_state = state

    metrics = {
        "bg_fg_loss": bg_fg_loss,
        "target_nontarget_loss": target_nontarget_loss,
        "final_loss": final_loss,
        "consistency_loss": consistency_loss,
        "ce_loss": final_loss,
        "dice_loss": dice,
        "total_loss": total,
        "aux_fg_bg_loss": bg_fg_loss,
        "aux_fg_accuracy": aux_fg_accuracy,
        "aux_fg_iou": aux_fg_iou,
        "bg_weight": ema_bg,
        "fg_weight": ema_fg,
        "target_weight": ema_t,
        "nontarget_weight": ema_nt,
    }
    return total, new_state, metrics


# ---------------------------------------------------------------------------
# Refinement terms
# ---------------------------------------------------------------------------


def active_contour_loss(probs: torch.Tensor, smoothness_weight: float = 0.01) -> torch.Tensor:
    """Boundary length + curvature of the target-class probability. probs:
    (N, H, W, C) after the softmax."""
    p = probs[..., 1:2] if probs.shape[-1] > 1 else probs
    dy = p[:, 1:, :, :] - p[:, :-1, :, :]
    dx = p[:, :, 1:, :] - p[:, :, :-1, :]
    boundary = (torch.mean(torch.clamp(torch.abs(dy), max=10.0))
                + torch.mean(torch.clamp(torch.abs(dx), max=10.0)))
    curvature = 0.0
    if dy.shape[1] > 1:
        curvature += torch.mean(torch.abs(dy[:, 1:, :, :] - dy[:, :-1, :, :]))
    if dx.shape[2] > 1:
        curvature += torch.mean(torch.abs(dx[:, :, 1:, :] - dx[:, :, :-1, :]))
    return boundary + smoothness_weight * curvature


def boundary_aware_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    boundary_width: int = 3,
    boundary_weight: float = 5.0,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CE up-weighted in a morphological boundary band: band = dilate(onehot)
    - erode(onehot), both by max pooling."""
    onehot = F.one_hot(target.long(), pred.shape[-1]).to(pred.dtype)
    k = boundary_width
    pad = k // 2
    dil = max_pool2d(onehot, k, 1, pad)
    ero = 1.0 - max_pool2d(1.0 - onehot, k, 1, pad)
    band = torch.sum(dil - ero, dim=-1) > 0
    weights = torch.where(band, _scalar(boundary_weight, pred), _scalar(1.0, pred))
    if valid is not None:
        weights = weights * valid.to(pred.dtype)[:, None, None]
    ce = cross_entropy(pred, target, reduction="none")
    return torch.mean(ce * weights)


def generate_contour_targets(masks: torch.Tensor, num_classes: int = 3) -> torch.Tensor:
    """Binary contour targets from the target mask's gradient, with an edge
    width that grows with the resolution. masks: (N, H, W) int ->
    (N, H, W, 1)."""
    h, w = masks.shape[1], masks.shape[2]
    t = (masks == 1).to(torch.float32)[..., None]
    dy = torch.abs(t[:, 1:, :, :] - t[:, :-1, :, :])
    dx = torch.abs(t[:, :, 1:, :] - t[:, :, :-1, :])
    dy = torch.cat([dy, dy[:, -1:]], dim=1)  # edge padding
    dx = torch.cat([dx, dx[:, :, -1:]], dim=2)
    contours = torch.maximum(dy, dx)

    base_resolution = 64 * 48
    ratio = (h * w) / base_resolution
    edge_width = max(1, int(math.sqrt(ratio) * 1.5))
    if edge_width > 1:
        k = 2 * edge_width - 1
        hit = max_pool2d(contours, k, 1, k // 2)  # any edge within k: a binary dilation
        contours = (hit > 0.1).to(torch.float32)
    return contours


def generate_distance_targets(masks: torch.Tensor, iterations: int = 5) -> torch.Tensor:
    """Max-pool cascade approximation of the distance to the boundary.
    masks: (N, H, W) int -> (N, H, W, 1)."""
    d = (masks == 1).to(torch.float32)[..., None]
    for _ in range(iterations):
        dil = max_pool2d(d, 3, 1, 1)
        d = d + (1.0 - d) * dil * 0.5
    return d


@dataclass(frozen=True)
class RefinedLossConfig:
    base: HierarchicalLossConfig = field(default_factory=lambda: HierarchicalLossConfig(
        bg_weight=1.5, fg_weight=1.5, target_weight=1.2, consistency_weight=0.3))
    active_contour_weight: float = 0.01
    boundary_aware_weight: float = 0.01
    contour_loss_weight: float = 0.01
    distance_loss_weight: float = 0.01
    use_active_contour_loss: bool = False
    use_boundary_aware_loss: bool = False
    use_contour_detection: bool = True
    use_distance_transform: bool = True
    base_mask_size: Tuple[int, int] = (64, 48)
    auto_adjust_contour_weight: bool = True
    # optional distance-aware CE/Dice term
    distance_aware: Optional[DistanceAwareLossConfig] = None
    distance_aware_weight: float = 1.0


def refined_hierarchical_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    aux: Dict[str, torch.Tensor],
    state: HierarchicalLossState,
    cfg: RefinedLossConfig = RefinedLossConfig(),
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, HierarchicalLossState, Dict[str, torch.Tensor]]:
    """The base hierarchical loss plus the clamped refinement terms."""
    total, new_state, metrics = hierarchical_loss(
        predictions, targets, aux, state, cfg.base, valid=valid)

    if cfg.use_active_contour_loss:
        ac = torch.clamp(active_contour_loss(torch.softmax(predictions, dim=-1)), max=10.0)
        total = total + cfg.active_contour_weight * ac
        metrics["active_contour"] = ac

    if cfg.use_boundary_aware_loss:
        ba = torch.clamp(boundary_aware_loss(predictions, targets, 3, 2.0, valid=valid), max=10.0)
        total = total + cfg.boundary_aware_weight * ba
        metrics["boundary_aware"] = ba

    if cfg.use_contour_detection and "contours" in aux:
        ct = generate_contour_targets(targets)
        # the contours aux is after its sigmoid: BCE on probabilities
        p = torch.clamp(aux["contours"], 1e-7, 1.0 - 1e-7)
        bce = -(ct * torch.log(p) + (1.0 - ct) * torch.log(1.0 - p))
        if valid is not None:
            vw = valid.to(p.dtype)[:, None, None, None]
            closs = torch.sum(bce * vw) / torch.clamp(torch.sum(vw * torch.ones_like(bce)),
                                                      min=1.0)
        else:
            closs = torch.mean(bce)
        closs = torch.clamp(closs, max=10.0)
        h, w = targets.shape[1], targets.shape[2]
        if cfg.auto_adjust_contour_weight:
            base_res = cfg.base_mask_size[0] * cfg.base_mask_size[1]
            adj = math.sqrt(base_res / (h * w))
            weight = min(max(cfg.contour_loss_weight * adj, 0.001), 0.5)
        else:
            weight = cfg.contour_loss_weight
        total = total + weight * closs
        metrics["contour"] = closs
        metrics["contour_weight"] = _scalar(weight, closs)

    if cfg.use_distance_transform and "distance_map" in aux:
        dt = generate_distance_targets(targets)
        l1 = torch.abs(aux["distance_map"] - dt)
        if valid is not None:
            vw = valid.to(l1.dtype)[:, None, None, None]
            dloss = torch.sum(l1 * vw) / torch.clamp(torch.sum(vw * torch.ones_like(l1)), min=1.0)
        else:
            dloss = torch.mean(l1)
        dloss = torch.clamp(dloss, max=10.0)
        total = total + cfg.distance_loss_weight * dloss
        metrics["distance_transform"] = dloss

    if cfg.distance_aware is not None:
        da, da_metrics = distance_aware_loss(predictions, targets, cfg.distance_aware, valid=valid)
        total = total + cfg.distance_aware_weight * da
        metrics["distance_aware"] = da
        metrics["distance_aware_weighted_ce"] = da_metrics["weighted_ce"]

    metrics["total_loss"] = total
    return total, new_state, metrics
