"""Evaluation metrics as additive sums over batches.

Counterpart of the JAX package's ``training/metrics.py``, on tensors and on
the device of its inputs. It replaces the reference's ``evaluate_model``
(``src/human_edge_detection/train_utils.py:109-404``), whose per-sample
loops become batched reductions: target IoU, detection rates at 0.5 and
0.7, precision, recall and F1, instance-separation accuracy, and the three
confusion matrices (pixel-level 3x3, bg/fg, target/non-target).

Pixel counts are exact integers carried in float32, as in JAX: a sum stays
exact while it is below 2^24, which a batch of 8 x 8 ROIs of 128 x 96
(786,432 pixels) is far from. ``torch.argmax`` returns the first of tied
maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_classes, num_classes) count matrix; rows = target, cols = pred.
    Integer counts without ``weights``, sums in the weights' dtype with."""
    idx = (target.reshape(-1) * num_classes + pred.reshape(-1)).long()
    w = None if weights is None else weights.reshape(-1)
    cm = torch.bincount(idx, weights=w, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def batch_metrics(logits: torch.Tensor, targets: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Additive per-batch metric sums; accumulate across batches, then call
    :func:`finalize_metrics`.

    logits: (N, H, W, 3); targets: (N, H, W); valid: (N,).
    """
    f32 = logits.dtype
    n = logits.shape[0]
    vw = torch.ones((n,), dtype=f32, device=logits.device) if valid is None else valid.to(f32)
    pix_w = vw[:, None, None].expand(targets.shape).reshape(-1)
    pred = torch.argmax(logits, dim=-1)

    def iou_of(cls: int) -> Tuple[torch.Tensor, torch.Tensor]:
        p = pred == cls
        t = targets == cls
        inter = torch.sum(p & t, dim=(1, 2)).to(f32)
        union = torch.sum(p | t, dim=(1, 2)).to(f32)
        return inter, union

    inter1, union1 = iou_of(1)
    target_iou = inter1 / torch.clamp(union1, min=1.0)
    has_target = (torch.sum(targets == 1, dim=(1, 2)) > 0).to(f32) * vw

    p1 = torch.sum(pred == 1, dim=(1, 2)).to(f32)
    t1 = torch.sum(targets == 1, dim=(1, 2)).to(f32)
    precision = inter1 / torch.clamp(p1, min=1.0)
    recall = inter1 / torch.clamp(t1, min=1.0)

    # instance separation: among pixels that are truly some instance (1 or
    # 2), the fraction assigned to the right one of the two
    inst_true = targets > 0
    inst_correct = inst_true & (pred == targets)
    sep_n = torch.sum(inst_true, dim=(1, 2)).to(f32)
    sep_acc = torch.sum(inst_correct, dim=(1, 2)).to(f32) / torch.clamp(sep_n, min=1.0)
    has_inst = (sep_n > 0).to(f32) * vw

    cm3 = confusion_matrix(pred, targets, 3, weights=pix_w)
    cm_bgfg = confusion_matrix((pred > 0).long(), (targets > 0).long(), 2, weights=pix_w)
    fg_w = pix_w * (targets.reshape(-1) > 0)
    cm_tnt = confusion_matrix((pred.reshape(-1) == 2).long(), (targets.reshape(-1) == 2).long(),
                              2, weights=fg_w)

    return {
        "iou_sum": torch.sum(target_iou * vw),
        "det50_sum": torch.sum((target_iou > 0.5) * vw),
        "det70_sum": torch.sum((target_iou > 0.7) * vw),
        "precision_sum": torch.sum(precision * vw),
        "recall_sum": torch.sum(recall * vw),
        "sep_acc_sum": torch.sum(sep_acc * has_inst),
        "sep_n": torch.sum(has_inst),
        "n": torch.sum(vw),
        "n_with_target": torch.sum(has_target),
        "cm3": cm3,
        "cm_bgfg": cm_bgfg,
        "cm_tnt": cm_tnt,
    }


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def finalize_metrics(sums: Dict[str, object]) -> Dict[str, float]:
    """Means and row-normalised confusion matrices from accumulated sums
    (tensors on any device, or numpy)."""
    s = {k: _host(v) for k, v in sums.items()}
    n = max(float(s["n"]), 1.0)
    precision = float(s["precision_sum"]) / n
    recall = float(s["recall_sum"]) / n
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    out = {
        "target_miou": float(s["iou_sum"]) / n,
        "detection_rate_0.5": float(s["det50_sum"]) / n,
        "detection_rate_0.7": float(s["det70_sum"]) / n,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "instance_separation_accuracy": float(s["sep_acc_sum"]) / max(float(s["sep_n"]), 1.0),
        "num_samples": n,
    }
    for key in ("cm3", "cm_bgfg", "cm_tnt"):
        cm = s[key].astype(np.float64)
        out[f"{key}_normalized"] = (cm / np.clip(cm.sum(axis=1, keepdims=True), 1, None)).tolist()
    return out


def binary_miou(logits: torch.Tensor, masks: torch.Tensor,
                threshold: float = 0.5) -> torch.Tensor:
    """Binary segmentation mIoU for the distillation stage (the reference's
    train_distillation_staged.py:369-583): the batch mean of
    IoU(sigmoid(logit) > threshold, mask > 0.5)."""
    pred = torch.sigmoid(logits) > threshold
    t = masks > 0.5
    inter = torch.sum(pred & t, dim=(1, 2, 3)).to(torch.float32)
    union = torch.sum(pred | t, dim=(1, 2, 3)).to(torch.float32)
    return torch.mean(inter / torch.clamp(union, min=1.0))
