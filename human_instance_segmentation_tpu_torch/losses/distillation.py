"""Knowledge-distillation losses: hierarchical KD and binary UNet KD with
temperature progression and adaptive weight elimination.

Counterpart of the JAX package's ``losses/distillation.py``, NHWC like its
functions, every float op in its order:

- :func:`unet_distillation_loss` (binary KD): the eps-clamped binary
  sigmoid KL at temperature T (clamped to [0, 5]), the MSE between the
  logits, and the task loss 0.7 BCE (``pos_weight = sqrt(bg / fg)``) + 0.3
  Dice against the ground truth, blended by the state's weights;
- :func:`scheduled_temperature` (linear, cosine or exponential from the
  initial to the final temperature over the epochs) and
  :func:`update_adaptive_weights` (alpha decays as exp(-20 delta) once the
  student beats the teacher, and distillation is switched off for good once
  it beats it by 3%);
- :func:`hierarchical_distillation_loss` (T^2-scaled softmax KL on the
  final and the auxiliary logits, blended with the base task loss),
  :func:`feature_matching_loss` and :func:`yolo_distillation_loss`.

The schedule and adaptive state is an explicit :class:`DistillationState`
of device tensors, kept in the train state and checkpointed
(``state_dict`` / ``from_state_dict``, like ``HierarchicalLossState``).
The temperature schedule is a host function of the epoch in Python floats,
stored as a float32 tensor, as the JAX package computes and stores it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.sampling import resize_bilinear

Scalar = Union[float, torch.Tensor]


@dataclass
class DistillationState:
    """float32 scalars ``temperature``, ``alpha``, ``task_weight``,
    ``performance_ratio`` and the bool scalar ``eliminated``, all on one
    device."""

    temperature: torch.Tensor
    alpha: torch.Tensor
    task_weight: torch.Tensor
    performance_ratio: torch.Tensor
    eliminated: torch.Tensor

    FIELDS = ("temperature", "alpha", "task_weight", "performance_ratio", "eliminated")

    @classmethod
    def create(cls, temperature: float = 3.0, alpha: float = 0.5, task_weight: float = 0.3,
               device="cpu") -> "DistillationState":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(temperature=f32(temperature), alpha=f32(alpha), task_weight=f32(task_weight),
                   performance_ratio=f32(1.0),
                   eliminated=torch.tensor(False, device=device))

    def replace(self, **changes) -> "DistillationState":
        return dataclasses.replace(self, **changes)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.FIELDS}

    @classmethod
    def from_state_dict(cls, d: Dict[str, torch.Tensor], device=None) -> "DistillationState":
        return cls(**{k: torch.as_tensor(d[k]).to(device) if device is not None
                      else torch.as_tensor(d[k]) for k in cls.FIELDS})


@dataclass(frozen=True)
class DistillationConfig:
    initial_temperature: float = 10.0
    final_temperature: float = 1.0
    schedule_type: str = "cosine"  # linear | cosine | exponential
    initial_alpha: float = 0.5
    initial_task_weight: float = 0.3
    fg_ratio: float = 0.162
    use_dice_loss: bool = True
    adaptive_distillation: bool = True
    amplification_factor: float = 20.0
    zero_distillation_threshold: float = 0.03
    min_alpha: float = 0.0

    @property
    def pos_weight(self) -> float:
        return math.sqrt((1.0 - self.fg_ratio) / self.fg_ratio)


def scheduled_temperature(cfg: DistillationConfig, epoch: int, total_epochs: int) -> float:
    """The temperature of ``epoch``: a host function of the epoch index in
    Python floats (the JAX function's arithmetic)."""
    if total_epochs <= 1:
        return cfg.final_temperature
    progress = epoch / (total_epochs - 1)
    t0, t1 = cfg.initial_temperature, cfg.final_temperature
    if cfg.schedule_type == "linear":
        return t0 + (t1 - t0) * progress
    if cfg.schedule_type == "cosine":
        return t1 + (t0 - t1) * 0.5 * (1.0 + math.cos(math.pi * progress))
    if cfg.schedule_type == "exponential":
        return t0 * math.exp(math.log(t1 / t0) * progress)
    return t0


def update_adaptive_weights(state: DistillationState, cfg: DistillationConfig,
                            student_iou: Scalar, teacher_iou: Scalar) -> DistillationState:
    """The adaptive alpha and task weight from the validation IoUs, with
    permanent elimination, as a new state (float32, on the state's
    device)."""
    if not cfg.adaptive_distillation:
        return state
    dev = state.alpha.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(dev)

    ratio = f32(student_iou) / (f32(teacher_iou) + 1e-6)
    beats = ratio > (1.0 + cfg.zero_distillation_threshold)
    eliminated = torch.logical_or(state.eliminated, beats)

    amplified = (ratio - 1.0) * cfg.amplification_factor
    decayed_alpha = torch.clamp(cfg.initial_alpha * torch.exp(-amplified), min=cfg.min_alpha)
    tw_target = 1.0 - torch.exp(-amplified * 2.0)
    raised_tw = torch.clamp(
        cfg.initial_task_weight + (1.0 - cfg.initial_task_weight) * tw_target, max=1.0)

    better = ratio > 1.0
    alpha = torch.where(better, decayed_alpha, f32(cfg.initial_alpha))
    tw = torch.where(better, raised_tw, f32(cfg.initial_task_weight))
    alpha = torch.where(eliminated, f32(0.0), alpha)
    tw = torch.where(eliminated, f32(1.0), tw)
    return state.replace(alpha=alpha, task_weight=tw, performance_ratio=ratio,
                         eliminated=eliminated)


def binary_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                     smooth: float = 1e-5) -> torch.Tensor:
    """1 - the batch mean of the per-sample dice of sigmoid probabilities."""
    p = torch.sigmoid(logits)
    n = logits.shape[0]
    pf = p.reshape(n, -1)
    tf = targets.reshape(n, -1).to(p.dtype)
    inter = torch.sum(pf * tf, dim=1)
    dice = (2.0 * inter + smooth) / (torch.sum(pf, dim=1) + torch.sum(tf, dim=1) + smooth)
    return 1.0 - torch.mean(dice)


def unet_distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    target_masks: Optional[torch.Tensor],
    state: DistillationState,
    cfg: DistillationConfig = DistillationConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Binary UNet KD loss on (B, H, W, 1) logits; every branch is computed
    and blended with ``where`` (a disabled distillation term is a 0)."""
    T = state.temperature
    eps = 1e-5
    sc = torch.clamp(student_logits, -10.0, 10.0)
    tc = torch.clamp(teacher_logits, -10.0, 10.0)
    s = torch.clamp(torch.sigmoid(sc / T), eps, 1.0 - eps)
    t = torch.clamp(torch.sigmoid(tc / T), eps, 1.0 - eps)
    term1 = t * (torch.log(t + eps) - torch.log(s + eps))
    term2 = (1.0 - t) * (torch.log(1.0 - t + eps) - torch.log(1.0 - s + eps))
    kl = torch.clamp(torch.mean(term1 + term2), 0.0, 5.0)
    mse = torch.mean((student_logits - teacher_logits) ** 2)

    disabled = torch.logical_or(state.eliminated,
                                torch.logical_or(state.alpha == 0.0, state.task_weight >= 0.99))
    if cfg.adaptive_distillation:
        effective_alpha = torch.where(
            state.performance_ratio > 1.0,
            state.alpha * torch.clamp(2.0 - state.performance_ratio, min=0.1), state.alpha)
    else:
        effective_alpha = state.alpha
    kl_weight = torch.clamp(effective_alpha, max=0.1)
    zero = torch.zeros((), dtype=kl.dtype, device=kl.device)
    distill = torch.where(disabled, zero, kl_weight * kl + (1.0 - kl_weight) * mse)

    metrics = {"kl_loss": torch.where(disabled, zero, kl),
               "mse_loss": torch.where(disabled, zero, mse),
               "temperature": T, "alpha": state.alpha, "task_weight": state.task_weight}

    if target_masks is not None:
        tm = target_masks.to(student_logits.dtype)
        pw = cfg.pos_weight
        logp = F.logsigmoid(student_logits)
        lognp = F.logsigmoid(-student_logits)
        bce = torch.mean(-(pw * tm * logp + (1.0 - tm) * lognp))
        metrics["bce_loss"] = bce
        if cfg.use_dice_loss:
            dl = binary_dice_loss(student_logits, tm)
            metrics["dice_loss"] = dl
            task = 0.7 * bce + 0.3 * dl
        else:
            metrics["dice_loss"] = zero
            task = bce
        total = state.task_weight * task + (1.0 - state.task_weight) * distill
    else:
        total = distill

    metrics["total_loss"] = total
    return total, metrics


def _channel_normalized(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def feature_matching_loss(
    student_features: Dict[str, torch.Tensor],
    teacher_features: Dict[str, torch.Tensor],
    normalize: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-layer MSE between (optionally channel-normalised) NHWC student and
    teacher feature maps of the keys both have; a student map of another
    spatial size is resized bilinearly to the teacher's, one of another
    channel count is skipped (the caller projects channels first)."""
    total: Scalar = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    n = 0
    for key, t in teacher_features.items():
        if key not in student_features:
            continue
        s = student_features[key]
        t = t.detach()
        if s.shape[1:3] != t.shape[1:3]:
            s = resize_bilinear(s, t.shape[1], t.shape[2])
        if s.shape[-1] != t.shape[-1]:
            continue
        if normalize:
            s, t = _channel_normalized(s), _channel_normalized(t)
        loss = torch.mean((s - t) ** 2)
        metrics[f"fm_{key}"] = loss
        total = total + loss
        n += 1
    total = torch.as_tensor(total, dtype=torch.float32) / max(n, 1)
    metrics["feature_matching_loss"] = total
    return total, metrics


def hierarchical_distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    student_aux: Dict[str, torch.Tensor],
    teacher_aux: Dict[str, torch.Tensor],
    base_loss: torch.Tensor,
    temperature: float = 4.0,
    alpha: float = 0.7,
    aux_weight: float = 0.3,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Hierarchical (3-class) KD: T^2-scaled softmax KL on the final logits
    plus ``aux_weight`` x the KL on the bg/fg and target/non-target
    auxiliary logits, blended with the base task loss."""
    T = temperature

    def kd_kl(s_logits, t_logits):
        s_logp = F.log_softmax(s_logits / T, dim=-1)
        t_p = F.softmax(t_logits / T, dim=-1)
        return torch.mean(torch.sum(t_p * (torch.log(t_p + 1e-10) - s_logp), dim=-1))

    kd = kd_kl(student_logits, teacher_logits) * (T * T)
    aux_kd: Scalar = 0.0
    metrics = {"kd_final": kd}
    for key in ("bg_fg_logits", "target_nontarget_logits"):
        if key in student_aux and key in teacher_aux:
            k = kd_kl(student_aux[key], teacher_aux[key].detach())
            aux_kd = aux_kd + aux_weight * k
            metrics[f"kd_{key}"] = k
    total = alpha * (kd + aux_kd) + (1.0 - alpha) * base_loss
    metrics["total_loss"] = total
    return total, metrics


def yolo_distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    target_masks: torch.Tensor,
    student_features: Optional[torch.Tensor] = None,
    yolo_features: Optional[torch.Tensor] = None,
    temperature: float = 3.0,
    kl_weight: float = 1.0,
    mse_weight: float = 0.5,
    bce_weight: float = 0.5,
    dice_weight: float = 1.0,
    feature_weight: float = 0.5,
    feature_loss_type: str = "mse",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The YOLO-feature distillation loss: binary sigmoid KL at temperature
    T (scaled by T, clamped), MSE against the teacher logits, BCE + Dice
    against the ground truth, and a feature-alignment term (MSE clamped to
    10, or 1 - cosine) between the student's projected stride-8 feature and
    the precomputed YOLO feature (NHWC). Its training step is
    ``training/yolo_distill.py``'s."""
    eps = 1e-7
    T = temperature
    t_logits = teacher_logits.detach()
    p = torch.clamp(torch.sigmoid(t_logits / T), eps, 1.0 - eps)
    q = torch.clamp(torch.sigmoid(student_logits / T), eps, 1.0 - eps)
    kl_pos = torch.clamp(p * torch.log(p / q), -10.0, 10.0)
    kl_neg = torch.clamp((1.0 - p) * torch.log((1.0 - p) / (1.0 - q)), -10.0, 10.0)
    kl = torch.clamp(torch.mean(kl_pos + kl_neg) * T, 0.0, 100.0)

    mse = torch.mean((student_logits - t_logits) ** 2)

    tm = target_masks.to(student_logits.dtype)
    if tm.dim() == student_logits.dim() - 1:
        tm = tm[..., None]
    bce = torch.mean(torch.clamp(student_logits, min=0.0) - student_logits * tm
                     + torch.log1p(torch.exp(-torch.abs(student_logits))))
    dice = torch.clamp(binary_dice_loss(student_logits, tm), 0.0, 2.0)

    feat = torch.zeros((), dtype=student_logits.dtype, device=student_logits.device)
    if student_features is not None and yolo_features is not None:
        yf = yolo_features.detach()
        if feature_loss_type == "mse":
            feat = torch.clamp(torch.mean((student_features - yf) ** 2), 0.0, 10.0)
        elif feature_loss_type == "cosine":
            sf = student_features.reshape(student_features.shape[0], -1,
                                          student_features.shape[-1])
            tf = yf.reshape(yf.shape[0], -1, yf.shape[-1])
            feat = 1.0 - torch.mean(torch.sum(_channel_normalized(sf) * _channel_normalized(tf),
                                              dim=-1))
        else:
            raise ValueError(f"unknown feature loss type: {feature_loss_type}")

    total = (kl_weight * kl + mse_weight * mse + bce_weight * bce
             + dice_weight * dice + feature_weight * feat)
    return total, {"kl_loss": kl, "mse_loss": mse, "bce_loss": bce,
                   "dice_loss": dice, "feature_loss": feat, "total_loss": total}
