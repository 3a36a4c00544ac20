"""Distillation train steps: the binary UNet with temperature progression,
and hierarchical KD of the flagship.

Counterpart of the JAX package's ``training/distill.py``. Like
``training/steps.py``, a step updates the state in place and returns
``(state, metrics)`` with the metrics as device tensors; the NaN guard is
``steps._apply_step``'s (one host sync a step). With ``mesh=`` (JAX
``distill.py:45-111``, ``:124-200``) every rank holds the teacher whole
(replicated) and runs both forwards on its slice of the batch; the
student's gradients, running statistics, metrics and loss (and the
hierarchical step's loss state) are averaged over the ranks before the
update (``steps.mesh_average``), and dropout draws from the rank's own
stream (``steps.RankGenerator``).

The frozen teacher runs in eval mode under ``torch.no_grad``, so a teacher
built with ``pallas_tail=True`` and ``encoder_fused_blocks=N`` runs the
fused stage-1 tail and the fused MBConv kernels in every step, as a frozen
stage 1 does in ``training/steps.py``; one built with the tail hands over
its dense ``(B, H, W)`` logit map, which the step reads as ``(B, H, W, 1)``.
The student runs in train mode, its BatchNorm statistics handed over
through ``ops.norms.deferred_running_stats`` and written only when the
step is kept. ``compute_dtype="bfloat16"`` runs both forwards on bf16
copies: the student's made every step (``steps.cast_variables``, so the
gradients reach the float32 masters), the teacher's made once, when the
step is built, as the JAX step casts the teacher's variables outside its
loss; the KD loss and the masters stay float32.

Binary batch contract: ``{"images": (B, H, W, 3), "masks": (B, H, W, 1)}``;
the hierarchical step takes ``training.steps``' batches.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..inference import init_weights, resolve_device
from ..losses.distillation import (DistillationConfig, DistillationState,
                                   hierarchical_distillation_loss, scheduled_temperature,
                                   unet_distillation_loss, update_adaptive_weights)
from ..losses.hierarchical import RefinedLossConfig, refined_hierarchical_loss
from ..models.blocks import set_dropout_generator
from ..models.unet import PeopleSegmentationUNet
from ..ops.norms import deferred_running_stats
from .metrics import binary_miou
from .state import TrainState
from .steps import (Batch, RankGenerator, _apply_step, _compute_dtype, batch_to,
                    cast_variables, gradients, mesh_average, new_running_stats,
                    rois_from_boxes)


def build_student_teacher(student_variant: str, teacher_variant: str, device="cuda",
                          teacher_overrides: Optional[Dict] = None,
                          student_cls: type = PeopleSegmentationUNet,
                          student_overrides: Optional[Dict] = None,
                          **kwargs) -> Tuple[PeopleSegmentationUNet, PeopleSegmentationUNet]:
    """The student and teacher UNets with seeded weights (``inference.
    init_weights``, seeds 0 and 42 as the JAX loops' keys) on ``device``
    (the GPU unless the caller asks for the CPU), the teacher in eval mode.
    ``kwargs`` go to both (``decoder_channels``), ``teacher_overrides`` to
    the teacher only (its route flags: ``pallas_tail``,
    ``encoder_fused_blocks``); the student is a ``student_cls`` (the YOLO
    distillation's ``YOLOFeatureDistillStudent``) with ``student_overrides``
    besides."""
    dev = resolve_device(device)
    student = student_cls(encoder_variant=student_variant,
                          **{**kwargs, **(student_overrides or {})})
    teacher = PeopleSegmentationUNet(encoder_variant=teacher_variant,
                                     **{**kwargs, **(teacher_overrides or {})})
    init_weights(student, 0)
    init_weights(teacher, 42)
    return student.to(dev), teacher.to(dev).eval()


def unet_logits(unet: nn.Module, images: torch.Tensor,
                variables: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H, W, 1) logits of a one-class UNet (the
    fused tail's dense map or the plain (B, 1, H, W) output, both as NHWC),
    through ``functional_call`` on ``variables`` when given."""
    x = images.permute(0, 3, 1, 2)
    if variables is None:
        form, y = unet(x, raw=True)
    else:
        form, y = functional_call(unet, variables, (x,), {"raw": True})
    return y[..., None] if form == "dense" else y.permute(0, 2, 3, 1)


def teacher_copy(teacher: nn.Module, compute_dtype: Optional[str]) -> nn.Module:
    """The teacher the step runs: itself in float32, else a copy in the
    compute dtype made once (every floating parameter and buffer cast, the
    JAX ``_cast_floating`` of its variables), in eval mode."""
    cdt = _compute_dtype(compute_dtype)
    t = teacher if cdt is None else copy.deepcopy(teacher).to(cdt)
    return t.eval()


def make_distill_loss_fn(student: nn.Module, teacher: nn.Module,
                         cfg: DistillationConfig = DistillationConfig(),
                         compute_dtype: Optional[str] = None):
    """``loss_fn(distill_state, batch) -> (loss, (new_stats, metrics))`` of the
    binary KD step, with ``teacher`` already in the compute dtype
    (:func:`teacher_copy`); the student in its current mode. The images are
    taken, and the logits returned, in the student's parameter dtype."""
    cdt = _compute_dtype(compute_dtype)
    param_dtype = next(student.parameters()).dtype

    def loss_fn(distill_state: DistillationState, batch: Dict[str, torch.Tensor]):
        images = batch["images"].to(param_dtype if cdt is None else cdt)
        with torch.no_grad():
            t_logits = unet_logits(teacher, images).to(param_dtype)
        with deferred_running_stats() as collected:
            s_vars = cast_variables(student, cdt) if cdt is not None else None
            s_logits = unet_logits(student, images, s_vars).to(param_dtype)
        new_stats = new_running_stats(student, collected, compute_dtype)
        masks = batch["masks"]
        loss, metrics = unet_distillation_loss(s_logits, t_logits, masks, distill_state, cfg)
        metrics["student_miou"] = binary_miou(s_logits.detach(), masks)
        metrics["teacher_miou"] = binary_miou(t_logits, masks)
        return loss, (new_stats, metrics)

    return loss_fn


def make_distill_train_step(
    student: nn.Module,
    teacher: nn.Module,
    cfg: DistillationConfig = DistillationConfig(),
    compute_dtype: Optional[str] = None,
    mesh=None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)`` for a state over
    ``student`` holding a ``distill_state``: the teacher's forward (eval, no
    autograd), the student's forward and backward in train mode, the binary
    KD loss at the state's temperature and weights, the NaN guard and the
    optimizer's update. Metrics: the loss's (``kl_loss``, ``mse_loss``,
    ``bce_loss``, ``dice_loss``, ``total_loss``, ``temperature``, ``alpha``,
    ``task_weight``), ``student_miou`` and ``teacher_miou``. With ``mesh`` the
    batch is this rank's slice (module docstring)."""
    loss_fn = make_distill_loss_fn(student, teacher_copy(teacher, compute_dtype), cfg,
                                   compute_dtype)

    def step(state: TrainState, batch: Batch):
        if state.model is not student:
            raise ValueError("the state holds another model than this step's student")
        if state.distill_state is None:
            raise ValueError("a distillation step needs a state with a distill_state")
        student.train()
        device = next(student.parameters()).device
        loss, (new_stats, metrics) = loss_fn(state.distill_state, batch_to(batch, device))
        grads, loss = gradients(state, loss), loss.detach()
        if mesh is not None:
            grads, loss, metrics, _, new_stats = mesh_average(mesh, grads, loss, metrics,
                                                              new_stats=new_stats)
        state = _apply_step(state, grads, state.loss_state, new_stats, loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_hierarchical_distill_loss_fn(student_model: nn.Module, teacher_model: nn.Module,
                                      loss_cfg: RefinedLossConfig = RefinedLossConfig(),
                                      temperature: float = 4.0, alpha: float = 0.7,
                                      aux_weight: float = 0.3):
    """``loss_fn(loss_state, generator, batch) -> (loss, (new_loss_state,
    new_stats, metrics))`` of hierarchical KD in float32: the teacher in eval
    mode without autograd, the student in its current mode (dropout from
    ``generator``), the refined hierarchical loss blended with the KD
    terms. The images and boxes are taken in the student's parameter
    dtype."""
    param_dtype = next(student_model.parameters()).dtype

    def loss_fn(loss_state, generator: torch.Generator, batch: Dict[str, torch.Tensor]):
        images = batch["images"].to(param_dtype)
        rois = rois_from_boxes(batch["boxes"].to(param_dtype))
        teacher_model.eval()
        with torch.no_grad():
            t_logits, t_aux = teacher_model(images, rois)
        set_dropout_generator(student_model, generator)
        with deferred_running_stats() as collected:
            s_logits, s_aux = student_model(images, rois)
        new_stats = new_running_stats(student_model, collected)
        b, k = batch["boxes"].shape[:2]
        mh, mw = batch["masks"].shape[-2:]
        targets = batch["masks"].reshape(b * k, mh, mw)
        valid = batch["valid"].reshape(b * k)
        base, new_loss_state, metrics = refined_hierarchical_loss(
            s_logits, targets, s_aux, loss_state, loss_cfg, valid=valid)
        total, kd_metrics = hierarchical_distillation_loss(
            s_logits, t_logits, s_aux, t_aux, base, temperature=temperature, alpha=alpha,
            aux_weight=aux_weight)
        metrics.update(kd_metrics)
        return total, (new_loss_state, new_stats, metrics)

    return loss_fn


def make_hierarchical_distill_step(
    student_model: nn.Module,
    teacher_model: nn.Module,
    loss_cfg: RefinedLossConfig = RefinedLossConfig(),
    temperature: float = 4.0,
    alpha: float = 0.7,
    aux_weight: float = 0.3,
    mesh=None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)`` for a state over
    ``student_model`` (a hierarchical model; a frozen stage 1 runs as in
    ``training/steps.py``): KD from ``teacher_model`` blended with the
    refined hierarchical loss, which also updates the loss state. With
    ``mesh`` the batch is this rank's slice (module docstring)."""
    loss_fn = make_hierarchical_distill_loss_fn(student_model, teacher_model, loss_cfg,
                                                temperature, alpha, aux_weight)
    dropout = RankGenerator(mesh)

    def step(state: TrainState, batch: Batch):
        if state.model is not student_model:
            raise ValueError("the state holds another model than this step's student")
        student_model.train()
        device = next(student_model.parameters()).device
        loss, (new_loss_state, new_stats, metrics) = loss_fn(
            state.loss_state, dropout(state), batch_to(batch, device))
        grads, loss = gradients(state, loss), loss.detach()
        if mesh is not None:
            grads, loss, metrics, new_loss_state, new_stats = mesh_average(
                mesh, grads, loss, metrics, new_loss_state, new_stats)
        state = _apply_step(state, grads, new_loss_state, new_stats, loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def epoch_update(state: TrainState, cfg: DistillationConfig, epoch: int, total_epochs: int,
                 student_iou: Optional[float] = None,
                 teacher_iou: Optional[float] = None) -> TrainState:
    """Between epochs: the scheduled temperature of ``epoch`` and, given both
    validation IoUs, the adaptive weights; the state's ``distill_state`` is
    replaced and the state returned."""
    ds = state.distill_state
    new_t = scheduled_temperature(cfg, epoch, total_epochs)
    ds = ds.replace(temperature=torch.tensor(new_t, dtype=torch.float32,
                                             device=ds.temperature.device))
    if student_iou is not None and teacher_iou is not None:
        ds = update_adaptive_weights(ds, cfg, student_iou, teacher_iou)
    state.distill_state = ds
    return state
