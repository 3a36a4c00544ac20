"""YOLO feature-distillation training CLI.

Counterpart of the JAX package's ``training/yolo_distill.py`` on one
device: a B0 student UNet (``models.yolo_distill.YOLOFeatureDistillStudent``)
learns from

- a frozen teacher UNet's output logits (binary KD: sigmoid-KL at
  temperature T, scheduled cosine from ``temperature`` to
  ``final_temperature`` over the epochs, + MSE), and
- YOLOv9's stride-8 features (1024-channel ``layer_34``) through the
  projection head on the student's stride-8 encoder feature,

plus BCE + Dice against the ground truth (``losses.distillation.
yolo_distillation_loss``). The YOLO features arrive precomputed: synthetic
ones, or ``.npz`` files in ``data/yolo_features``' schema
(``--feature-dir``).

The step runs in float32, as the JAX step does, and has no NaN guard, as
the JAX step has none. The encoder is frozen by a ``set_to_zero`` group
(its parameters never change, and no gradient is computed for them); the
rest takes ``clip_by_global_norm(1.0)`` over its own gradients, then AdamW
(``learning_rate``, weight decay 1e-4), as JAX's ``multi_transform``. The
student runs in train mode, so every BatchNorm statistic, the frozen
encoder's included, moves each step (JAX's ``mutable=["batch_stats"]`` over
the whole student). The teacher is a ``PeopleSegmentationUNet`` in eval
mode under ``torch.no_grad``, built by ``distill.build_student_teacher``
(``teacher_overrides`` takes its route flags: with ``pallas_tail`` and
``encoder_fused_blocks`` it runs the fused tail and the fused MBConv
kernels in every step), loaded from ``teacher_checkpoint`` (a checkpoint
of this package) where one is given. Evaluation is the student's
``binary_miou`` over two validation batches (seed 99); the best student
is checkpointed with ``{"student_miou": best}`` at step ``epoch + 1``.

Usage:
    python -m human_instance_segmentation_tpu_torch.training.yolo_distill \\
        --epochs 2 --steps-per-epoch 4 --synthetic [--tiny] [--device cpu]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises).
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_yolo_batches(batch: int, image_hw, yolo_dim: int = 1024,
                           seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic ``{images, masks, yolo_features}`` (features at stride 8),
    the JAX loop's draws."""
    rng = np.random.default_rng(seed)
    ih, iw = image_hw
    fh, fw = ih // 8, iw // 8
    while True:
        masks = np.zeros((batch, ih, iw, 1), np.float32)
        for b in range(batch):
            x1, y1 = rng.integers(0, iw // 2), rng.integers(0, ih // 2)
            masks[b, y1:y1 + ih // 2, x1:x1 + iw // 2, 0] = 1.0
        yield {
            "images": rng.random((batch, ih, iw, 3), np.float32),
            "masks": masks,
            "yolo_features": (rng.standard_normal((batch, fh, fw, yolo_dim))
                              .astype(np.float32) * 0.1),
        }


def npz_feature_batches(feature_dir: str, batch: int,
                        seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Batches from precomputed feature files (``images``, ``masks`` and
    ``yolo_features`` per ``.npz``, NHWC, features at stride 8), rebatched
    to ``batch`` across files and cycled forever, the files shuffled per
    pass."""
    files = sorted(Path(feature_dir).glob("*.npz"))
    if not files:
        raise FileNotFoundError(f"no .npz feature files under {feature_dir}")
    rng = np.random.default_rng(seed)
    buf: Dict[str, list] = {"images": [], "masks": [], "yolo_features": []}
    while True:
        order = rng.permutation(len(files))
        for fi in order:
            with np.load(files[fi]) as z:
                for k in buf:
                    buf[k].extend(np.asarray(z[k], np.float32))
            while len(buf["images"]) >= batch:
                yield {k: np.stack(v[:batch]) for k, v in buf.items()}
                buf = {k: v[batch:] for k, v in buf.items()}


def yolo_optimizer(student, learning_rate: float, freeze_encoder: bool = True):
    """The JAX ``multi_transform``: ``encoder`` frozen (``set_to_zero``) when
    ``freeze_encoder``, everything else ``clip_by_global_norm(1.0)`` over
    its own gradients then AdamW at a constant ``learning_rate``, weight
    decay 1e-4."""
    from .optim import Transform, constant_schedule, set_to_zero, staged_optimizer

    train = Transform("adamw", constant_schedule(learning_rate), weight_decay=1e-4, clip=1.0)
    rules = [("encoder/", "frozen")] if freeze_encoder else []
    return staged_optimizer({"train": train, "frozen": set_to_zero()}, student, rules)


def make_yolo_loss_fn(student, teacher, feature_weight: float = 0.5,
                      feature_loss_type: str = "mse"):
    """``loss_fn(temperature, batch) -> (loss, (new_stats, metrics))``: the
    teacher's logits without autograd, the student's logits and projected
    feature in its current mode with its new running statistics handed over
    (``ops.norms.deferred_running_stats``), the YOLO distillation loss on
    NHWC tensors. The images are taken in the student's parameter dtype
    (float32 in training)."""
    import torch

    from ..losses.distillation import yolo_distillation_loss
    from ..ops.norms import deferred_running_stats
    from .distill import unet_logits
    from .steps import new_running_stats

    param_dtype = next(student.parameters()).dtype

    def loss_fn(temperature: float, batch: Dict[str, "torch.Tensor"]):
        images = batch["images"].to(param_dtype)
        with torch.no_grad():
            t_logits = unet_logits(teacher, images)
        with deferred_running_stats() as collected:
            s_logits, s_proj = student(images.permute(0, 3, 1, 2), return_features=True)
        new_stats = new_running_stats(student, collected)
        loss, metrics = yolo_distillation_loss(
            s_logits.permute(0, 2, 3, 1), t_logits, batch["masks"], s_proj.permute(0, 2, 3, 1),
            batch["yolo_features"], temperature=temperature, feature_weight=feature_weight,
            feature_loss_type=feature_loss_type)
        return loss, (new_stats, metrics)

    return loss_fn


def make_yolo_train_step(student, teacher, feature_weight: float = 0.5,
                         feature_loss_type: str = "mse"):
    """``step(state, batch, temperature) -> (state, metrics)`` for a state
    over ``student`` (its optimizer from :func:`yolo_optimizer`): the loss,
    the gradients of the parameters outside the frozen group, the
    optimizer's update and the new running statistics, every step (no NaN
    guard). Metrics are device tensors."""
    import torch

    from .steps import batch_to

    loss_fn = make_yolo_loss_fn(student, teacher, feature_weight, feature_loss_type)

    def step(state, batch, temperature: float):
        if state.model is not student:
            raise ValueError("the state holds another model than this step's student")
        student.train()
        opt = state.optimizer
        device = next(student.parameters()).device
        loss, (new_stats, metrics) = loss_fn(temperature, batch_to(batch, device))
        need = [i for i, label in enumerate(opt.labels) if opt.transforms[label].kind != "zero"]
        found = torch.autograd.grad(loss, [opt.params[i] for i in need])
        grads = [None] * len(opt.params)
        for i, g in zip(need, found):
            grads[i] = g
        opt.step(grads)
        with torch.no_grad():
            for buf, value, _ in new_stats:
                buf.copy_(value)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def run_yolo_feature_distillation(
    student_variant: str = "b0",
    teacher_variant: str = "b7",
    epochs: int = 2,
    steps_per_epoch: int = 10,
    batch: int = 4,
    image_hw=(640, 640),
    synthetic: bool = True,
    tiny: bool = False,
    learning_rate: float = 1e-3,
    temperature: float = 3.0,
    final_temperature: float = 1.0,
    feature_weight: float = 0.5,
    feature_loss_type: str = "mse",
    freeze_encoder: bool = True,
    teacher_checkpoint: Optional[str] = None,
    output_dir: Optional[str] = None,
    device: str = "cuda",
    feature_dir: Optional[str] = None,
    teacher_overrides: Optional[Dict] = None,
    return_state: bool = False,
):
    """Distil a YOLO-feature student; returns the last epoch's metrics with
    ``temperature`` and ``best_student_miou`` (and the final
    :class:`TrainState` with ``return_state``). ``teacher_overrides`` go to
    the teacher's constructor (``pallas_tail``, ``encoder_fused_blocks``:
    they change the route, not the function)."""
    import torch

    from ..inference import resolve_device
    from ..losses.distillation import DistillationConfig, scheduled_temperature
    from ..models.yolo_distill import YOLOFeatureDistillStudent
    from .checkpoint import load_model_state, save_checkpoint
    from .distill import build_student_teacher
    from .logging import TrainLogger
    from .metrics import binary_miou
    from .state import TrainState
    from .steps import batch_to

    dev = resolve_device(device)
    if tiny:
        image_hw = (64, 64)
        student_variant = teacher_variant = "tiny"
        dec, yolo_dim, hidden = (32, 24, 16, 16, 8), 32, 16
    else:
        dec, yolo_dim, hidden = (256, 128, 64, 32, 16), 1024, 768
    ih, iw = image_hw

    student, teacher = build_student_teacher(
        student_variant, teacher_variant, device=dev, teacher_overrides=teacher_overrides,
        student_cls=YOLOFeatureDistillStudent,
        student_overrides=dict(projection_hidden_dim=hidden, yolo_feature_dim=yolo_dim),
        decoder_channels=dec)
    if teacher_checkpoint:
        teacher.load_state_dict(load_model_state(teacher_checkpoint), strict=True)

    state = TrainState.create(student, yolo_optimizer(student, learning_rate, freeze_encoder))
    kd_cfg = DistillationConfig(initial_temperature=temperature,
                                final_temperature=final_temperature, schedule_type="cosine")
    train_step = make_yolo_train_step(student, teacher, feature_weight, feature_loss_type)

    out_dir = output_dir or "experiments/yolo_feature_distillation"
    logger = TrainLogger(f"{out_dir}/logs", "yolo_feature_distillation")

    if feature_dir:
        batches = npz_feature_batches(feature_dir, batch)
        first = next(batches)
        if first["images"].shape[1:3] != (ih, iw):
            raise ValueError(f"feature files are {first['images'].shape[1:3]}, the model "
                             f"expects {(ih, iw)}: pass matching image sizes or --tiny")
        if first["yolo_features"].shape[-1] != yolo_dim:
            raise ValueError(f"feature files hold {first['yolo_features'].shape[-1]} channels, "
                             f"the projector {yolo_dim}")
        batches = itertools.chain([first], batches)
        vgen = npz_feature_batches(feature_dir, batch, seed=99)
    else:
        batches = synthetic_yolo_batches(batch, (ih, iw), yolo_dim=yolo_dim)
        vgen = synthetic_yolo_batches(batch, (ih, iw), yolo_dim=yolo_dim, seed=99)
    val_batches = [next(vgen) for _ in range(2)]

    def val_miou(vb) -> float:
        student.eval()
        with torch.no_grad():
            vb = batch_to(vb, dev)
            logits = student(vb["images"].float().permute(0, 3, 1, 2))
            return float(binary_miou(logits.permute(0, 2, 3, 1), vb["masks"]))

    best = 0.0
    metrics: Dict[str, float] = {}
    for epoch in range(epochs):
        T = scheduled_temperature(kd_cfg, epoch, epochs)
        t0 = time.perf_counter()
        m = {}
        for _ in range(steps_per_epoch):
            state, m = train_step(state, next(batches), T)
        metrics = {k: float(v) for k, v in m.items()}
        metrics["temperature"] = T
        logger.metrics(epoch, metrics)

        miou = float(np.mean([val_miou(vb) for vb in val_batches]))
        logger.text(f"epoch {epoch}: loss {metrics.get('total_loss', float('nan')):.4f} "
                    f"feat {metrics.get('feature_loss', float('nan')):.4f} T {T:.2f} "
                    f"val mIoU {miou:.4f} "
                    f"({steps_per_epoch * batch / (time.perf_counter() - t0):.1f} img/s)")
        if miou > best:
            best = miou
            save_checkpoint(f"{out_dir}/checkpoints", state, epoch + 1,
                            metadata={"student_miou": best})

    metrics["best_student_miou"] = best
    logger.close()
    return (metrics, state) if return_state else metrics


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--student", default="b0")
    p.add_argument("--teacher", default="b7")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--feature-weight", type=float, default=0.5)
    p.add_argument("--feature-loss", default="mse", choices=["mse", "cosine"])
    p.add_argument("--teacher-checkpoint", default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--feature-dir", default=None,
                   help=".npz files with precomputed YOLO features "
                        "(images/masks/yolo_features per file)")
    args = p.parse_args()
    m = run_yolo_feature_distillation(
        student_variant=args.student, teacher_variant=args.teacher,
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        batch=args.batch, synthetic=args.synthetic, tiny=args.tiny,
        feature_weight=args.feature_weight, feature_loss_type=args.feature_loss,
        teacher_checkpoint=args.teacher_checkpoint, output_dir=args.output_dir,
        device=args.device, feature_dir=args.feature_dir)
    print(json.dumps({k: v for k, v in m.items() if isinstance(v, float)}, indent=2))


if __name__ == "__main__":
    main()
