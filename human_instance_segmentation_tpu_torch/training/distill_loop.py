"""Temperature-progression distillation training CLI.

Counterpart of the JAX package's ``training/distill_loop.py``: B0/B1
student UNets trained from a frozen B7/B3 teacher on full-image binary
person masks, with

- the cosine / linear / exponential temperature schedule (10 -> 1);
- adaptive alpha with permanent elimination once the student beats the
  teacher by 3% (validation mIoU);
- the teacher's validation mIoU computed once, at the first sweep (the
  teacher is frozen);
- progressive encoder unfreezing: at each epoch of ``unfreeze_schedule``
  the optimizer is rebuilt (``optim.distillation_optimizer``, fresh AdamW
  moments and step count, as the JAX loop re-initialises its optax state);
- a checkpoint of the whole state, distillation state included, whenever
  the student's validation mIoU improves, with the JAX loop's metadata.

Usage:
    python -m human_instance_segmentation_tpu_torch.training.distill_loop \\
        --config rgb_hierarchical_unet_v2_distillation_b0_from_b7_temp_prog \\
        --epochs 2 --steps-per-epoch 4 --synthetic [--tiny] [--device cpu] [--resume] \\
        [--devices N] [--config_modifications JSON]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises).
``--devices N`` distils data parallel on N ranks, as ``training.loop``
does (``parallel.launch.spawn``, or ``torchrun``'s ranks): the teacher
whole on every rank, the KD step averaged over the ranks
(``training.distill``), each rank fed its slice of JAX's global batch
(``--tiny``: N, at least 2); the validation mIoU is computed on the whole
held-out batches on every rank (a batch's binary mIoU is not a sum, so it
is not split), and rank 0 alone writes logs and checkpoints.
``run_distillation(teacher_overrides=...)`` passes the teacher's route flags
(``pallas_tail``, ``encoder_fused_blocks``: they change the route, not the
function) to its constructor, as the training loop's ``model_overrides``
do. ``dc.teacher_checkpoint`` names a checkpoint of this package (a
``ckpt_<step>.pt`` file or a directory, its newest).

Deviations from the JAX loop (ROADMAP C12):
- ``--resume`` continues where the uninterrupted run would be: the
  optimizer the checkpoint was written under (the unfreezing of the epochs
  before the resumed one) restored with its moments, the batches already
  taken skipped, and the best student mIoU read from the checkpoint's
  metadata. The JAX loop restores into the epoch-0 optimizer and then
  re-initialises it whenever an unfreeze entry lies at or before the resumed
  epoch (losing the moments of an earlier unfreeze), draws its batches from
  the start again and counts the best mIoU from 0. Like the JAX loop it
  resumes from the newest checkpoint, which is the best student's (a
  checkpoint is written only on improvement);
- the teacher's validation mIoU is computed once; the JAX loop recomputes
  it every epoch and uses the first value only (the values are the same);
- a COCO train set with fewer usable images than one batch raises
  ``ValueError``, as the training loop does (C11); the JAX loop waits
  without end.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

# the tiny run's decoder widths (the JAX loop's --tiny)
TINY_DECODER = (32, 24, 16, 16, 8)
DECODER = (256, 128, 64, 32, 16)


def synthetic_binary_batches(batch: int, image_hw, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Random images with one axis-aligned quarter-size box mask each, the
    JAX loop's draws."""
    rng = np.random.default_rng(seed)
    ih, iw = image_hw
    while True:
        masks = np.zeros((batch, ih, iw, 1), np.float32)
        for b in range(batch):
            x1, y1 = rng.integers(0, iw // 2), rng.integers(0, ih // 2)
            masks[b, y1:y1 + ih // 2, x1:x1 + iw // 2, 0] = 1.0
        yield {"images": rng.random((batch, ih, iw, 3), np.float32), "masks": masks}


def _distillation_rank(rank: int, config_name: str, kwargs: Dict):
    """One rank of a data-parallel :func:`run_distillation` started by it."""
    return run_distillation(config_name, **kwargs)


def run_distillation(
    config_name: str = "rgb_hierarchical_unet_v2_distillation_b0_from_b7_temp_prog",
    epochs: Optional[int] = None,
    steps_per_epoch: int = 0,
    synthetic: bool = False,
    tiny: bool = False,
    devices: Optional[int] = None,
    output_dir: Optional[str] = None,
    resume: bool = False,
    device: str = "cuda",
    config_modifications: Optional[Dict] = None,
    teacher_overrides: Optional[Dict] = None,
    return_state: bool = False,
):
    """Distil ``config_name``'s student from its teacher; returns the last
    epoch's train metrics with ``best_student_miou``, ``teacher_miou`` and
    ``eliminated`` (and the final :class:`TrainState` with
    ``return_state``). ``devices`` > 1 distils data parallel (module
    docstring); a run that starts its own ranks returns rank 0's metrics."""
    import torch

    from ..config import ConfigManager, _as_hw, _deep_merge
    from ..inference import resolve_device
    from ..losses.distillation import DistillationConfig, DistillationState
    from .checkpoint import latest_step, load_model_state, restore_checkpoint, save_checkpoint
    from .distill import build_student_teacher, epoch_update, make_distill_train_step, unet_logits
    from ..parallel import launch
    from ..parallel.mesh import mesh_device, rank_of, replicate, shard_batch
    from .logging import NullLogger, TrainLogger
    from .metrics import binary_miou
    from .optim import Transform, build_schedule, distillation_optimizer
    from .state import TrainState
    from .steps import batch_to

    mesh = None
    if devices and devices > 1:
        launch.check_devices(devices, device)
        if launch.should_spawn(devices):
            if return_state:
                raise ValueError("a run that starts its own ranks cannot return its state")
            kwargs = dict(epochs=epochs, steps_per_epoch=steps_per_epoch, synthetic=synthetic,
                          tiny=tiny, devices=devices, output_dir=output_dir, resume=resume,
                          device=device, config_modifications=config_modifications,
                          teacher_overrides=teacher_overrides)
            return launch.spawn(_distillation_rank, devices, (config_name, kwargs),
                                device=device)[0]
        mesh = launch.join_mesh(devices, device)
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)
    lead = rank_of(mesh) == 0  # the rank that writes

    cfg = ConfigManager.get_config(config_name)
    if config_modifications:
        cfg = _deep_merge(cfg, config_modifications)
    dc = cfg.distillation
    kd_cfg = DistillationConfig(
        initial_temperature=(dc.initial_temperature if dc.use_temperature_scheduling
                             else dc.temperature),
        final_temperature=dc.final_temperature,
        schedule_type=dc.temperature_schedule,
        initial_alpha=dc.alpha,
        initial_task_weight=dc.task_weight,
        adaptive_distillation=dc.adaptive_distillation,
        amplification_factor=dc.amplification_factor,
        min_alpha=dc.min_alpha,
        zero_distillation_threshold=dc.zero_distillation_threshold,
    )

    ih, iw = (64, 64) if tiny else _as_hw(cfg.model.image_size)
    batch = max(devices or 1, 2) if tiny else cfg.training.batch_size
    if mesh is not None and batch % devices:
        raise ValueError(f"batch size {batch} does not divide {devices} devices")
    n_epochs = epochs if epochs is not None else cfg.training.num_epochs
    spe = steps_per_epoch or (10 if synthetic else 1000)

    student, teacher = build_student_teacher(
        "tiny" if tiny else dc.student_encoder, "tiny" if tiny else dc.teacher_encoder,
        device=dev, teacher_overrides=teacher_overrides,
        decoder_channels=TINY_DECODER if tiny else DECODER)
    if dc.teacher_checkpoint:
        teacher.load_state_dict(load_model_state(dc.teacher_checkpoint), strict=True)
    if mesh is not None:
        replicate(mesh, student)
        replicate(mesh, teacher)

    out_dir = output_dir or f"{cfg.output_dir}/{cfg.name}"
    logger = TrainLogger(f"{out_dir}/logs", cfg.name) if lead else NullLogger()
    logger.config(cfg.to_dict())

    if synthetic:
        batches = synthetic_binary_batches(batch, (ih, iw))
        # held-out batches from a distinct seed stand in for the val set
        val_gen = synthetic_binary_batches(batch, (ih, iw), seed=1234)
        val_batches = [next(val_gen) for _ in range(2)]
    else:
        from ..data import COCOPersonBinaryDataset, batch_iterator

        ds = COCOPersonBinaryDataset(cfg.data.train_annotation, cfg.data.train_img_dir,
                                     image_size=(ih, iw))
        if len(ds) < batch:
            raise ValueError(f"{cfg.data.train_annotation}: {len(ds)} usable images, fewer "
                             f"than one batch of {batch}")
        spe = len(ds) // batch
        val_ds = COCOPersonBinaryDataset(cfg.data.val_annotation, cfg.data.val_img_dir,
                                         image_size=(ih, iw))
        val_batches = list(batch_iterator(val_ds, batch, shuffle=False, drop_last=True))

    schedule = build_schedule(cfg.training.learning_rate, n_epochs, spe,
                              cfg.training.scheduler, cfg.training.min_lr)

    def optimizer_for(num_unfrozen: int):
        if dc.progressive_unfreeze:
            return distillation_optimizer(
                student, schedule, num_unfrozen, encoder_lr_scale=dc.unfreeze_encoder_lr_scale,
                weight_decay=cfg.training.weight_decay, gradient_clip=cfg.training.gradient_clip)
        return Transform("adamw", schedule, cfg.training.weight_decay,
                         cfg.training.gradient_clip).init(student)

    ckpt_dir = f"{out_dir}/checkpoints"
    saved = latest_step(ckpt_dir) if resume else None
    start_epoch = saved or 0
    # the unfreezing the checkpoint was written under: the entries of the
    # epochs before the resumed one (the loop applies the resumed epoch's)
    past = [v for e, v in dc.unfreeze_schedule.items() if e < start_epoch]
    num_unfrozen = max(past) if dc.progressive_unfreeze and past else 0
    state = TrainState.create(
        student, optimizer_for(num_unfrozen), seed=1,
        distill_state=DistillationState.create(
            temperature=kd_cfg.initial_temperature, alpha=kd_cfg.initial_alpha,
            task_weight=kd_cfg.initial_task_weight))
    best_student = 0.0
    if saved is not None:
        state, _ = restore_checkpoint(ckpt_dir, state)
        meta_path = Path(ckpt_dir) / f"metadata_{saved}.json"
        if meta_path.exists():
            best_student = float(json.loads(meta_path.read_text())["student_miou"])
        logger.text(f"resumed from epoch {saved} ({num_unfrozen} encoder stages unfrozen)")

    if synthetic:
        for _ in range(start_epoch * spe):  # the batches the resumed epochs have taken
            next(batches)
    else:
        def forever(first_epoch: int):
            for e in itertools.count(first_epoch):
                yield from batch_iterator(ds, batch, shuffle=True, seed=e)

        batches = forever(start_epoch)
        if not val_batches:  # val set smaller than one batch: the first train batch
            val_batches = [next(batches)]

    train_step = make_distill_train_step(student, teacher, kd_cfg,
                                         compute_dtype=cfg.training.compute_dtype, mesh=mesh)

    def val_miou(model, vb) -> float:
        model.eval()
        with torch.no_grad():
            vb = batch_to(vb, dev)
            return float(binary_miou(unet_logits(model, vb["images"].float()), vb["masks"]))

    teacher_miou_cache: Optional[float] = None
    metrics: Dict[str, float] = {}
    for epoch in range(start_epoch, n_epochs):
        # schedule transitions (temperature; progressive unfreezing)
        state = epoch_update(state, kd_cfg, epoch, n_epochs)
        if dc.progressive_unfreeze and epoch in dc.unfreeze_schedule:
            num_unfrozen = dc.unfreeze_schedule[epoch]
            state.optimizer = optimizer_for(num_unfrozen)
            logger.text(f"epoch {epoch}: unfroze last {num_unfrozen} encoder stages")

        t0 = time.perf_counter()
        m = {}
        for _ in range(spe):
            host_batch = next(batches)
            state, m = train_step(state, host_batch if mesh is None
                                  else shard_batch(mesh, host_batch))
        metrics = {k: float(v) for k, v in m.items()}
        logger.metrics(epoch, metrics)

        # validation over the whole held-out set: elimination is permanent,
        # so it is driven by the sweep's mean mIoU, never one train batch
        s_iou = sum(val_miou(student, vb) for vb in val_batches) / len(val_batches)
        if teacher_miou_cache is None:
            teacher_miou_cache = sum(val_miou(teacher, vb) for vb in val_batches) / len(
                val_batches)
        state = epoch_update(state, kd_cfg, epoch, n_epochs, student_iou=s_iou,
                             teacher_iou=teacher_miou_cache)
        logger.text(
            f"epoch {epoch}: loss {metrics.get('total_loss', float('nan')):.4f} "
            f"T {metrics.get('temperature', 0):.2f} alpha {float(state.distill_state.alpha):.3f} "
            f"student mIoU {s_iou:.4f} teacher {teacher_miou_cache:.4f} "
            f"({spe * batch / (time.perf_counter() - t0):.1f} img/s)")

        if s_iou > best_student:
            best_student = s_iou
            if lead:
                save_checkpoint(ckpt_dir, state, epoch + 1,
                                metadata={"student_miou": best_student,
                                          "teacher_miou": teacher_miou_cache,
                                          "num_unfrozen": num_unfrozen})
            logger.text(f"new best student mIoU {best_student:.4f} (checkpointed)")

    metrics["best_student_miou"] = best_student
    metrics["teacher_miou"] = teacher_miou_cache or 0.0
    metrics["eliminated"] = float(bool(state.distill_state.eliminated))
    logger.close()
    return (metrics, state) if return_state else metrics


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="rgb_hierarchical_unet_v2_distillation_b0_from_b7_temp_prog")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config_modifications", default=None,
                   help="JSON deep-merged into the named config")
    args = p.parse_args()
    mods = json.loads(args.config_modifications) if args.config_modifications else None
    m = run_distillation(args.config, args.epochs, args.steps_per_epoch, args.synthetic,
                         args.tiny, args.devices, args.output_dir, args.resume, args.device,
                         config_modifications=mods)
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:  # torchrun's ranks: rank 0 reports
        print(json.dumps({k: v for k, v in m.items() if isinstance(v, float)}, indent=2))


if __name__ == "__main__":
    main()
