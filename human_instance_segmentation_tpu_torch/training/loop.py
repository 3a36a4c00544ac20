"""Training CLI: config lookup -> model -> schedule and optimizer -> the step
loop with periodic validation, curated renders, best-mIoU checkpoints and
early stopping.

Counterpart of the JAX package's ``training/loop.py``:

    python -m human_instance_segmentation_tpu_torch.training.loop \\
        --config rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_r64x48m128x96_disttrans_contdet_baware_from_b0 \\
        [--synthetic] [--steps N | --epochs N] [--tiny] [--device cpu] [--resume] \\
        [--devices N] [--config_modifications JSON]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises).

``--devices N`` trains data parallel on N ranks, one device a rank
(``training.steps`` with a ``parallel`` mesh): started by the loop itself
(``parallel.launch.spawn``: Gloo on ``--device cpu``, NCCL on CUDA, rank
0's result returned), or, under ``torchrun --nproc_per_node N`` (where
``WORLD_SIZE`` is set), as the launcher's rank, ``WORLD_SIZE`` equal to N.
N CUDA ranks need N cards (``ValueError`` otherwise). The global batch is
JAX's (``--tiny`` sets it to N) and each rank feeds its ``shard_batch``
slice of it; validation sums over the ranks. Rank 0 alone writes logs,
checkpoints and pictures; a resumed run restores every rank from rank 0's
checkpoint.

Without ``--synthetic`` it trains on a COCO tree, as the JAX loop does: the
person annotations and images that ``data.train_annotation`` /
``data.train_img_dir`` name (set them with ``--config_modifications
'{"data": {...}}'``; ``python -m human_instance_segmentation_tpu_torch.data.synthetic``
writes a tree to try it on), augmented as ``data.use_augmentation`` and
``data.use_heavy_augmentation`` say, fed by ``data.ThreadedLoader`` with
``data.num_workers`` threads, an epoch being ``len(dataset) // batch_size``
steps (the schedule spans that length). Validation runs over the whole val
set (``data.val_annotation``, padded batches) at every ``validate_every``
epochs and at the end, and renders the curated scenes each time: the first
val images with 1, 2, 3 and 5 instances, drawn by ``visualize.validation_grid``
and ``visualize.auxiliary_report`` into
``visualizations/epoch{e:04d}_{label}.png`` and ``..._aux.png``, the
reference's visual-regression tool. ``--synthetic`` trains on generated
batches, with two fixed held-out synthetic batches as the validation set
and no curated scenes. Both end with ``visualizations/val_step{n}.png``
of the last train batch's first image. A render that fails is logged and
never ends the run.

Kept from the JAX loop: staged freezing (``training.stage_schedule``),
progressive loss features (``training.feature_schedule``, the step rebuilt
at each activation epoch), best-mIoU checkpoints, early stopping and
``--resume``.

``--tiny`` narrows the model as the JAX loop does: the shapes of every
family, and :data:`TINY_MODEL`'s widths for the full-image flagship family
only (the JAX loop clones the models that have ``mid_channels``; the
pure-RGB and ROI-pretrained models keep their widths).

Deviations from the JAX loop:
- ``--resume`` continues at the restored step and runs up to ``--steps``
  in all; the JAX loop counts ``--steps`` anew after a restore (ROADMAP
  C7). On COCO data the loader starts at the restored step's epoch and
  skips the batches of it already taken;
- with a ``stage_schedule``, ``--resume`` first applies the stage the
  checkpoint was written under (the latest one whose epoch is at or below
  the epoch of the checkpoint's last step), so the optimizer has the
  checkpoint's parameter groups, and the run goes on as the uninterrupted
  run does; the JAX loop restores into a one-group optimizer and fails
  (ROADMAP C8);
- a curated scene's aux panels get the per-ROI aux maps only; the JAX loop
  hands over the full-image logits too, and ``auxiliary_report`` then fails
  on the second ROI of a model with a full-image stage 1 (ROADMAP C10);
- a COCO train set with fewer usable images than one batch raises
  ``ValueError``; the JAX loop takes ``max(len(ds) // batch_size, 1)``
  steps an epoch, and its loader, which drops the last partial batch,
  then yields no batch, so its ``forever()`` waits without end (ROADMAP
  C11).
- a config that builds the baseline ``ROISegmentationModel`` (``baseline``,
  ``..._distillation_b0_from_b3_yolo``) raises ``ValueError`` before the
  first step: its aux holds only ``features`` and the hierarchical loss
  reads ``aux["bg_fg_logits"]``, so the JAX loop fails with ``KeyError`` at
  its first step (ROADMAP C15). The multi-scale RGB and variable-ROI
  models train as the flagship does.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# the tiny run's shapes (the JAX loop's --tiny)
TINY_MODEL = dict(mid_channels=32, feature_dim=32, unet_decoder_channels=(32, 24, 16, 16, 8))


def synthetic_batches(batch: int, k: int, image_hw, mask_hw,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    ih, iw = image_hw
    mh, mw = mask_hw
    while True:
        yield {
            "images": rng.random((batch, ih, iw, 3), np.float32),
            "boxes": np.tile(np.asarray([[0.2, 0.2, 0.8, 0.8]], np.float32), (batch, k, 1))
            + rng.uniform(-0.05, 0.05, (batch, k, 4)).astype(np.float32),
            "masks": rng.integers(0, 3, (batch, k, mh, mw)).astype(np.int32),
            "valid": np.ones((batch, k), np.float32),
        }


def validation_sums(eval_step, batches) -> Dict[str, float]:
    """The eval step's sums over ``batches``, added on the host."""
    sums = None
    for vb in batches:
        m = {k: float(v) for k, v in eval_step(vb).items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    return sums


def curated_scenes(samples, wanted=(1, 2, 3, 5)) -> List[Tuple[str, int]]:
    """``[(label, index)]`` of the first val sample with each wanted instance
    count (``samples``: the dataset's ``(image_id, ann_ids)`` list), as the
    JAX loop selects them."""
    found: Dict[int, int] = {}
    for si, (_, ann_ids) in enumerate(samples):
        c = len(ann_ids)
        if c in wanted and c not in found:
            found[c] = si
        if len(found) == len(wanted):
            break
    return [(f"{c}person", idx) for c, idx in sorted(found.items())]


def render_sample(model, image: np.ndarray, boxes: np.ndarray, gt_masks: np.ndarray,
                  path: str, aux_path: Optional[str] = None) -> None:
    """Write ``visualize.validation_grid`` of one sample (image (H, W, 3),
    boxes (K, 4), gt masks (K, mh, mw)) to ``path`` and, with ``aux_path``,
    ``visualize.auxiliary_report`` of its ROIs: the model's eval forward in
    float32 (``steps.eval_forward``), its outputs moved to the host."""
    import torch

    from ..visualize import auxiliary_report, save_image, validation_grid
    from .steps import eval_forward

    dev = next(model.parameters()).device
    logits, aux = eval_forward(model, torch.as_tensor(image[None]).to(dev),
                               torch.as_tensor(boxes[None]).to(dev))
    logits_np = logits.cpu().numpy()
    binary = None
    if "full_image_logits" in aux:
        binary = torch.softmax(aux["full_image_logits"], dim=-1)[0, ..., 0:1].cpu().numpy()
    save_image(path, validation_grid(image, gt_masks, logits_np, boxes, binary_mask=binary))
    if aux_path is None:
        return
    ih, iw = image.shape[:2]
    crops = []
    for box in boxes:
        x1, y1 = int(box[0] * iw), int(box[1] * ih)
        x2 = max(int(box[2] * iw), x1 + 2)
        y2 = max(int(box[3] * ih), y1 + 2)
        crops.append(image[max(y1, 0):y2, max(x1, 0):x2])
    hmax = max(c.shape[0] for c in crops)
    wmax = max(c.shape[1] for c in crops)
    crops = np.stack([np.pad(c, ((0, hmax - c.shape[0]), (0, wmax - c.shape[1]), (0, 0)))
                      for c in crops])
    # the per-ROI maps only (C10): a full-image map has the batch's length
    per_roi = {k: v.cpu().numpy() for k, v in aux.items() if v.shape[0] == logits.shape[0]}
    auxiliary_report(crops, logits_np, per_roi, aux_path, gt_masks=gt_masks)


def _training_rank(rank: int, config_name: str, kwargs: Dict):
    """One rank of a data-parallel :func:`run_training` started by it."""
    return run_training(config_name, **kwargs)


def run_training(
    config_name: str,
    steps: int = 0,
    epochs: Optional[int] = None,
    synthetic: bool = False,
    devices: Optional[int] = None,
    tiny: bool = False,
    output_dir: Optional[str] = None,
    resume: bool = False,
    device: str = "cuda",
    config_modifications: Optional[Dict] = None,
    model_overrides: Optional[Dict] = None,
    return_state: bool = False,
    steps_per_epoch: int = 100,
):
    """Train ``config_name``; returns the last metrics (and the final
    :class:`TrainState` with ``return_state``). ``model_overrides`` go to
    :func:`..config.model_from_config` (for example ``pallas_tail`` and
    ``encoder_fused_blocks``, which change the route, not the function).
    ``steps_per_epoch`` is the synthetic epoch's length (100, the JAX
    loop's); on COCO data an epoch is ``len(dataset) // batch_size``
    steps. ``devices`` > 1 trains data parallel (module docstring); a run
    that starts its own ranks returns rank 0's metrics and cannot return
    its state."""
    import torch

    from ..config import (ConfigManager, _as_hw, _deep_merge, loss_config_from_experiment,
                          model_from_config)
    from ..inference import resolve_device
    from ..models.baseline import ROISegmentationModel
    from ..parallel import launch
    from ..parallel.mesh import mesh_device, rank_of, replicate, shard_batch
    from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from .logging import NullLogger, TrainLogger
    from .optim import (StageConfig, Transform, build_optimizer, build_schedule, set_to_zero,
                        stage_rules, staged_optimizer)
    from .progressive import activation_epochs, active_features, gate_config
    from .state import TrainState
    from .steps import make_eval_step, make_train_step

    mesh = None
    if devices and devices > 1:
        launch.check_devices(devices, device)
        if launch.should_spawn(devices):
            if return_state:
                raise ValueError("a run that starts its own ranks cannot return its state")
            kwargs = dict(steps=steps, epochs=epochs, synthetic=synthetic, devices=devices,
                          tiny=tiny, output_dir=output_dir, resume=resume, device=device,
                          config_modifications=config_modifications,
                          model_overrides=model_overrides, steps_per_epoch=steps_per_epoch)
            return launch.spawn(_training_rank, devices, (config_name, kwargs), device=device)[0]
        mesh = launch.join_mesh(devices, device)
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(device)
    lead = rank_of(mesh) == 0  # the rank that writes

    cfg = ConfigManager.get_config(config_name)
    if config_modifications:
        cfg = _deep_merge(cfg, config_modifications)
    overrides = dict(model_overrides or {})
    if tiny:
        cfg.model.image_size = (64, 64)
        cfg.model.roi_size = (16, 12)
        cfg.model.mask_size = (32, 24)
        cfg.model.encoder_name = "tiny"
        cfg.model.hierarchical_base_channels = 16
        cfg.model.hierarchical_depth = 2
        cfg.training.batch_size = max(devices or 1, 1)
        cfg.data.rois_per_image = 2
        if cfg.model.use_pretrained_unet and cfg.model.use_full_image_unet:
            overrides = {**TINY_MODEL, **overrides}

    model = model_from_config(cfg, seed=0, device=dev, **overrides)
    if mesh is not None:
        replicate(mesh, model)
    if isinstance(model, ROISegmentationModel):  # ROADMAP C15
        raise ValueError(
            f"config {cfg.name!r} builds the baseline ROISegmentationModel, whose aux holds "
            "only 'features', and the hierarchical loss reads aux['bg_fg_logits']: it cannot "
            "train with this loop (the JAX loop fails with KeyError at its first step)")

    ih, iw = _as_hw(cfg.model.image_size)
    mh, mw = _as_hw(cfg.model.mask_size)
    k = cfg.data.rois_per_image
    batch_size = cfg.training.batch_size

    out_dir = output_dir or f"{cfg.output_dir}/{cfg.name}"
    logger = TrainLogger(f"{out_dir}/logs", cfg.name) if lead else NullLogger()
    logger.config(cfg.to_dict())

    n_epochs = epochs if epochs is not None else cfg.training.num_epochs
    # real data defines the epoch, before the schedule, so that its decay
    # spans the true training length (the JAX loop's order)
    if not synthetic:
        from ..data import COCOInstanceSegmentationDataset, DatasetConfig
        from ..data.augment import AugmentConfig

        ds_cfg = DatasetConfig(image_size=(ih, iw), mask_size=(mh, mw), rois_per_image=k,
                               roi_padding=cfg.data.roi_padding)
        ds = COCOInstanceSegmentationDataset(
            cfg.data.train_annotation, cfg.data.train_img_dir, ds_cfg,
            augment=AugmentConfig(heavy=cfg.data.use_heavy_augmentation)
            if cfg.data.use_augmentation else None)
        if len(ds) < batch_size:
            raise ValueError(f"{cfg.data.train_annotation}: {len(ds)} usable images, fewer "
                             f"than one batch of {batch_size}")
        steps_per_epoch = len(ds) // batch_size
    if mesh is not None and batch_size % devices:
        raise ValueError(f"batch size {batch_size} does not divide {devices} devices")
    total_steps = steps if steps > 0 else n_epochs * steps_per_epoch

    t = cfg.training
    schedule = build_schedule(t.learning_rate, n_epochs, steps_per_epoch, t.scheduler,
                              t.min_lr, t.warmup_epochs)
    tx = build_optimizer(schedule, t.optimizer, t.weight_decay, t.gradient_clip)
    state = TrainState.create(model, tx, seed=1)

    # staged freezing: at configured epoch boundaries the parameter groups
    # are relabelled and the optimizer rebuilt (moments reset), its schedule
    # offset by the global step so the decay continues
    stage_schedule = dict(t.stage_schedule or {})

    def apply_stage(epoch: int) -> None:
        flags = stage_schedule[epoch]
        stage = StageConfig(
            name=f"epoch{epoch}",
            freeze_pretrained=bool(flags.get("freeze_pretrained", True)),
            freeze_rgb_extractor=bool(flags.get("freeze_rgb_extractor", False)),
            freeze_head=bool(flags.get("freeze_head", False)),
            lr_scale=float(flags.get("lr_scale", 1.0)),
        )
        step_at_switch = epoch * steps_per_epoch
        scaled = Transform("adamw", lambda s: schedule(s + step_at_switch) * stage.lr_scale,
                           weight_decay=t.weight_decay, clip=t.gradient_clip)
        state.optimizer = staged_optimizer({"train": scaled, "frozen": set_to_zero()}, model,
                                           stage_rules(stage))
        logger.text(f"stage change at epoch {epoch}: {flags}")

    ckpt_dir = f"{out_dir}/checkpoints"
    start = 0
    saved = latest_step(ckpt_dir) if resume else None
    if saved is not None:
        # the stage the checkpoint was written under: its last step's epoch
        # (C8); the loop applies later stages at their boundaries as usual
        written_under = [e for e in stage_schedule if saved > 0 and e <= (saved - 1) //
                         steps_per_epoch]
        if written_under:
            apply_stage(max(written_under))
        state, start = restore_checkpoint(ckpt_dir, state)
        logger.text(f"resumed from step {start}")

    # the loss follows the config; with a feature_schedule, scheduled loss
    # features start off and switch on at their activation epoch
    feature_schedule = dict(t.feature_schedule or {})

    def loss_cfg_for(epoch: int):
        if not feature_schedule:
            return loss_config_from_experiment(cfg)
        return loss_config_from_experiment(gate_config(cfg, feature_schedule, epoch))

    loss_cfg = loss_cfg_for(start // steps_per_epoch)
    feature_epochs = set(activation_epochs(feature_schedule)) - {0}
    compute_dtype = t.compute_dtype
    train_step = make_train_step(model, loss_cfg, compute_dtype, mesh)
    mesh_eval = make_eval_step(model, mesh)

    def eval_step(vb):
        return mesh_eval(shard_batch(mesh, vb) if mesh is not None else vb)

    curated: List[Tuple[str, int]] = []
    if synthetic:
        batches = synthetic_batches(batch_size, k, (ih, iw), (mh, mw))
        for _ in range(start):  # a resumed run sees the batches it has not seen yet
            next(batches)
        # fixed held-out batches (a distinct seed) stand in for the val set
        val_gen = synthetic_batches(batch_size, k, (ih, iw), (mh, mw), seed=1234)
        val_fixed = [next(val_gen) for _ in range(2)]

        def val_iter():
            return iter(val_fixed)
    else:
        from ..data import padded_batch_iterator
        from ..data.loader import ThreadedLoader

        loader = ThreadedLoader(ds, batch_size, num_workers=cfg.data.num_workers, shuffle=True,
                                prefetch=cfg.data.prefetch)
        def coco_batches(first_epoch: int):
            # ``loader.forever()`` from the epoch of the restored step
            for e in itertools.count(first_epoch):
                yield from loader.epoch(e)

        batches = coco_batches(start // steps_per_epoch)
        for _ in range(start % steps_per_epoch):  # the batches a resumed run has taken
            next(batches)
        val_ds = COCOInstanceSegmentationDataset(cfg.data.val_annotation, cfg.data.val_img_dir,
                                                 ds_cfg)

        def val_iter():
            return padded_batch_iterator(val_ds, batch_size)

        curated = curated_scenes(val_ds.samples)
        if curated:
            logger.text("curated validation scenes: "
                        + ", ".join(f"{lab}=val[{idx}]" for lab, idx in curated))

    def render_curated(epoch: int) -> None:
        if not lead:
            return
        try:
            for label, idx in curated:
                s = val_ds[idx]
                stem = f"{out_dir}/visualizations/epoch{epoch:04d}_{label}"
                render_sample(model, s["image"], s["boxes"], s["masks"], f"{stem}.png",
                              f"{stem}_aux.png")
        except Exception as e:  # a render never ends a run
            logger.text(f"curated visualization skipped: {e!r}")

    def validation_sweep() -> Dict[str, float]:
        """Target mIoU and detection rates over the val set."""
        sums = validation_sums(eval_step, val_iter())
        n = max(sums["n"], 1.0)
        return {"val_miou": sums["iou_sum"] / n, "val_det50": sums["det50_sum"] / n,
                "val_det70": sums["det70_sum"] / n, "val_n": n}

    best_dir = f"{out_dir}/checkpoints_best"
    best_miou = -1.0
    epochs_since_best = 0
    patience = t.early_stopping_patience

    last_metrics: Dict[str, float] = {}
    t0 = time.perf_counter()
    i = start
    stopped_early = False
    host_batch = None
    while i < total_steps and not stopped_early:
        epoch = i // steps_per_epoch
        if i % steps_per_epoch == 0 and epoch in stage_schedule:
            apply_stage(epoch)
        if i % steps_per_epoch == 0 and epoch in feature_epochs:
            loss_cfg = loss_cfg_for(epoch)
            train_step = make_train_step(model, loss_cfg, compute_dtype, mesh)
            logger.text(f"progressive activation at epoch {epoch}: "
                        f"{active_features(feature_schedule, epoch)} active")
        host_batch = next(batches)
        state, metrics = train_step(state, host_batch if mesh is None
                                    else shard_batch(mesh, host_batch))
        if i % 20 == 0 or i == total_steps - 1:
            last_metrics = {k2: float(v) for k2, v in metrics.items()}
            dt = time.perf_counter() - t0
            logger.metrics(i, last_metrics)
            logger.text(f"step {i}: loss {last_metrics.get('total_loss', float('nan')):.4f} "
                        f"({(i + 1 - start) * batch_size / dt:.1f} img/s)")
        if lead and t.save_every and (i + 1) % (t.save_every * steps_per_epoch) == 0:
            save_checkpoint(ckpt_dir, state, i + 1)
            logger.text(f"checkpoint at step {i + 1}")

        # epoch boundary: held-out validation, best-mIoU checkpoint, early stop
        i += 1
        at_epoch_end = i % steps_per_epoch == 0
        finished = i == total_steps
        if (at_epoch_end and (epoch + 1) % max(t.validate_every, 1) == 0) or finished:
            vm = validation_sweep()
            render_curated(epoch)
            last_metrics.update(vm)
            logger.metrics(i, vm)
            logger.text(f"epoch {epoch}: val mIoU {vm['val_miou']:.4f} "
                        f"det@0.5 {vm['val_det50']:.4f} (n={vm['val_n']:.0f})")
            if vm["val_miou"] > best_miou:
                best_miou = vm["val_miou"]
                epochs_since_best = 0
                if lead:
                    save_checkpoint(best_dir, state, i,
                                    metadata={"val_miou": best_miou, "epoch": epoch})
                logger.text(f"new best val mIoU {best_miou:.4f} (checkpointed)")
            elif at_epoch_end:
                epochs_since_best += 1
                if patience and epochs_since_best >= patience:
                    logger.text(f"early stop: no val improvement for {patience} epochs")
                    stopped_early = True

    last_metrics["eval_miou"] = last_metrics.get("val_miou", 0.0)
    last_metrics["best_val_miou"] = best_miou
    last_metrics["skipped"] = float(state.skipped)
    batches.close()  # stops the loader's threads
    if lead:
        try:  # the last train batch's first image
            if host_batch is None:
                raise ValueError("no step ran")
            render_sample(model, np.asarray(host_batch["images"][0]),
                          np.asarray(host_batch["boxes"][0]), np.asarray(host_batch["masks"][0]),
                          f"{out_dir}/visualizations/val_step{i}.png")
        except Exception as e:  # a render never ends a run
            logger.text(f"visualization skipped: {e!r}")
        save_checkpoint(ckpt_dir, state, i)
    logger.text(f"done: {i} steps, final loss {last_metrics.get('total_loss', float('nan')):.4f}, "
                f"eval mIoU {last_metrics['eval_miou']:.4f}")
    logger.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (last_metrics, state) if return_state else last_metrics


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_"
                                        "r64x48m64x48_disttrans_contdet_baware")
    p.add_argument("--steps", type=int, default=0, help="total steps (overrides epochs)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel ranks, one device each (spawned, or torchrun's)")
    p.add_argument("--tiny", action="store_true", help="tiny shapes for smoke tests")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config_modifications", default=None,
                   help='JSON deep-merged into the named config, e.g. '
                        '\'{"training": {"learning_rate": 1e-4}}\'')
    args = p.parse_args()
    mods = json.loads(args.config_modifications) if args.config_modifications else None
    run_training(args.config, steps=args.steps, epochs=args.epochs, synthetic=args.synthetic,
                 devices=args.devices, tiny=args.tiny, output_dir=args.output_dir,
                 resume=args.resume, device=args.device, config_modifications=mods)


if __name__ == "__main__":
    main()
