"""Training CLI: config lookup -> model -> schedule and optimizer -> the step
loop with periodic validation, best-mIoU checkpoints and early stopping.

Counterpart of the JAX package's ``training/loop.py`` on one device:

    python -m human_instance_segmentation_tpu_torch.training.loop \\
        --config rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_r64x48m128x96_disttrans_contdet_baware_from_b0 \\
        --steps 2 --synthetic [--tiny] [--device cpu] [--resume] \\
        [--config_modifications JSON]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises).
``--synthetic`` trains on generated batches, with two fixed held-out
synthetic batches as the validation set. Kept from the JAX loop: staged
freezing (``training.stage_schedule``), progressive loss features
(``training.feature_schedule``, the step rebuilt at each activation
epoch), validation at every ``validate_every`` epochs and at the end,
best-mIoU checkpoints, early stopping and ``--resume``. Not ported yet,
and refused with ``NotImplementedError``: more than one device (ROADMAP
A9), real COCO data (A4) and so its curated validation scenes; the
end-of-run validation picture is skipped with a log line, as the JAX loop
does when ``visualize`` fails (``visualize`` is A4).

``--tiny`` narrows the model as the JAX loop does: the shapes of every
family, and :data:`TINY_MODEL`'s widths for the full-image flagship family
only (the JAX loop clones the models that have ``mid_channels``; the
pure-RGB and ROI-pretrained models keep their widths).

Two deviations, both about ``--resume``:
- it continues at the restored step and runs up to ``--steps`` in all; the
  JAX loop counts ``--steps`` anew after a restore (ROADMAP C7);
- with a ``stage_schedule`` it first applies the stage the checkpoint was
  written under (the latest one whose epoch is at or below the epoch of
  the checkpoint's last step), so the optimizer has the checkpoint's
  parameter groups, and the run goes on as the uninterrupted run does;
  the JAX loop, like the port before this repair, restores into a
  one-group optimizer and fails (ROADMAP C8).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, Optional

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
    loop's)."""
    import torch

    from ..config import (ConfigManager, _as_hw, _deep_merge, loss_config_from_experiment,
                          model_from_config)
    from ..inference import resolve_device
    from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from .logging import TrainLogger
    from .optim import (StageConfig, Transform, build_optimizer, build_schedule, set_to_zero,
                        stage_rules, staged_optimizer)
    from .progressive import activation_epochs, active_features, gate_config
    from .state import TrainState
    from .steps import make_eval_step, make_train_step

    if devices and devices > 1:
        raise NotImplementedError("training on more than one device is not ported yet "
                                  "(ROADMAP A9)")
    if not synthetic:
        raise NotImplementedError("training on COCO data is not ported yet (ROADMAP A4: the "
                                  "data pipeline and visualize); pass --synthetic")
    dev = resolve_device(device)

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

    ih, iw = _as_hw(cfg.model.image_size)
    mh, mw = _as_hw(cfg.model.mask_size)
    k = cfg.data.rois_per_image
    batch_size = cfg.training.batch_size

    out_dir = output_dir or f"{cfg.output_dir}/{cfg.name}"
    logger = TrainLogger(f"{out_dir}/logs", cfg.name)
    logger.config(cfg.to_dict())

    n_epochs = epochs if epochs is not None else cfg.training.num_epochs
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
    train_step = make_train_step(model, loss_cfg, compute_dtype)
    eval_step = make_eval_step(model)

    batches = synthetic_batches(batch_size, k, (ih, iw), (mh, mw))
    for _ in range(start):  # a resumed run sees the batches it has not seen yet
        next(batches)
    # fixed held-out batches (a distinct seed) stand in for the val set
    val_gen = synthetic_batches(batch_size, k, (ih, iw), (mh, mw), seed=1234)
    val_fixed = [next(val_gen) for _ in range(2)]

    def validation_sweep() -> Dict[str, float]:
        """Target mIoU and detection rates over the held-out batches."""
        sums = None
        for vb in val_fixed:
            m = {k2: float(v) for k2, v in eval_step(vb).items()}
            sums = m if sums is None else {k2: sums[k2] + m[k2] for k2 in sums}
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
    while i < total_steps and not stopped_early:
        epoch = i // steps_per_epoch
        if i % steps_per_epoch == 0 and epoch in stage_schedule:
            apply_stage(epoch)
        if i % steps_per_epoch == 0 and epoch in feature_epochs:
            loss_cfg = loss_cfg_for(epoch)
            train_step = make_train_step(model, loss_cfg, compute_dtype)
            logger.text(f"progressive activation at epoch {epoch}: "
                        f"{active_features(feature_schedule, epoch)} active")
        state, metrics = train_step(state, next(batches))
        if i % 20 == 0 or i == total_steps - 1:
            last_metrics = {k2: float(v) for k2, v in metrics.items()}
            dt = time.perf_counter() - t0
            logger.metrics(i, last_metrics)
            logger.text(f"step {i}: loss {last_metrics.get('total_loss', float('nan')):.4f} "
                        f"({(i + 1 - start) * batch_size / dt:.1f} img/s)")
        if t.save_every and (i + 1) % (t.save_every * steps_per_epoch) == 0:
            save_checkpoint(ckpt_dir, state, i + 1)
            logger.text(f"checkpoint at step {i + 1}")

        # epoch boundary: held-out validation, best-mIoU checkpoint, early stop
        i += 1
        at_epoch_end = i % steps_per_epoch == 0
        finished = i == total_steps
        if (at_epoch_end and (epoch + 1) % max(t.validate_every, 1) == 0) or finished:
            vm = validation_sweep()
            last_metrics.update(vm)
            logger.metrics(i, vm)
            logger.text(f"epoch {epoch}: val mIoU {vm['val_miou']:.4f} "
                        f"det@0.5 {vm['val_det50']:.4f} (n={vm['val_n']:.0f})")
            if vm["val_miou"] > best_miou:
                best_miou = vm["val_miou"]
                epochs_since_best = 0
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
    logger.text("visualization skipped: visualize is not ported yet (ROADMAP A4)")
    save_checkpoint(ckpt_dir, state, i)
    logger.text(f"done: {i} steps, final loss {last_metrics.get('total_loss', float('nan')):.4f}, "
                f"eval mIoU {last_metrics['eval_miou']:.4f}")
    logger.close()
    if device != "cpu":
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
    p.add_argument("--devices", type=int, default=None)
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
