"""Standalone validation CLI.

Counterpart of the JAX package's ``validate.py``: build a model from a
named config (seeded random weights, or a checkpoint of this package), run
the metric stack of ``training.metrics`` (target IoU, detection rates at
0.5 and 0.7, precision / recall / F1, instance-separation accuracy, the
three confusion matrices) over a COCO dataset or synthetic batches in eval
mode and float32, print a JSON report, and with ``cm_png_dir`` write the
confusion-matrix heatmaps.

Usage:
    python -m human_instance_segmentation_tpu_torch.validate --config <name> \\
        [--checkpoint ckpt] [--annotations coco.json --image_dir DIR | --synthetic N] \\
        [--batch_size 4] [--tiny] [--device cpu] [--cm_png_dir DIR]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises).
``--tiny`` narrows the model as the training loop's ``--tiny`` does.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_validation_batches(n: int, batch_size: int, k: int, image_hw,
                                 mask_hw) -> Iterator[Dict[str, np.ndarray]]:
    """``n`` random batches with a fixed centred box per ROI, the JAX
    validator's draws."""
    rng = np.random.default_rng(0)
    ih, iw = image_hw
    mh, mw = mask_hw
    for _ in range(n):
        yield {
            "images": rng.random((batch_size, ih, iw, 3), np.float32),
            "boxes": np.tile(np.asarray([[0.2, 0.2, 0.8, 0.8]], np.float32),
                             (batch_size, k, 1)),
            "masks": rng.integers(0, 3, (batch_size, k, mh, mw)).astype(np.int32),
            "valid": np.ones((batch_size, k), np.float32),
        }


def run_validation(
    config_name: str,
    checkpoint: Optional[str] = None,
    annotations: Optional[str] = None,
    image_dir: Optional[str] = None,
    synthetic_batches: int = 0,
    batch_size: int = 4,
    tiny: bool = False,
    device: str = "cuda",
    cm_png_dir: Optional[str] = None,
) -> Dict[str, float]:
    import torch

    from .config import ConfigManager, _as_hw, model_from_config
    from .training.loop import TINY_MODEL
    from .training.metrics import batch_metrics, finalize_metrics
    from .training.steps import batch_to, rois_from_boxes

    cfg = ConfigManager.get_config(config_name)
    overrides = {}
    if tiny:
        cfg.model.image_size = (64, 64)
        cfg.model.roi_size = (16, 12)
        cfg.model.mask_size = (32, 24)
        cfg.model.encoder_name = "tiny"
        cfg.model.hierarchical_base_channels = 16
        cfg.model.hierarchical_depth = 2
        cfg.data.rois_per_image = 2
        if cfg.model.use_pretrained_unet and cfg.model.use_full_image_unet:
            overrides = TINY_MODEL
    model = model_from_config(cfg, seed=0, device=device, **overrides)
    dev = next(model.parameters()).device
    if checkpoint:
        from .training.checkpoint import load_model_state

        model.load_state_dict(load_model_state(checkpoint), strict=True)
        print(f"loaded checkpoint {checkpoint}")
    model.eval()

    ih, iw = _as_hw(cfg.model.image_size)
    mh, mw = _as_hw(cfg.model.mask_size)
    k = cfg.data.rois_per_image

    def eval_batch(batch):
        batch = batch_to(batch, dev)
        with torch.no_grad():
            logits, _ = model(batch["images"].float(), rois_from_boxes(batch["boxes"].float()))
        b, kk = batch["boxes"].shape[:2]
        targets = batch["masks"].reshape(b * kk, mh, mw)
        valid = batch["valid"].reshape(b * kk)
        return {key: v.cpu().numpy() for key, v in batch_metrics(logits, targets, valid).items()}

    if synthetic_batches > 0:
        batches = synthetic_validation_batches(synthetic_batches, batch_size, k, (ih, iw),
                                               (mh, mw))
    else:
        from .data import COCOInstanceSegmentationDataset, DatasetConfig, padded_batch_iterator

        ds = COCOInstanceSegmentationDataset(
            annotations or cfg.data.val_annotation, image_dir or cfg.data.val_img_dir,
            DatasetConfig(image_size=(ih, iw), mask_size=(mh, mw), rois_per_image=k))
        # the last batch padded, not ragged: one shape per sweep
        batches = padded_batch_iterator(ds, batch_size)

    sums = None
    for batch in batches:
        m = eval_batch(batch)
        sums = m if sums is None else {key: sums[key] + m[key] for key in sums}
    if sums is None:
        raise RuntimeError("no validation data")
    report = finalize_metrics(sums)
    if cm_png_dir:
        from .visualize import confusion_matrix_png

        names = {"cm3": ("bg", "target", "non-target"),
                 "cm_bgfg": ("bg", "fg"),
                 "cm_tnt": ("target", "non-target")}
        for key, cls in names.items():
            confusion_matrix_png(np.asarray(sums[key]), cls, f"{cm_png_dir}/{key}.png", title=key)
    print(json.dumps(report, indent=2))
    return report


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of this package (ckpt_<step>.pt, or a directory: its newest)")
    p.add_argument("--annotations", default=None)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--synthetic", type=int, default=0, help="N synthetic batches")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--cm_png_dir", default=None,
                   help="write confusion-matrix heatmap PNGs here")
    args = p.parse_args()
    run_validation(args.config, args.checkpoint, args.annotations, args.image_dir,
                   args.synthetic, args.batch_size, args.tiny, args.device,
                   cm_png_dir=args.cm_png_dir)


if __name__ == "__main__":
    main()
