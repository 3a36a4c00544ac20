"""Int8 serving accuracy on a trained model: train the tiny flagship on
synthetic COCO, then compare the validation target IoU of float32 serving
with that of calibrated int8 serving.

Counterpart of the JAX package's ``scripts/eval_int8_accuracy.py``
(:1-127), with its shapes, epochs and optimizer: 16 synthetic 64 x 64
images with up to 2 people, the tiny flagship with stage 1 unfrozen,
Adam(3e-3) after a global-norm clip at 1, batch 4, 30 epochs; int8 scales
calibrated on the first two batches, every eligible conv in int8 (nothing
denied, the JAX ``int8_serving()`` default). The script's second half
serves the S2D ``fused_tail`` form, TPU layout that is not ported; its
counterpart here is the ``pallas_tail=True`` form (the same weights),
calibrated through that form so that its s8 tail's three points are
recorded, and served in float32 and in int8 (the s8 tail).

    python -m human_instance_segmentation_tpu_torch.int8_accuracy [--device cpu] [--epochs N]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Dict, Optional

IMAGE = (64, 64)
MASK = (32, 24)


def _target_iou(model, ds, scales: Optional[Dict[str, float]], device) -> float:
    """Target IoU over the whole dataset (batches of 4, unshuffled): pixels
    where argmax == 1 against target == 1 on valid ROIs, pooled; int8 with
    ``scales``, else float32."""
    import torch

    from .data import batch_iterator
    from .ops.quant import set_int8_serving
    from .training.steps import batch_to, eval_forward

    set_int8_serving(model, scales is not None, scales)
    inter = union = 0.0
    try:
        for batch in batch_iterator(ds, batch_size=4, shuffle=False, seed=0):
            b = batch_to(batch, device)
            logits, _ = eval_forward(model, b["images"], b["boxes"])
            bk, k = b["boxes"].shape[:2]
            targets = b["masks"].reshape(bk * k, *MASK)
            valid = b["valid"].reshape(bk * k).bool()[:, None, None]
            pred = (logits.argmax(-1) == 1) & valid
            gt = (targets == 1) & valid
            inter += float(torch.sum(pred & gt))
            union += float(torch.sum(pred | gt))
    finally:
        set_int8_serving(model, False)
    return inter / max(union, 1.0)


def _calibrate(model, ds, device) -> Dict[str, float]:
    """Scales from the first two batches (pointwise max)."""
    import torch

    from .data import batch_iterator
    from .ops.quant import calibration, collect_scales, merge_scales, set_int8_serving
    from .training.steps import batch_to, rois_from_boxes

    set_int8_serving(model, False)
    model.eval()
    scales = None
    for i, batch in enumerate(batch_iterator(ds, batch_size=4, shuffle=False, seed=0)):
        b = batch_to(batch, device)
        with torch.inference_mode(), calibration(model) as calib:
            model(b["images"].float(), rois_from_boxes(b["boxes"].float()))
        s = collect_scales(calib)
        scales = s if scales is None else merge_scales(scales, s)
        if i >= 1:
            break
    return scales


def _train_and_serve(dev, tmp: str, epochs: int) -> Dict[str, float]:
    """The tiny flagship trained on a synthetic COCO tree written under
    ``tmp``, then served in float32 and in calibrated int8, plain and with
    the s8 tail."""
    from .data import COCOInstanceSegmentationDataset, DatasetConfig, batch_iterator
    from .data.synthetic import generate_synthetic_coco
    from .inference import init_weights
    from .losses.hierarchical import RefinedLossConfig
    from .models.assembly import HierarchicalInstanceSegmenter
    from .training.optim import Transform, constant_schedule
    from .training.state import TrainState
    from .training.steps import make_train_step

    ann, img_dir = generate_synthetic_coco(tmp, n_images=16, image_size=IMAGE, max_instances=2)
    ds = COCOInstanceSegmentationDataset(ann, img_dir, DatasetConfig(
        image_size=IMAGE, mask_size=MASK, rois_per_image=2, min_roi_size=4))

    def build(**kw):
        m = HierarchicalInstanceSegmenter(
            encoder_variant="tiny", roi_size=(16, 12), mask_size=MASK, image_size=IMAGE,
            base_channels=16, depth=2, mid_channels=32, feature_dim=32,
            unet_decoder_channels=(32, 24, 16, 16, 8), freeze_pretrained=False, **kw)
        init_weights(m, 0)
        return m.to(dev)

    model = build()
    state = TrainState.create(model, Transform("adam", constant_schedule(3e-3), clip=1.0), seed=1)
    step = make_train_step(model, RefinedLossConfig())
    metrics = {}
    for epoch in range(epochs):
        for batch in batch_iterator(ds, batch_size=4, shuffle=True, seed=epoch):
            state, metrics = step(state, batch)
    loss = float(metrics["total_loss"])
    model.eval()

    out = {"train_loss": loss}
    out["f32"] = _target_iou(model, ds, None, dev)
    out["int8"] = _target_iou(model, ds, _calibrate(model, ds, dev), dev)
    # the serving form with the fused stage-1 tail, on the same weights
    serve = build(pallas_tail=True)
    serve.load_state_dict(model.state_dict())
    serve.eval()
    out["tail_f32"] = _target_iou(serve, ds, None, dev)
    out["tail_int8"] = _target_iou(serve, ds, _calibrate(serve, ds, dev), dev)
    out["delta"] = out["int8"] - out["f32"]
    out["tail_delta"] = out["tail_int8"] - out["f32"]
    return out


def main(device: str = "cuda", epochs: int = 30, verbose: bool = True) -> Dict[str, float]:
    """Train, calibrate and serve (module docstring); returns the target
    IoUs (``f32``, ``int8``, ``tail_f32``, ``tail_int8``), the deltas and the
    last train loss. The synthetic tree is removed afterwards."""
    from .inference import resolve_device

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        out = _train_and_serve(dev, tmp, epochs)
    if verbose:
        print(f"final train loss {out['train_loss']:.3f}")
        print(f"target IoU  f32 serving:  {out['f32']:.4f}")
        print(f"target IoU  int8 serving: {out['int8']:.4f}")
        print(f"delta: {out['delta']:+.4f}")
        print(f"target IoU  f32 fused-tail serving:  {out['tail_f32']:.4f} "
              f"(exactness check vs plain: {out['tail_f32'] - out['f32']:+.5f})")
        print(f"target IoU  int8 fused-tail serving: {out['tail_int8']:.4f}")
        print(f"delta vs f32: {out['tail_delta']:+.4f}")
    return out


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--epochs", type=int, default=30)
    args = p.parse_args(argv)
    main(args.device, args.epochs)


if __name__ == "__main__":
    cli()
