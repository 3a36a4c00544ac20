"""Deployment inference harness CLI.

Counterpart of the JAX package's ``harness.py``: loads an exported artifact
(``export.load_exported``) or builds a model from a config (seeded random
weights, served by ``inference.InferenceEngine``), runs it over a directory
of images with ROIs from COCO annotations or a full-frame default box, and
writes instance or binary overlay PNGs (``visualize``).

Usage:
    python -m human_instance_segmentation_tpu_torch.harness \\
        --images DIR [--artifact exported_dir | --config <name>] \\
        [--annotations coco.json] [--mode instance|binary] --out out_dir [--device cpu]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .visualize import overlay_binary, overlay_instances, save_image

DEFAULT_CONFIG = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_"
                  "r64x48m128x96_disttrans_contdet_baware_from_b0")


def load_image(path: Path, size_hw: Tuple[int, int]) -> np.ndarray:
    """An RGB image resized (bilinear) to ``size_hw``, float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def rois_for_image(annotations, img_name: str, default: bool = True) -> np.ndarray:
    """The image's non-crowd person boxes as (N, 5) rois normalised by the
    annotation's own image size; a centred default box where it has none."""
    if annotations is not None:
        for img in annotations.dataset.get("images", []):
            if img["file_name"] == img_name:
                w, h = img["width"], img["height"]
                boxes = []
                for ann in annotations.load_anns(annotations.get_ann_ids(img["id"],
                                                                         iscrowd=False)):
                    x, y, bw, bh = ann["bbox"]
                    boxes.append([0.0, x / w, y / h, (x + bw) / w, (y + bh) / h])
                if boxes:
                    return np.asarray(boxes, np.float32)
    if default:
        return np.asarray([[0.0, 0.15, 0.05, 0.85, 0.98]], np.float32)
    return np.zeros((0, 5), np.float32)


def run_harness(
    images_dir: str,
    out_dir: str,
    artifact: Optional[str] = None,
    config: Optional[str] = None,
    annotations_path: Optional[str] = None,
    mode: str = "instance",
    max_images: int = 8,
    dilation: int = 0,
    device: str = "cuda",
) -> List[str]:
    """Write ``<out_dir>/<stem>_<mode>.png`` for the first ``max_images``
    ``*.jpg`` of ``images_dir``; returns the paths written."""
    from .data.coco import COCOIndex

    annotations = COCOIndex(annotations_path) if annotations_path else None

    if artifact:
        from .export import load_exported

        call, meta = load_exported(artifact, device=device)
        ih, iw = meta["image_size"]
    else:
        from .config import ConfigManager, _as_hw, model_from_config
        from .inference import InferenceEngine

        cfg = ConfigManager.get_config(config or DEFAULT_CONFIG)
        model = model_from_config(cfg, seed=0, device=device)
        ih, iw = _as_hw(cfg.model.image_size)
        call = InferenceEngine(model, dilation_pixels=dilation)

    written = []
    files = sorted(Path(images_dir).glob("*.jpg"))[:max_images]
    t_total = 0.0
    for f in files:
        image = load_image(f, (ih, iw))
        rois = rois_for_image(annotations, f.name)
        t0 = time.perf_counter()
        inst, binary = call(image[None], rois)
        t_total += time.perf_counter() - t0
        if mode == "binary":
            vis = overlay_binary(image, binary[0])
        else:
            vis = overlay_instances(image, inst, rois[:, 1:5])
        out_path = str(Path(out_dir) / f"{f.stem}_{mode}.png")
        save_image(out_path, vis)
        written.append(out_path)
    if files:
        print(f"{len(files)} images, {t_total / len(files) * 1e3:.1f} ms/img "
              f"(incl. host transfers), outputs in {out_dir}")
    return written


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--images", required=True)
    p.add_argument("--out", default="harness_out")
    p.add_argument("--artifact", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--annotations", default=None)
    p.add_argument("--mode", choices=["instance", "binary"], default="instance")
    p.add_argument("--max_images", type=int, default=8)
    p.add_argument("--dilation", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    run_harness(args.images, args.out, args.artifact, args.config, args.annotations,
                args.mode, args.max_images, args.dilation, args.device)


if __name__ == "__main__":
    main()
