"""Synthetic COCO-person dataset generator.

Counterpart of the JAX package's ``data/synthetic.py``: for a seed it writes
the same JPEG images and the same annotation JSON. It generates a COCO-format
dataset (JPEG images and an annotation JSON with polygon segmentations) of
simple multi-"person" scenes: polygonal blobs with distinct colours over
textured backgrounds. It exercises every stage of the real pipeline (JSON
index, polygon rasterisation through the native codec, 3-class ROI mask
construction, augmentation, batching) and gives training runs a learnable
signal for end-to-end checks:

    python -m human_instance_segmentation_tpu_torch.data.synthetic --out DIR [--n 64]
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Tuple

import numpy as np


def _blob_polygon(cx: float, cy: float, rx: float, ry: float,
                  rng: np.random.Generator, n_pts: int = 12) -> list:
    """Closed star-ish polygon around (cx, cy)."""
    pts = []
    for i in range(n_pts):
        a = 2 * math.pi * i / n_pts
        r = 1.0 + rng.uniform(-0.25, 0.25)
        pts.extend([cx + math.cos(a) * rx * r, cy + math.sin(a) * ry * r])
    return pts


def generate_synthetic_coco(
    out_dir: str,
    n_images: int = 16,
    image_size: Tuple[int, int] = (480, 640),
    max_instances: int = 4,
    seed: int = 0,
) -> Tuple[str, str]:
    """Write images/ + annotations.json; returns (annotation_path, image_dir)."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    ih, iw = image_size
    root = Path(out_dir)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        # textured background
        bg = rng.integers(30, 120, (ih // 8, iw // 8, 3), np.uint8)
        img = Image.fromarray(bg).resize((iw, ih), Image.BILINEAR)
        draw = ImageDraw.Draw(img)
        n_inst = int(rng.integers(1, max_instances + 1))
        for _ in range(n_inst):
            rx = rng.uniform(0.06, 0.18) * iw
            ry = rng.uniform(0.12, 0.3) * ih
            cx = rng.uniform(rx, iw - rx)
            cy = rng.uniform(ry, ih - ry)
            poly = _blob_polygon(cx, cy, rx, ry, rng)
            color = tuple(int(c) for c in rng.integers(130, 255, 3))
            draw.polygon([(poly[k], poly[k + 1]) for k in range(0, len(poly), 2)],
                         fill=color)
            xs, ys = poly[0::2], poly[1::2]
            x1, y1 = max(min(xs), 0.0), max(min(ys), 0.0)
            x2, y2 = min(max(xs), iw), min(max(ys), ih)
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": 1,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": (x2 - x1) * (y2 - y1), "iscrowd": 0,
                "segmentation": [poly],
            })
            ann_id += 1
        fname = f"synthetic_{i:06d}.jpg"
        img.save(img_dir / fname, quality=90)
        images.append({"id": i + 1, "file_name": fname, "width": iw, "height": ih})

    ann_path = root / "annotations.json"
    ann_path.write_text(json.dumps({
        "images": images,
        "annotations": annotations,
        "categories": [{"id": 1, "name": "person"}],
    }))
    return str(ann_path), str(img_dir)


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max_instances", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    ann, imgs = generate_synthetic_coco(args.out, args.n, (args.height, args.width),
                                        args.max_instances, args.seed)
    print(json.dumps({"annotations": ann, "images": imgs}))


if __name__ == "__main__":
    main()
