"""COCO person instance-segmentation datasets for the two training modes.

Counterpart of the JAX package's ``data/dataset.py``, a copy of its numpy
and PIL code. It redesigns:
- COCOInstanceSegmentationDataset (the reference's
  ``src/human_edge_detection/dataset.py:15-256``): one sample per image with
  its target annotations; resize to the model image size; 3-class ROI mask
  (0 bg / 1 target / 2 other instances) built as dataset.py:148-168 does;
  normalised [0, 1] boxes.
- FilteredCOCODataset (filtered_dataset.py:11-135): min-size and
  aspect-ratio filters.
- COCOPersonSegmentation (train_distillation_staged.py:53-130): full-image
  binary union-of-person masks for the distillation stage.

Samples are grouped **per image** with a static bucket of K target ROIs
(padded, ``valid`` mask), so the shared stage-1 forward runs once per image
and batches have static shapes:
    images (B, H, W, 3) / boxes (B, K, 4) / masks (B, K, mh, mw) / valid (B, K)
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .augment import AugmentConfig, augment_sample
from .coco import COCOIndex, ann_to_mask


def _load_image(path: Path, size_hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _resize_mask_nearest(mask: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    im = Image.fromarray(mask.astype(np.uint8))
    im = im.resize((size_hw[1], size_hw[0]), Image.NEAREST)
    return np.asarray(im, dtype=np.uint8)


@dataclass
class DatasetConfig:
    image_size: Tuple[int, int] = (640, 640)     # (h, w)
    mask_size: Tuple[int, int] = (56, 56)        # (h, w) per-ROI target size
    roi_padding: float = 0.0
    min_roi_size: int = 16
    max_instances_per_image: int = 10
    rois_per_image: int = 8                      # static K bucket
    # FilteredCOCODataset criteria (filtered_dataset.py:11-135)
    filter_min_box: float = 0.0                  # pixels, 30.0 for filtered
    filter_aspect_range: Tuple[float, float] = (0.0, 1e9)  # (0.2, 5.0) filtered


class COCOInstanceSegmentationDataset:
    """Per-image grouped samples with K-bucketed target ROIs."""

    def __init__(self, annotations, image_dir: str, cfg: DatasetConfig = DatasetConfig(),
                 augment: Optional[AugmentConfig] = None, seed: int = 0):
        self.coco = annotations if isinstance(annotations, COCOIndex) else COCOIndex(annotations)
        self.image_dir = Path(image_dir)
        self.cfg = cfg
        self.augment_cfg = augment
        self.seed = seed
        self._epoch = 0

        self.samples: List[Tuple[int, List[int]]] = []  # (img_id, valid ann ids)
        for img_id in self.coco.get_img_ids():
            anns = self.coco.load_anns(self.coco.get_ann_ids(img_id, iscrowd=False))
            valid = []
            for ann in anns:
                w, h = ann["bbox"][2], ann["bbox"][3]
                if w < cfg.min_roi_size or h < cfg.min_roi_size:
                    continue
                if w < cfg.filter_min_box or h < cfg.filter_min_box:
                    continue
                aspect = w / max(h, 1e-6)
                lo, hi = cfg.filter_aspect_range
                if not (lo <= aspect <= hi):
                    continue
                valid.append(ann["id"])
            if valid:
                # Keep EVERY valid annotation: the K-slot target selection in
                # __getitem__ rotates by epoch, so images with more instances
                # than the bucket still train on all of them over time
                # (reference semantics: one sample per annotation,
                # dataset.py:15-60 — here the rotation restores full target
                # coverage without giving up per-image grouping).
                self.samples.append((img_id, valid))

    def __len__(self) -> int:
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _roi_box_pixels(self, bbox, sx: float, sy: float) -> Tuple[int, int, int, int]:
        """Scaled, padded, min-size-enforced pixel box (dataset.py:125-146)."""
        ih, iw = self.cfg.image_size
        x, y, w, h = bbox
        x, y, w, h = x * sx, y * sy, w * sx, h * sy
        px, py = w * self.cfg.roi_padding, h * self.cfg.roi_padding
        x1, y1 = max(0, int(x - px)), max(0, int(y - py))
        x2, y2 = min(iw, int(x + w + px)), min(ih, int(y + h + py))
        ms = self.cfg.min_roi_size
        if x2 - x1 < ms:
            cx = (x1 + x2) // 2
            x1 = max(0, cx - ms // 2)
            x2 = min(iw, x1 + ms)
        if y2 - y1 < ms:
            cy = (y1 + y2) // 2
            y1 = max(0, cy - ms // 2)
            y2 = min(ih, y1 + ms)
        return x1, y1, x2, y2

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_id, ann_ids = self.samples[idx]
        info = self.coco.load_imgs(img_id)[0]
        ih, iw = self.cfg.image_size
        mh, mw = self.cfg.mask_size
        k = self.cfg.rois_per_image

        image = _load_image(self.image_dir / info["file_name"], (ih, iw))
        sx, sy = iw / info["width"], ih / info["height"]

        anns = self.coco.load_anns(ann_ids)
        inst_masks = [
            _resize_mask_nearest(ann_to_mask(a, info["height"], info["width"]), (ih, iw))
            for a in anns
        ]

        boxes = np.zeros((k, 4), np.float32)
        masks = np.zeros((k, mh, mw), np.int32)
        valid = np.zeros((k,), np.float32)

        # Per-epoch target rotation: epoch e takes the K-window starting at
        # (e * k) mod n, so every annotation becomes a target once every
        # ceil(n / k) epochs instead of instances beyond the first K being
        # silently untrainable. Deterministic (same window on every worker
        # thread) and a no-op for images with <= K instances.
        k_eff = min(k, self.cfg.max_instances_per_image)
        n_anns = len(anns)
        start = (self._epoch * k_eff) % n_anns
        chosen = [(start + j) % n_anns for j in range(min(k_eff, n_anns))]
        for slot, ti in enumerate(chosen):
            x1, y1, x2, y2 = self._roi_box_pixels(anns[ti]["bbox"], sx, sy)
            roi = np.zeros((y2 - y1, x2 - x1), np.uint8)
            roi[inst_masks[ti][y1:y2, x1:x2] > 0] = 1
            for oi, om in enumerate(inst_masks):
                if oi != ti:
                    other = om[y1:y2, x1:x2]
                    roi[(other > 0) & (roi == 0)] = 2
            boxes[slot] = [x1 / iw, y1 / ih, x2 / iw, y2 / ih]
            masks[slot] = _resize_mask_nearest(roi, (mh, mw)).astype(np.int32)
            valid[slot] = 1.0

        sample = {"image": image, "boxes": boxes, "masks": masks, "valid": valid,
                  "image_id": np.asarray(img_id, np.int64)}
        if self.augment_cfg is not None:
            # Fresh generator per call: np Generators are not thread-safe and
            # ThreadedLoader calls __getitem__ from several workers at once.
            rng = np.random.default_rng((self.seed, self._epoch, idx))
            sample = augment_sample(sample, rng, self.augment_cfg)
        return sample


class COCOPersonBinaryDataset:
    """Full-image binary union-of-person masks for distillation
    (train_distillation_staged.py:53-130)."""

    def __init__(self, annotations, image_dir: str,
                 image_size: Tuple[int, int] = (640, 640),
                 augment: Optional[AugmentConfig] = None, seed: int = 0):
        self.coco = annotations if isinstance(annotations, COCOIndex) else COCOIndex(annotations)
        self.image_dir = Path(image_dir)
        self.image_size = image_size
        self.augment_cfg = augment
        self.seed = seed
        self._epoch = 0
        self.img_ids = [i for i in self.coco.get_img_ids()
                        if self.coco.get_ann_ids(i, iscrowd=False)]

    def __len__(self) -> int:
        return len(self.img_ids)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_id = self.img_ids[idx]
        info = self.coco.load_imgs(img_id)[0]
        ih, iw = self.image_size
        image = _load_image(self.image_dir / info["file_name"], (ih, iw))
        union = np.zeros((info["height"], info["width"]), np.uint8)
        for ann in self.coco.load_anns(self.coco.get_ann_ids(img_id, iscrowd=False)):
            union |= ann_to_mask(ann, info["height"], info["width"])
        mask = _resize_mask_nearest(union, (ih, iw)).astype(np.float32)[..., None]
        sample = {"image": image, "full_mask": mask[..., 0]}
        if self.augment_cfg is not None:
            rng = np.random.default_rng((self.seed, self._epoch, idx))
            sample = augment_sample({"image": image, "boxes": np.zeros((0, 4), np.float32),
                                     "full_mask": mask[..., 0]}, rng, self.augment_cfg)
        return {"image": sample["image"].astype(np.float32),
                "mask": sample["full_mask"][..., None].astype(np.float32)}


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-image samples into the static train-batch contract
    (training.steps expects the plural 'images' key)."""
    keys = samples[0].keys()
    out = {k: np.stack([s[k] for s in samples]) for k in keys}
    for single, plural in (("image", "images"), ("mask", "masks")):
        if single in out and plural not in out:
            out[plural] = out.pop(single)
    return out


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Simple host-side batch iterator (replaces torch DataLoader)."""
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    n = len(order) - (len(order) % batch_size if drop_last else 0)
    for start in range(0, n, batch_size):
        idxs = order[start:start + batch_size]
        if len(idxs) < batch_size and drop_last:
            break
        yield collate([dataset[int(i)] for i in idxs])


def padded_batch_iterator(dataset, batch_size: int, shuffle: bool = False,
                          seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Full-size batches covering EVERY sample: the final ragged batch is
    padded by wrapping earlier samples with their ``valid`` mask zeroed, so
    the eval step sees one shape, as the JAX package's does. Only for ROI
    datasets that carry a ``valid`` key."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        idxs = list(order[start:start + batch_size])
        n_real = len(idxs)
        while len(idxs) < batch_size:
            idxs.append(int(order[(len(idxs) - n_real) % len(order)]))
        batch = collate([dataset[int(i)] for i in idxs])
        if n_real < batch_size:
            if "valid" not in batch:
                raise ValueError("padded_batch_iterator needs a 'valid' key "
                                 "to mask pad samples")
            batch["valid"][n_real:] = 0.0
        yield batch
