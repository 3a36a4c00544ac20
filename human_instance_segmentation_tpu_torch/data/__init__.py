"""Host-side data pipeline: COCO parsing, datasets, augmentations, loading.

The JAX package's exports without its ``yolo_features`` names, which come
with the multi-scale model (ROADMAP A8).
"""

from .augment import AugmentConfig, augment_sample, hflip
from .coco import COCOIndex, ann_to_mask, polygons_to_mask, rle_decode, rle_encode
from .dataset import (
    COCOInstanceSegmentationDataset,
    COCOPersonBinaryDataset,
    DatasetConfig,
    batch_iterator,
    collate,
    padded_batch_iterator,
)

__all__ = [
    "COCOIndex", "ann_to_mask", "polygons_to_mask", "rle_decode", "rle_encode",
    "COCOInstanceSegmentationDataset", "COCOPersonBinaryDataset",
    "DatasetConfig", "batch_iterator", "padded_batch_iterator", "collate",
    "AugmentConfig", "augment_sample", "hflip",
]
