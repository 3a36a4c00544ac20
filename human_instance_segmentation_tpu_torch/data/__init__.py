"""Host-side data pipeline: COCO parsing, datasets, augmentations, loading,
and the precomputed YOLOv9 feature files (``yolo_features``).

The JAX package's exports.
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
from .yolo_features import (
    ONNX_TENSOR_NAMES,
    convert_onnx_feature_dump,
    load_feature_pyramid,
    write_golden_fixture,
)

__all__ = [
    "COCOIndex", "ann_to_mask", "polygons_to_mask", "rle_decode", "rle_encode",
    "COCOInstanceSegmentationDataset", "COCOPersonBinaryDataset",
    "DatasetConfig", "batch_iterator", "padded_batch_iterator", "collate",
    "AugmentConfig", "augment_sample", "hflip",
    "ONNX_TENSOR_NAMES", "convert_onnx_feature_dump", "write_golden_fixture",
    "load_feature_pyramid",
]
