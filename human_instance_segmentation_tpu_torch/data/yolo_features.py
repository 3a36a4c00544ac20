"""Real-YOLOv9-feature contract: fixture schema, converter, loader.

Counterpart of the JAX package's ``data/yolo_features.py``, numpy only. The
multi-scale and variable-ROI families and the YOLO-feature distillation
consume YOLOv9 intermediate activations; the supported path is
PRECOMPUTED features through the data pipeline, so no ONNX Runtime session
runs inside a training step.

The wire contract:

  one ``.npz`` per dump, NHWC float32, with keys
    images                    (B, H, W, 3)   in [0, 1]
    masks                     (B, H, W, 1)   binary person mask (optional
                                             for pure feature extraction)
    feat_<layer_id>           (B, H/stride, W/stride, C) for each layer in
                              FEATURE_SPECS, e.g. feat_layer_34
    yolo_features             alias of feat_layer_34 (the single-layer
                              distillation path, training/yolo_distill.py)

Real dumps come from running the YOLOv9 feature-extractor graph offline and
feeding its raw outputs, keyed by the exact ONNX tensor names below and NCHW
as ONNX Runtime emits them, to :func:`convert_onnx_feature_dump`, which
validates shapes against FEATURE_SPECS and writes the schema above.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..models.multiscale import FEATURE_SPECS

# Exact ONNX output tensor names of the YOLOv9 feature-extractor graph:
# layer_id -> tensor name. These are the keys a raw ORT dump must carry.
ONNX_TENSOR_NAMES: Dict[str, str] = {
    "layer_3": "segmentation_model_3_Concat_output_0",
    "layer_19": "segmentation_model_19_Concat_output_0",
    "layer_5": "segmentation_model_5_Concat_output_0",
    "layer_22": "segmentation_model_22_Concat_output_0",
    "layer_34": "segmentation_model_34_Concat_output_0",
}


def validate_feature_map(layer_id: str, feat: np.ndarray,
                         image_hw: Tuple[int, int]) -> None:
    """Check one NHWC feature map against FEATURE_SPECS (channels, stride)."""
    if layer_id not in FEATURE_SPECS:
        raise ValueError(f"unknown layer {layer_id!r}; known: {sorted(FEATURE_SPECS)}")
    ch, stride = FEATURE_SPECS[layer_id]
    ih, iw = image_hw
    want = (ih // stride, iw // stride, ch)
    if feat.ndim != 4 or feat.shape[1:] != want:
        raise ValueError(
            f"{layer_id}: expected (B, {want[0]}, {want[1]}, {want[2]}) for "
            f"image {image_hw} (stride {stride}, {ch}ch), got {feat.shape}")


def convert_onnx_feature_dump(
    images: np.ndarray,
    ort_outputs: Dict[str, np.ndarray],
    out_path: str,
    masks: Optional[np.ndarray] = None,
) -> str:
    """Convert a raw ORT output dump to the framework's .npz feature schema.

    ``images``: (B, H, W, 3) NHWC in [0, 1] (what the ORT session consumed,
    transposed back if it ran NCHW). ``ort_outputs``: {onnx_tensor_name:
    (B, C, h, w) NCHW array} — the session.run outputs keyed by the names in
    :data:`ONNX_TENSOR_NAMES`. Layers present in the dump are converted to
    NHWC ``feat_<layer_id>`` keys and validated against FEATURE_SPECS;
    ``yolo_features`` is aliased to layer_34 when present. Returns out_path.
    """
    images = np.asarray(images, np.float32)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3) NHWC, got {images.shape}")
    ih, iw = images.shape[1:3]
    name_to_layer = {v: k for k, v in ONNX_TENSOR_NAMES.items()}

    arrays: Dict[str, np.ndarray] = {"images": images}
    if masks is not None:
        masks = np.asarray(masks, np.float32)
        if masks.shape[:3] != images.shape[:3]:
            raise ValueError(f"masks {masks.shape} do not match images {images.shape}")
        arrays["masks"] = masks if masks.ndim == 4 else masks[..., None]

    found = 0
    for tensor_name, value in ort_outputs.items():
        layer_id = name_to_layer.get(tensor_name)
        if layer_id is None:
            continue  # unrelated session output
        nhwc = np.ascontiguousarray(
            np.transpose(np.asarray(value, np.float32), (0, 2, 3, 1)))
        validate_feature_map(layer_id, nhwc, (ih, iw))
        arrays[f"feat_{layer_id}"] = nhwc
        found += 1
    if not found:
        raise ValueError(
            "no known YOLOv9 feature tensors in the dump; expected any of "
            f"{sorted(ONNX_TENSOR_NAMES.values())}")
    if "feat_layer_34" in arrays:
        arrays["yolo_features"] = arrays["feat_layer_34"]

    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    return str(out)


def write_golden_fixture(
    out_path: str,
    batch: int = 2,
    image_hw: Tuple[int, int] = (64, 64),
    layers: Iterable[str] = ("layer_3", "layer_22", "layer_34"),
    seed: int = 0,
) -> str:
    """Write a schema-exact synthetic fixture (the shapes real dumps have,
    deterministic values) — the golden file tests train against. Goes through
    :func:`convert_onnx_feature_dump` so the converter itself is exercised.
    """
    rng = np.random.default_rng(seed)
    ih, iw = image_hw
    images = rng.random((batch, ih, iw, 3), np.float32)
    masks = np.zeros((batch, ih, iw, 1), np.float32)
    masks[:, ih // 4: 3 * ih // 4, iw // 4: 3 * iw // 4] = 1.0
    ort_outputs = {}
    for layer_id in layers:
        ch, stride = FEATURE_SPECS[layer_id]
        ort_outputs[ONNX_TENSOR_NAMES[layer_id]] = (
            rng.standard_normal((batch, ch, ih // stride, iw // stride))
            .astype(np.float32) * 0.1)
    return convert_onnx_feature_dump(images, ort_outputs, out_path, masks=masks)


def load_feature_pyramid(npz_path: str):
    """Load one .npz into ({layer_id: (B,h,w,C)}, images, masks-or-None),
    validating every layer against FEATURE_SPECS."""
    with np.load(npz_path) as z:
        images = np.asarray(z["images"], np.float32)
        masks = np.asarray(z["masks"], np.float32) if "masks" in z else None
        feats = {}
        for key in z.files:
            if key.startswith("feat_"):
                layer_id = key[len("feat_"):]
                feat = np.asarray(z[key], np.float32)
                validate_feature_map(layer_id, feat, tuple(images.shape[1:3]))
                feats[layer_id] = feat
    return feats, images, masks
