"""Visualisation: mask overlays and validation grids.

Counterpart of the JAX package's ``visualize.py``, a copy of its PIL and
numpy code: arrays go in as numpy (callers move tensors to the host first)
and the same arrays give the same pixels. It replaces the reference's
matplotlib/seaborn visualisers (visualize.py,
advanced/hierarchical_unet_visualizer.py,
test_hierarchical_instance_peopleseg_onnx.py:230-402) with a compact
PIL/numpy implementation: HSV-coloured per-instance overlays pasted back
into their ROI boxes, binary-mask green overlays, side-by-side GT /
prediction grids written per validation epoch, the aux-head panels and the
confusion-matrix heatmap.
"""

from __future__ import annotations

import colorsys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def instance_palette(n: int) -> List[Tuple[int, int, int]]:
    """n visually-distinct colors (HSV wheel, the harness's scheme)."""
    return [
        tuple(int(255 * c) for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.9, 1.0))
        for i in range(n)
    ]


def paste_mask_into_box(
    mask: np.ndarray, box: Sequence[float], image_hw: Tuple[int, int]
) -> np.ndarray:
    """Resize a ROI mask into its normalised box on a full-image canvas
    (test_hierarchical_instance_peopleseg_onnx.py:230-300)."""
    from PIL import Image

    ih, iw = image_hw
    x1 = int(round(box[0] * iw))
    y1 = int(round(box[1] * ih))
    x2 = max(int(round(box[2] * iw)), x1 + 1)
    y2 = max(int(round(box[3] * ih)), y1 + 1)
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, iw), min(y2, ih)
    canvas = np.zeros((ih, iw), np.float32)
    if x2 <= x1 or y2 <= y1:
        return canvas
    m = Image.fromarray((np.squeeze(mask) * 255).astype(np.uint8))
    m = m.resize((x2 - x1, y2 - y1), Image.BILINEAR)
    canvas[y1:y2, x1:x2] = np.asarray(m, np.float32) / 255.0
    return canvas


def overlay_instances(
    image: np.ndarray,
    instance_masks: np.ndarray,
    boxes: np.ndarray,
    alpha: float = 0.5,
    threshold: float = 0.5,
) -> np.ndarray:
    """HSV-coloured instance overlay. image (H, W, 3) in [0,1];
    instance_masks (N, mh, mw, 1); boxes (N, 4) normalised."""
    out = image.copy()
    colors = instance_palette(len(boxes))
    for i, (mask, box) in enumerate(zip(instance_masks, boxes)):
        full = paste_mask_into_box(mask, box, image.shape[:2]) > threshold
        color = np.asarray(colors[i], np.float32) / 255.0
        out[full] = (1 - alpha) * out[full] + alpha * color
    return np.clip(out, 0.0, 1.0)


def overlay_binary(image: np.ndarray, binary_mask: np.ndarray,
                   alpha: float = 0.5, threshold: float = 0.5) -> np.ndarray:
    """Green overlay of the stage-1 person mask (harness binary mode,
    :294-333)."""
    out = image.copy()
    m = np.squeeze(binary_mask) > threshold
    green = np.asarray([0.0, 1.0, 0.0], np.float32)
    out[m] = (1 - alpha) * out[m] + alpha * green
    return np.clip(out, 0.0, 1.0)


def save_image(path: str, image: np.ndarray) -> None:
    from PIL import Image

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8)).save(path)


def colorize_classes(mask: np.ndarray) -> np.ndarray:
    """3-class mask -> RGB (bg black, target green, non-target red)."""
    h, w = mask.shape
    rgb = np.zeros((h, w, 3), np.float32)
    rgb[mask == 1] = [0.1, 0.9, 0.1]
    rgb[mask == 2] = [0.9, 0.2, 0.2]
    return rgb


def validation_grid(
    image: np.ndarray,
    gt_masks: np.ndarray,
    pred_logits: np.ndarray,
    boxes: np.ndarray,
    binary_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """GT / prediction / (optional stage-1) rows for one sample — the
    per-epoch validation grid (visualize.py / hierarchical_unet_visualizer)."""
    from PIL import Image

    ih, iw = image.shape[:2]
    pred_cls = np.argmax(pred_logits, axis=-1)  # (N, mh, mw)
    rows = []

    def to_panel(m3):
        return 0.5 * image + 0.5 * m3

    gt_canvas = np.zeros((ih, iw), np.int32)
    pred_canvas = np.zeros((ih, iw), np.int32)
    for i, box in enumerate(boxes):
        g = paste_mask_into_box((gt_masks[i] == 1).astype(np.float32), box, (ih, iw)) > 0.5
        p = paste_mask_into_box((pred_cls[i] == 1).astype(np.float32), box, (ih, iw)) > 0.5
        gt_canvas[g] = 1
        pred_canvas[p] = 1
    rows.append(np.concatenate([image, to_panel(colorize_classes(gt_canvas))], axis=1))
    rows.append(np.concatenate(
        [overlay_instances(image, (pred_cls == 1).astype(np.float32)[..., None], boxes),
         to_panel(colorize_classes(pred_canvas))], axis=1))
    if binary_mask is not None:
        b = overlay_binary(image, binary_mask)
        rows.append(np.concatenate([b, b], axis=1))
    return np.concatenate(rows, axis=0)


def heatmap(values: np.ndarray, vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    """(h, w) scalar map -> RGB 'hot'-style heatmap (black->red->yellow->white),
    the colormap the reference's aux visualizer uses
    (visualize_auxiliary.py:620, cmap='hot')."""
    v = np.clip((np.squeeze(values).astype(np.float32) - vmin)
                / max(vmax - vmin, 1e-9), 0.0, 1.0)
    r = np.clip(3.0 * v, 0, 1)
    g = np.clip(3.0 * v - 1.0, 0, 1)
    b = np.clip(3.0 * v - 2.0, 0, 1)
    return np.stack([r, g, b], axis=-1)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def _softmax(x, axis=-1):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def auxiliary_grid(
    roi_image: np.ndarray,
    pred_logits: np.ndarray,
    aux: Dict[str, np.ndarray],
    gt_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Aux-head panel row for ONE ROI: the debugging view of the
    hierarchical head (parity with the reference's visualize_auxiliary.py /
    advanced/hierarchical_unet_visualizer.py:14-60 — bg/fg branch, t/nt
    branch, fg-attention, contour and distance aux outputs rendered next to
    the prediction).

    ``roi_image`` (h, w, 3) in [0, 1] — the RGB ROI crop; ``pred_logits``
    (mh, mw, 3) final head logits; ``aux`` the model's aux dict sliced to
    this ROI (arrays shaped (mh', mw', C)); ``gt_mask`` optional (mh, mw)
    int 3-class target. Returns one (H, W_total, 3) panel strip; every
    panel is resized to the prediction's (mh, mw).
    """
    from PIL import Image

    mh, mw = pred_logits.shape[:2]

    def fit(img01):
        arr = np.asarray(img01, np.float32)
        if arr.ndim == 2:
            arr = heatmap(arr)
        if arr.shape[:2] != (mh, mw):
            im = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
            arr = np.asarray(im.resize((mw, mh), Image.BILINEAR), np.float32) / 255.0
        return arr

    panels = [fit(roi_image)]
    pred_cls = np.argmax(pred_logits, axis=-1)
    panels.append(colorize_classes(pred_cls))
    if gt_mask is not None:
        panels.append(colorize_classes(np.asarray(gt_mask)))
    if "bg_fg_logits" in aux:  # P(fg) from the bg/fg branch (2-ch softmax)
        panels.append(fit(_softmax(aux["bg_fg_logits"])[..., 1]))
    if "target_nontarget_logits" in aux:  # P(target | fg) from the t/nt branch
        panels.append(fit(_softmax(aux["target_nontarget_logits"])[..., 0]))
    if "fg_attention" in aux:  # the fg_gate spatial attention map
        att = np.asarray(aux["fg_attention"], np.float32)
        panels.append(fit(att.mean(axis=-1) if att.ndim == 3 else att))
    if "contours" in aux:  # contour branch (1-ch sigmoid)
        panels.append(fit(_sigmoid(np.squeeze(aux["contours"]))))
    if "distance_map" in aux:  # distance-transform decoder, normalised
        d = np.asarray(np.squeeze(aux["distance_map"]), np.float32)
        panels.append(fit(d / max(float(d.max()), 1e-6)))
    if "distance_mask" in aux:
        panels.append(fit(_sigmoid(np.squeeze(aux["distance_mask"]))))
    return np.concatenate(panels, axis=1)


def auxiliary_report(
    roi_images: np.ndarray,
    pred_logits: np.ndarray,
    aux: Dict[str, np.ndarray],
    path: str,
    gt_masks: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Stack :func:`auxiliary_grid` rows for N ROIs and write one PNG —
    the per-epoch aux diagnostic image (visualize_auxiliary.py behaviour).
    ``aux`` holds batched arrays (N, h, w, C); rows are per-ROI slices.
    """
    rows = []
    for i in range(pred_logits.shape[0]):
        aux_i = {k: np.asarray(v)[i] for k, v in aux.items()
                 if hasattr(v, "ndim") and np.asarray(v).ndim == 4}
        rows.append(auxiliary_grid(
            roi_images[i], pred_logits[i], aux_i,
            None if gt_masks is None else gt_masks[i]))
    grid = np.concatenate(rows, axis=0)
    save_image(path, grid)
    return grid


def confusion_matrix_png(
    cm,
    class_names: Sequence[str],
    path: str,
    title: str = "",
    cell: int = 72,
) -> None:
    """Render a row-normalized confusion-matrix heatmap to ``path``.

    PIL replacement for the reference's per-epoch seaborn heatmaps
    (train_utils.py:50-82): blue-scale cells, count + row-percentage text,
    axis labels (rows = true class, columns = predicted).
    """
    from PIL import Image, ImageDraw

    cm = np.asarray(cm, np.float64)
    n = cm.shape[0]
    rows = np.clip(cm.sum(axis=1, keepdims=True), 1e-9, None)
    norm = cm / rows

    margin = cell  # left/top label band
    w, h = margin + n * cell, margin + n * cell + (cell // 2 if title else 0)
    img = Image.new("RGB", (w, h), (255, 255, 255))
    dr = ImageDraw.Draw(img)
    y0 = cell // 2 if title else 0
    if title:
        dr.text((margin, cell // 8), title, fill=(0, 0, 0))

    for i in range(n):
        for j in range(n):
            v = float(norm[i, j])
            # white -> saturated blue
            col = (int(255 - 200 * v), int(255 - 150 * v), 255)
            x, y = margin + j * cell, y0 + margin + i * cell
            dr.rectangle([x, y, x + cell - 1, y + cell - 1], fill=col,
                         outline=(160, 160, 160))
            txt = f"{int(cm[i, j])}\n{100 * v:.1f}%"
            fill = (255, 255, 255) if v > 0.6 else (0, 0, 0)
            dr.multiline_text((x + 4, y + cell // 3), txt, fill=fill)

    for k, name in enumerate(class_names[:n]):
        dr.text((margin + k * cell + 4, y0 + margin - 14), str(name), fill=(0, 0, 0))
        dr.text((4, y0 + margin + k * cell + cell // 2 - 6), str(name), fill=(0, 0, 0))
    dr.text((4, y0 + 4), "true \\ pred", fill=(90, 90, 90))

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    img.save(path)
