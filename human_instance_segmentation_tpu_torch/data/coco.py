"""Minimal self-contained COCO support: JSON index, polygon rasterisation,
RLE encode/decode.

Counterpart of the JAX package's ``data/coco.py``, a copy of its numpy and
PIL code (the port imports nothing of the JAX package). The reference leans
on pycocotools for COCO parsing and mask decoding (its
``src/human_edge_detection/dataset.py:6-7,106-111``); this module implements
the subset it needs from the COCO format spec: a lightweight annotation
index, the uncompressed and compressed (LEB128 string) RLE codecs and
polygon rasterisation. Each codec runs the native C++ form
(``data/native.py``) when it loads, and its Python form otherwise or with
``use_native=False``: the Python forms are the plain versions the native
codec is held against.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


# ---------------------------------------------------------------------------
# RLE codecs (COCO column-major RLE; compressed string format of maskUtils)
# ---------------------------------------------------------------------------


def rle_decode_counts(counts: Sequence[int], h: int, w: int,
                      use_native: bool = True) -> np.ndarray:
    """Decode uncompressed column-major run lengths to an (h, w) uint8 mask.

    Uses the native C++ codec (data/_native/rle.cpp) when available.
    """
    if use_native:
        from . import native

        out = native.rle_decode_native(counts, h, w)
        if out is not None:
            return out
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def rle_encode(mask: np.ndarray) -> Dict[str, Any]:
    """Encode an (h, w) binary mask to uncompressed COCO RLE."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
    # runs of equal values, starting with 0s
    change = np.flatnonzero(np.diff(flat)) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def _leb_string_decode(s: Union[str, bytes], use_native: bool = True) -> List[int]:
    """Decode the pycocotools compressed counts string (signed LEB128-ish
    with delta coding from the second value on)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    if use_native:
        from . import native

        native_out = native.leb_decode_native(bytes(s))
        if native_out is not None:
            return native_out
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _leb_string_encode(counts: Sequence[int]) -> str:
    """Inverse of `_leb_string_decode` (maskUtils rleToString)."""
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def rle_decode(rle: Dict[str, Any]) -> np.ndarray:
    """Decode COCO RLE (compressed or uncompressed) to an (h, w) mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _leb_string_decode(counts)
    return rle_decode_counts(counts, h, w)


# ---------------------------------------------------------------------------
# Polygon rasterisation
# ---------------------------------------------------------------------------


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int,
                     use_native: bool = True) -> np.ndarray:
    """Rasterise COCO polygon lists ([x1, y1, x2, y2, ...] flat) to a mask.

    Prefers the native C++ scanline rasteriser; PIL fallback otherwise.
    """
    if use_native:
        from . import native

        out = native.rasterize_polygons_native(polygons, h, w)
        if out is not None:
            return out
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def ann_to_mask(ann: Dict[str, Any], h: int, w: int) -> np.ndarray:
    """Segmentation (polygons / RLE / uncompressed RLE) -> (h, w) uint8."""
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        return rle_decode(seg)
    raise ValueError(f"unsupported segmentation type: {type(seg)}")


# ---------------------------------------------------------------------------
# Annotation index
# ---------------------------------------------------------------------------


class COCOIndex:
    """Lightweight COCO annotation index (the pycocotools.COCO subset the
    reference uses: getImgIds / getAnnIds / loadImgs / loadAnns / annToMask).
    """

    def __init__(self, annotation_file: Union[str, Path, Dict[str, Any]]):
        if isinstance(annotation_file, (str, Path)):
            data = json.loads(Path(annotation_file).read_text())
        else:
            data = annotation_file
        self.dataset = data
        self.imgs: Dict[int, Dict] = {img["id"]: img for img in data.get("images", [])}
        self.anns: Dict[int, Dict] = {ann["id"]: ann for ann in data.get("annotations", [])}
        self.img_to_anns: Dict[int, List[int]] = {i: [] for i in self.imgs}
        for ann in data.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann["id"])

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_ann_ids(self, img_id: int, iscrowd: Optional[bool] = None) -> List[int]:
        ids = self.img_to_anns.get(img_id, [])
        if iscrowd is None:
            return list(ids)
        return [i for i in ids if bool(self.anns[i].get("iscrowd", 0)) == iscrowd]

    def load_imgs(self, ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def load_anns(self, ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def ann_to_mask(self, ann: Dict[str, Any]) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        return ann_to_mask(ann, img["height"], img["width"])
