"""Gather RoIAlign: the counterpart of the JAX package's
``ops/pallas_roi_align.py::roi_align_pallas``.

The CUDA kernel is ``csrc/roi_align.cu``: one thread per output pixel
covers every channel, and one launch crops one feature map
(:func:`roi_align`) or two maps of the same batch, size and dtype with one
ROI table (:func:`roi_align_pair`: the model's RGB and logit crops). Each
map is read through its strides, so an NCHW tensor viewed as NHWC needs no
copy; the crops are contiguous NHWC. ``roi_align.launches`` counts the
kernel's launches from either entry point.

Its plain version is the separable-product :func:`..sampling.roi_align`,
re-exported here as :data:`roi_align_plain`: the path for CPU tensors (and
for any inside :func:`._build.plain`) and the oracle the kernel is held
against. Same contract as
``ops.sampling.roi_align``; there is no channel limit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .sampling import Scale, _as_hw
from .sampling import roi_align as roi_align_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1  # the kernel's index arithmetic within an image is 32-bit
_NO_MAP = (None, 0, 0, 0, 0, 0, None)

__all__ = ["roi_align", "roi_align_pair", "roi_align_plain"]


def _check(features: torch.Tensor, rois: torch.Tensor) -> None:
    if features.dim() != 4:
        raise ValueError(f"features must be (B, H, W, C), got {tuple(features.shape)}")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"rois must be (N, 5), got {tuple(rois.shape)}")


def _launch(maps, rois, output_height: int, output_width: int, spatial_scale: Scale,
            aligned: bool, name: str):
    """One kernel launch over one or two maps; returns their crops. Kept lean:
    the host's time to reach the launch is most of a served call's time."""
    dev = maps[0].device
    if rois.device != dev:
        raise ValueError(f"{name}: rois must be on the features' device")
    if rois.dtype != torch.float32 or not rois.is_contiguous():
        rois = rois.to(torch.float32).contiguous()
    dtype = maps[0].dtype
    code = _DTYPES.get(dtype)
    if code is None:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dtype}")
    b, h, w, _ = maps[0].shape
    n = rois.shape[0]
    if n * output_height * output_width > _INT_MAX:
        raise ValueError(f"{name}: at most 2^31 - 1 output pixels per launch")
    args, outs = [], []
    for m in maps:
        if m.device != dev:
            raise ValueError(f"{name}: the maps must be on one device")
        sb, sy, sx, sc = m.stride()
        c = m.shape[3]
        if (h - 1) * sy + (w - 1) * sx + (c - 1) * sc > _INT_MAX:
            raise ValueError(f"{name}: an image of the map spans more than 2^31 - 1 elements")
        out = torch.empty((n, output_height, output_width, c), device=dev, dtype=dtype)
        args += (m.data_ptr(), sb, sy, sx, sc, c, out.data_ptr())
        outs.append(out)
    if len(maps) == 1:
        args += _NO_MAP
    ssh, ssw = _as_hw(spatial_scale)
    err = _build.library().roi_align_launch(
        *args, rois.data_ptr(), b, h, w, n, output_height, output_width, ssh, ssw, int(aligned),
        code, _build.current_stream(dev))
    roi_align.launches += 1
    _build.check(err, name)
    return tuple(outs)


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_height: int,
    output_width: int,
    spatial_scale: Scale = (640.0, 640.0),
    aligned: bool = False,
) -> torch.Tensor:
    """features (B, H, W, C) float32/bfloat16, any strides; rois (N, 5)
    ``[batch_idx, x1, y1, x2, y2]`` in [0, 1] -> (N, oh, ow, C) in the
    features' dtype.

    A CPU tensor (or any inside :func:`._build.plain`) takes
    :data:`roi_align_plain`. A CUDA tensor launches the kernel or raises.
    """
    _check(features, rois)
    if not _build.takes_kernel(features, "roi_align"):
        return roi_align_plain(features, rois, output_height, output_width,
                               spatial_scale=spatial_scale, aligned=aligned)
    return _launch((features,), rois, output_height, output_width, spatial_scale, aligned,
                   "roi_align")[0]


def roi_align_pair(
    first: torch.Tensor,
    second: torch.Tensor,
    rois: torch.Tensor,
    output_height: int,
    output_width: int,
    spatial_scale: Scale = (640.0, 640.0),
    aligned: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both crops of :func:`roi_align` with one ROI table: ``first`` (B, H,
    W, C1) and ``second`` (B, H, W, C2), both float32 or both bfloat16, any
    strides -> (N, oh, ow, C1), (N, oh, ow, C2), contiguous, in the maps'
    dtype.

    CPU tensors (or any inside :func:`._build.plain`) take
    :data:`roi_align_plain` once a map. CUDA tensors launch the kernel once
    or raise.
    """
    _check(first, rois)
    _check(second, rois)
    if first.shape[:3] != second.shape[:3] or first.dtype != second.dtype:
        raise ValueError(f"roi_align_pair: the maps must share batch, height, width and dtype, "
                         f"got {tuple(first.shape)} {first.dtype} and {tuple(second.shape)} "
                         f"{second.dtype}")
    if not any([_build.takes_kernel(m, "roi_align_pair") for m in (first, second)]):
        return tuple(roi_align_plain(m, rois, output_height, output_width,
                                     spatial_scale=spatial_scale, aligned=aligned).contiguous()
                     for m in (first, second))
    return _launch((first, second), rois, output_height, output_width, spatial_scale, aligned,
                   "roi_align_pair")


roi_align.launches = 0
