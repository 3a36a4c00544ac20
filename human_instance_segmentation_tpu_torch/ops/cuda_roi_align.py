"""Gather RoIAlign: the counterpart of the JAX package's
``ops/pallas_roi_align.py::roi_align_pallas``.

The CUDA kernel is ``csrc/roi_align.cu`` (one thread per output element,
four bilinear taps). Its plain version is the separable-product
:func:`..sampling.roi_align`, re-exported here as :data:`roi_align_plain`:
the path for CPU tensors and the oracle the kernel is held against. Same
contract as ``ops.sampling.roi_align``; there is no channel limit.
"""

from __future__ import annotations

import torch

from . import _build
from .sampling import Scale, _as_hw
from .sampling import roi_align as roi_align_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["roi_align", "roi_align_plain"]


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_height: int,
    output_width: int,
    spatial_scale: Scale = (640.0, 640.0),
    aligned: bool = False,
) -> torch.Tensor:
    """features (B, H, W, C) float32/bfloat16; rois (N, 5)
    ``[batch_idx, x1, y1, x2, y2]`` in [0, 1] -> (N, oh, ow, C) in the
    features' dtype.

    A CPU tensor takes :data:`roi_align_plain`. A CUDA tensor launches the
    kernel or raises.
    """
    if features.dim() != 4:
        raise ValueError(f"features must be (B, H, W, C), got {tuple(features.shape)}")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"rois must be (N, 5), got {tuple(rois.shape)}")
    if features.device.type == "cpu":
        return roi_align_plain(features, rois, output_height, output_width,
                               spatial_scale=spatial_scale, aligned=aligned)
    if features.device.type != "cuda":
        raise RuntimeError(f"roi_align: no kernel for device {features.device}")
    if features.dtype not in _DTYPES:
        raise TypeError(f"roi_align kernel takes float32 or bfloat16, got {features.dtype}")
    if not features.is_contiguous():
        raise ValueError("features must be contiguous NHWC")
    if rois.device != features.device:
        raise ValueError("rois must be on the features' device")
    ssh, ssw = _as_hw(spatial_scale)
    b, h, w, c = features.shape
    n = rois.shape[0]
    rois32 = rois.to(torch.float32).contiguous()
    out = torch.empty((n, output_height, output_width, c), device=features.device,
                      dtype=features.dtype)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    err = _build.library().roi_align_launch(
        features.data_ptr(), rois32.data_ptr(), out.data_ptr(), b, h, w, c, n,
        output_height, output_width, ssh, ssw, int(aligned), _DTYPES[features.dtype], stream)
    roi_align.launches += 1
    _build.check(err, "roi_align")
    return out


roi_align.launches = 0
