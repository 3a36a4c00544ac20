"""Separable bilinear sampling (RoIAlign, resize) in plain PyTorch.

Counterpart of ``human_instance_segmentation_tpu/ops/sampling.py``. RoIAlign
is written as two dense products per ROI,

    out[n, :, :, c] = Wy[n] @ img[batch_idx[n], :, :, c] @ Wx[n].T

with hat-function rows ``max(0, 1 - |pos - j|)``, which reproduces
``grid_sample(mode='bilinear', padding_mode='zeros', align_corners=aligned)``
(the hat weights vanish outside the image, which is zeros padding). It is
the plain version of the CUDA gather kernel in ``ops/cuda_roi_align.py``.

Layout follows the JAX package: ``roi_align`` is NHWC. The resize helpers
take the two spatial ``axes`` so NCHW modules can call them too (NHWC,
``axes=(1, 2)``, by default).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Scale = Union[float, Tuple[float, float]]


def _as_hw(scale: Scale) -> Tuple[float, float]:
    if isinstance(scale, (tuple, list)):
        if len(scale) != 2:
            raise ValueError("spatial_scale tuple must be (scale_h, scale_w)")
        return float(scale[0]), float(scale[1])
    return float(scale), float(scale)


def bilinear_weight_matrix(pos: torch.Tensor, size: int, padding: str = "zeros") -> torch.Tensor:
    """(..., out) positions -> (..., out, size) hat weights.

    ``padding='zeros'``: out-of-range positions lose weight (grid_sample
    zeros); ``'edge'``: positions are clamped to [0, size-1] first.
    """
    if padding == "edge":
        pos = pos.clamp(0.0, size - 1.0)
    elif padding != "zeros":
        raise ValueError(f"unknown padding mode: {padding}")
    idx = torch.arange(size, dtype=pos.dtype, device=pos.device)
    return torch.clamp(1.0 - (pos[..., None] - idx).abs(), min=0.0)


def grid_sample_positions(lo: torch.Tensor, hi: torch.Tensor, out_size: int, aligned: bool) -> torch.Tensor:
    """Per-ROI 1-D sample positions in source pixel space:
    ``lo + linspace(0, 1, out) * (hi - lo)``, minus 0.5 unless ``aligned``.

    ``t`` is ``i / (out - 1)`` correctly rounded in float32, as
    ``jnp.linspace`` and the CUDA kernel compute it (an elementwise divide:
    PyTorch's CUDA divide by a Python scalar multiplies by the reciprocal).
    """
    if out_size == 1:
        t = torch.zeros(1, dtype=lo.dtype, device=lo.device)
    else:
        i = torch.arange(out_size, dtype=lo.dtype, device=lo.device)
        t = i / torch.full_like(i, out_size - 1)
    f = lo[..., None] + t * (hi - lo)[..., None]
    return f if aligned else f - 0.5


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_height: int,
    output_width: int,
    spatial_scale: Scale = (640.0, 640.0),
    aligned: bool = False,
) -> torch.Tensor:
    """Dynamic RoIAlign with grid_sample semantics, as separable products.

    features (B, H, W, C); rois (N, 5) rows ``[batch_idx, x1, y1, x2, y2]``
    normalised to [0, 1]. Sentinel rois (batch_idx < 0) read image 0; the
    caller masks them. Returns (N, oh, ow, C) in the features' dtype; the
    sampling runs in float32 (float64 for float64 features).
    """
    ssh, ssw = _as_hw(spatial_scale)
    B, H, W, _ = features.shape
    ct = torch.promote_types(features.dtype, torch.float32)
    rois = rois.to(ct)
    batch_idx = rois[:, 0].to(torch.int64).clamp(0, B - 1)
    pos_y = grid_sample_positions(rois[:, 2] * ssh, rois[:, 4] * ssh, output_height, aligned)
    pos_x = grid_sample_positions(rois[:, 1] * ssw, rois[:, 3] * ssw, output_width, aligned)
    wy = bilinear_weight_matrix(pos_y, H)  # (N, oh, H)
    wx = bilinear_weight_matrix(pos_x, W)  # (N, ow, W)
    sel = features.index_select(0, batch_idx).to(ct)  # (N, H, W, C)
    t = torch.einsum("nyh,nhwc->nywc", wy, sel)
    out = torch.einsum("nxw,nywc->nyxc", wx, t)
    return out.to(features.dtype)


def _upsample_2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 2x half-pixel bilinear upsample along one axis:
    out[2i] = 0.25 x[i-1] + 0.75 x[i], out[2i+1] = 0.75 x[i] + 0.25 x[i+1]
    (edge-clamped), i.e. ``F.interpolate(scale_factor=2, mode='bilinear',
    align_corners=False)`` along that axis."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    stacked = torch.stack([even, odd], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def upsample_2x_bilinear(x: torch.Tensor, axes: Sequence[int] = (1, 2)) -> torch.Tensor:
    """2x spatial upsample (half-pixel bilinear) over the two ``axes``."""
    return _upsample_2x_axis(_upsample_2x_axis(x, axes[0]), axes[1])


def resize_bilinear(
    x: torch.Tensor,
    height: int,
    width: int,
    method: str = "half_pixel",
    axes: Sequence[int] = (1, 2),
) -> torch.Tensor:
    """Bilinear resize matching ``F.interpolate(mode='bilinear',
    align_corners=False)`` (``method='half_pixel'``) or ``align_corners=True``
    (``method='align_corners'``), with border replication."""
    ay, ax = axes
    h, w = x.shape[ay], x.shape[ax]
    if (h, w) == (height, width):
        return x
    if method == "half_pixel" and (height, width) == (2 * h, 2 * w):
        return upsample_2x_bilinear(x, axes)

    def positions(o: int, s: int) -> torch.Tensor:
        j = torch.arange(o, dtype=torch.float32, device=x.device)
        if method == "half_pixel":
            return (j + 0.5) * (s / o) - 0.5
        if method == "align_corners":
            if o == 1:
                return torch.zeros(1, dtype=torch.float32, device=x.device)
            return j * ((s - 1) / (o - 1))
        raise ValueError(f"unknown resize method: {method}")

    ct = torch.promote_types(x.dtype, torch.float32)
    wy = bilinear_weight_matrix(positions(height, h), h, "edge").to(ct)  # (oh, h)
    wx = bilinear_weight_matrix(positions(width, w), w, "edge").to(ct)  # (ow, w)
    xf = x.to(ct).movedim((ay, ax), (-2, -1))  # (..., h, w)
    y = torch.matmul(torch.matmul(wy, xf), wx.t())  # (..., oh, ow)
    return y.movedim((-2, -1), (ay, ax)).to(x.dtype)
