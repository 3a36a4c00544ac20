"""Deploy-time post-processing: dilation, edge smoothing, bilateral filters.

Counterpart of the JAX package's ``models/postprocess.py`` (all of it but
the ``_n4`` phase forms, which exist for the TPU's layout). Plain functions
on NHWC tensors; channels are processed together.

Two of them have a hand-written kernel (``ops/cuda_kernels.py``):
:func:`bilateral_filter` and :func:`edge_smooth_binary_mask`. On a CUDA
tensor they launch it; on a CPU tensor, or with ``use_kernel=False`` on any
device, they compute the plain version. Everything else is plain PyTorch on
every device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import cuda_kernels
from ..ops.cuda_kernels import depthwise_conv2d, gaussian_kernel_2d
from ..ops.morphology import dilate, max_pool2d


def mask_dilation_logit_boost(logits: torch.Tensor, dilation_pixels: int = 1) -> torch.Tensor:
    """softmax -> dilate the target-class probability by a (2d+1) max pool
    -> +2.0 on the target logit where the dilated probability exceeds the
    original by more than 0.1. logits (N, H, W, 3)."""
    if dilation_pixels <= 0:
        return logits
    target = torch.softmax(logits, dim=-1)[..., 1:2]
    dilated = dilate(target, dilation_pixels)
    boost = torch.where(dilated - target > 0.1, 2.0, 0.0).to(logits.dtype)
    return torch.cat([logits[..., 0:1], logits[..., 1:2] + boost, logits[..., 2:]], dim=-1)


_LAPLACIAN = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
_BLUR5_1D = (0.1, 0.2, 0.4, 0.2, 0.1)
_DIAG1 = ((0.1, 0.0, 0.0), (0.0, 0.8, 0.0), (0.0, 0.0, 0.1))
_DIAG2 = ((0.0, 0.0, 0.1), (0.0, 0.8, 0.0), (0.1, 0.0, 0.0))
_GAUSS5_1D = (0.0625, 0.25, 0.375, 0.25, 0.0625)


def _row(k1d):
    return (tuple(k1d),)


def _col(k1d):
    return tuple((v,) for v in k1d)


def edge_smooth_binary_mask(mask: torch.Tensor, threshold: float = 0.5,
                            blur_strength: float = 3.0, use_kernel: bool = True) -> torch.Tensor:
    """Binary-mask edge smoothing: Laplacian edge map -> sigmoid edge weight
    -> blend the 3x3 Gaussian blur in at edges -> re-binarise.
    mask (B, H, W, C) in {0, 1} (float)."""
    fn = cuda_kernels.edge_smooth if use_kernel else cuda_kernels.edge_smooth_plain
    return fn(mask, threshold, blur_strength)


def directional_edge_smooth(mask: torch.Tensor) -> torch.Tensor:
    """Direction-aware smoothing: Sobel orientation -> blend of horizontal,
    vertical and diagonal blurs weighted by cos^2 / sin^2 of the edge angle
    -> sigmoid(3 * magnitude) blend -> re-binarise. mask (B, H, W, C)."""
    m = mask.to(torch.float32)
    ex = depthwise_conv2d(m, _SOBEL_X)
    ey = depthwise_conv2d(m, _SOBEL_Y)
    mag = torch.sqrt(ex ** 2 + ey ** 2 + 1e-8)
    ang = torch.atan2(ey, ex)

    blur_h = depthwise_conv2d(m, _row(_BLUR5_1D))
    blur_v = depthwise_conv2d(m, _col(_BLUR5_1D))
    blur_d1 = depthwise_conv2d(m, _DIAG1)
    blur_d2 = depthwise_conv2d(m, _DIAG2)

    wh = torch.cos(ang) ** 2
    wv = torch.sin(ang) ** 2
    wd1 = torch.cos(ang - math.pi / 4) ** 2 * 0.5
    wd2 = torch.cos(ang + math.pi / 4) ** 2 * 0.5
    s = wh + wv + wd1 + wd2 + 1e-8
    blurred = (blur_h * wh + blur_v * wv + blur_d1 * wd1 + blur_d2 * wd2) / s

    ew = torch.sigmoid(mag * 3.0)
    smoothed = m * (1.0 - ew) + blurred * ew
    return (smoothed > 0.5).to(mask.dtype)


def adaptive_edge_smooth(mask: torch.Tensor, blur_strength: torch.Tensor,
                         edge_sensitivity: torch.Tensor,
                         final_threshold: torch.Tensor) -> torch.Tensor:
    """Per-sample parameterised smoothing: blur_strength (1-5),
    edge_sensitivity (0.5-2) and final_threshold (0.3-0.7), each (B,) or
    (B, 1). mask (B, H, W, C)."""
    m = mask.to(torch.float32)
    b = m.shape[0]
    bs = blur_strength.reshape(b, 1, 1, 1).to(torch.float32)
    es = edge_sensitivity.reshape(b, 1, 1, 1).to(torch.float32)
    ft = final_threshold.reshape(b, 1, 1, 1).to(torch.float32)

    edges = depthwise_conv2d(m, _LAPLACIAN).abs()
    edge_mask = (edges > 0.5 * es).to(torch.float32)
    smoothed_base = depthwise_conv2d(m, torch.full((5, 5), 1.0 / 25.0))
    blur_factor = bs / 3.0
    smoothed = m * (1.0 - blur_factor) + smoothed_base * blur_factor
    result = m * (1.0 - edge_mask) + smoothed * edge_mask
    return (result > ft).to(mask.dtype)


def optimized_edge_smooth(mask: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Throughput variant: separable 5-tap Gaussian, the fast sigmoid
    ``clip((x + 0.5) * 0.5, 0, 1)``, computed in reduced precision."""
    m = mask.to(dtype)
    edges = depthwise_conv2d(m, _LAPLACIAN)
    edge_abs_scaled = edges.abs() * 3.0
    blurred = depthwise_conv2d(depthwise_conv2d(m, _row(_GAUSS5_1D)), _col(_GAUSS5_1D))
    edge_w = ((edge_abs_scaled + 0.5) * 0.5).clamp(0.0, 1.0)
    smoothed = m * (1.0 - edge_w) + blurred * edge_w
    return (smoothed > 0.5).to(mask.dtype)


def multiclass_edge_smooth(logits: torch.Tensor, iterations: int = 1,
                           variant: str = "basic") -> torch.Tensor:
    """Smooth each argmax class plane: logits (B, H, W, C) -> (B, H, W, C)
    smoothed {0, 1} per-class masks."""
    fn = {"basic": edge_smooth_binary_mask, "directional": directional_edge_smooth,
          "optimized": optimized_edge_smooth}[variant]
    planes = F.one_hot(logits.argmax(dim=-1), logits.shape[-1]).to(logits.dtype)
    for _ in range(iterations):
        planes = fn(planes)
    return planes


def _gaussian_kernel_1d(kernel_size: int, sigma: float, device=None) -> torch.Tensor:
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2
    k = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def bilateral_filter(x: torch.Tensor, kernel_size: int = 5, sigma_spatial: float = 1.0,
                     sigma_range: float = 0.1, use_kernel: bool = True) -> torch.Tensor:
    """Exact bilateral filter: a sum over the k^2 window offsets with
    reflect padding, Gaussian spatial x Gaussian range weights.
    x (B, H, W, C)."""
    fn = cuda_kernels.bilateral_filter if use_kernel else cuda_kernels.bilateral_filter_plain
    return fn(x, kernel_size, sigma_spatial, sigma_range)


def fast_bilateral_filter(x: torch.Tensor, kernel_size: int = 5, sigma_spatial: float = 1.0,
                          sigma_range: float = 0.1, num_iterations: int = 2) -> torch.Tensor:
    """Separable Gaussian + variance-gated blend, iterated."""
    k1 = _gaussian_kernel_1d(kernel_size, sigma_spatial, x.device)
    kh, kv = k1[None, :], k1[:, None]
    c = x
    for _ in range(max(num_iterations, 1)):
        filtered = depthwise_conv2d(depthwise_conv2d(c, kh), kv)
        sq = depthwise_conv2d(depthwise_conv2d(c ** 2, kh), kv)
        var = (sq - filtered ** 2).clamp(min=0.0)
        ew = torch.exp(-var / (2.0 * sigma_range ** 2))
        c = ew * filtered + (1.0 - ew) * c
    return c


def guided_filter(x: torch.Tensor, guide: Optional[torch.Tensor] = None, radius: int = 2,
                  eps: float = 0.01) -> torch.Tensor:
    """Edge-preserving guided filter with a (2r+1) box."""
    if guide is None:
        guide = x
    k = 2 * radius + 1
    box = torch.full((k, k), 1.0 / (k * k))

    def bf(t):
        return depthwise_conv2d(t, box)

    mean_x, mean_g = bf(x), bf(guide)
    cov = bf(x * guide) - mean_x * mean_g
    var = bf(guide * guide) - mean_g * mean_g
    a = cov / (var + eps)
    b = mean_x - a * mean_g
    return bf(a) * guide + bf(b)


def binary_mask_bilateral(x: torch.Tensor, kernel_size: int = 7, sigma_spatial: float = 1.5,
                          threshold: float = 0.5, num_iterations: int = 2) -> torch.Tensor:
    """Iterative edge-aware smoothing + threshold for binary masks."""
    g = gaussian_kernel_2d(kernel_size, sigma_spatial, device=x.device)
    m = x.clamp(0.0, 1.0)
    for _ in range(num_iterations):
        filtered = depthwise_conv2d(m, g)
        var = (depthwise_conv2d(m ** 2, g) - filtered ** 2).clamp(min=0.0)
        ew = torch.exp(-var * 10.0)
        m = ew * filtered + (1.0 - ew) * m
    return (m > threshold).to(x.dtype)


def morphological_bilateral(x: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0,
                            morph_size: int = 3) -> torch.Tensor:
    """Open -> Gaussian blur -> close -> threshold."""
    p = morph_size // 2
    m = x.clamp(0.0, 1.0)
    opened = max_pool2d(-max_pool2d(-m, morph_size, 1, p), morph_size, 1, p)
    blurred = depthwise_conv2d(opened, gaussian_kernel_2d(kernel_size, sigma, device=x.device))
    closed = -max_pool2d(-max_pool2d(blurred, morph_size, 1, p), morph_size, 1, p)
    return (closed > 0.5).to(x.dtype)


def binary_mode(unet: torch.nn.Module, images: torch.Tensor, use_kernel: bool = True,
                kernel_size: int = 7, num_iterations: int = 2,
                dilation_pixels: int = 1) -> Dict[str, torch.Tensor]:
    """Binary-mask serving, the JAX bench's pipeline
    (``scripts/bench_baseline_configs.py:106-160``, its plain form; the
    ``_n4`` form is TPU layout): the stage-1 UNet (``images`` (B, H, W, 3)
    NHWC; a ``pallas_tail`` UNet ends in its fused tail) -> the person
    probability ``sigmoid(logit)`` in float32 -> :func:`binary_mask_bilateral`
    (``kernel_size``, ``num_iterations``) -> :func:`edge_smooth_binary_mask`
    -> dilation by ``dilation_pixels``, cast to the images' dtype. Returns
    every stage, each (B, H, W, 1): ``prob``, ``smoothed``, ``edged`` and
    ``mask``. ``use_kernel=False`` takes the fused tail's and the edge
    smoothing's plain versions on any device (the UNet's own switch is
    restored after). Runs without autograd."""
    was = getattr(unet, "tail_use_kernel", None)
    if was is not None:
        unet.tail_use_kernel = use_kernel
    try:
        with torch.inference_mode():
            form, logit = unet(images.permute(0, 3, 1, 2), raw=True)
            logit = logit[..., None] if form == "dense" else logit.permute(0, 2, 3, 1)
            prob = torch.sigmoid(logit.float())
            smoothed = binary_mask_bilateral(prob, kernel_size=kernel_size,
                                             num_iterations=num_iterations)
            edged = edge_smooth_binary_mask(smoothed, use_kernel=use_kernel)
            mask = dilate(edged, dilation_pixels).to(images.dtype)
    finally:
        if was is not None:
            unet.tail_use_kernel = was
    return {"prob": prob, "smoothed": smoothed, "edged": edged, "mask": mask}
