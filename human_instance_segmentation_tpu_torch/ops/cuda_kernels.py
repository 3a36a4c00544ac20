"""The post-processing kernels: exact bilateral filter and binary-mask edge
smoothing. Counterpart of the JAX package's ``ops/pallas_kernels.py``
(``bilateral_filter_pallas``, ``edge_smooth_pallas``).

The CUDA kernels are ``csrc/bilateral.cu`` and ``csrc/postprocess.cu``
(edge smoothing): each is one launch over the ``(B * C, H, W)`` float32
planes of an NHWC tensor, with the padding resolved inside the kernel
(reflect for the bilateral filter, zero for the edge smoothing). The
bilateral kernel folds the spatial weight into the range weight's exponent
(:func:`bilateral_rates`), so it takes no spatial table; the edge-smoothing
kernel walks strips of rows, a lane on four adjacent columns where the
width and the alignment allow (:func:`edge_smooth_vec`). Beside each is
its plain PyTorch version (:func:`bilateral_filter_plain`: k^2 shifted
multiply-adds, as the JAX package's ``models/postprocess.bilateral_filter``;
:func:`edge_smooth_plain`: two depthwise 3x3 convs, as its
``edge_smooth_binary_mask``): the path for CPU tensors and the oracle the
kernel is held against.
``models/postprocess.py`` exposes both under the JAX package's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

_MAX_PLANES = 65535  # gridDim.z
_LOG2E = 1.4426950408889634

_LAPLACIAN = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))
_GAUSS3 = ((1 / 16, 2 / 16, 1 / 16), (2 / 16, 4 / 16, 2 / 16), (1 / 16, 2 / 16, 1 / 16))

__all__ = ["bilateral_filter", "bilateral_filter_plain", "bilateral_rates", "depthwise_conv2d",
           "edge_smooth", "edge_smooth_plain", "edge_smooth_vec", "gaussian_kernel_2d"]


def depthwise_conv2d(x: torch.Tensor, kernel2d) -> torch.Tensor:
    """SAME (zero-padded) depthwise conv of an NHWC tensor with one 2-D
    kernel shared by every channel; odd kernel sizes."""
    k2 = torch.as_tensor(kernel2d, dtype=x.dtype, device=x.device)
    kh, kw = k2.shape
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), k2.expand(c, 1, kh, kw), padding=(kh // 2, kw // 2),
                 groups=c)
    return y.permute(0, 2, 3, 1)


def gaussian_kernel_2d(kernel_size: int, sigma: float, normalized: bool = True,
                       device=None) -> torch.Tensor:
    """(k, k) float32 ``exp(-d^2 / (2 sigma^2))``, summing to 1 if ``normalized``."""
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2
    d2 = coords[:, None] ** 2 + coords[None, :] ** 2
    k = torch.exp(-d2 / (2.0 * sigma ** 2))
    return k / k.sum() if normalized else k


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> contiguous float32 (B * C, H, W); a view when C == 1."""
    b, h, w, c = x.shape
    return x.permute(0, 3, 1, 2).reshape(b * c, h, w).to(torch.float32).contiguous()


def _unplanes(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    b, h, w, c = like.shape
    return p.reshape(b, c, h, w).permute(0, 2, 3, 1).to(like.dtype)


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, W, C), got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"{name}: expected a floating tensor, got {x.dtype}")


def _kernel_device(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.shape[0] * x.shape[3] > _MAX_PLANES:
        raise ValueError(f"{name}: at most {_MAX_PLANES} planes (B * C) per launch")


def bilateral_filter_plain(x: torch.Tensor, kernel_size: int = 5, sigma_spatial: float = 1.0,
                           sigma_range: float = 0.1) -> torch.Tensor:
    """Exact bilateral filter of (B, H, W, C): reflect padding, unnormalised
    Gaussian spatial weight x Gaussian range weight, ``num / (den + 1e-8)``,
    the k^2 taps summed row-major."""
    _check(x, "bilateral_filter")
    pad = kernel_size // 2
    if pad >= x.shape[1] or pad >= x.shape[2]:
        raise ValueError("bilateral_filter: reflect padding needs kernel_size // 2 < H and W")
    spatial = gaussian_kernel_2d(kernel_size, sigma_spatial, normalized=False, device=x.device)
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect").permute(0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for di in range(kernel_size):
        for dj in range(kernel_size):
            shifted = xp[:, di:di + h, dj:dj + w]
            wgt = spatial[di, dj].to(x.dtype) * torch.exp(
                -((shifted - x) ** 2) / (2.0 * sigma_range ** 2))
            num = num + wgt * shifted
            den = den + wgt
    return num / (den + 1e-8)


def bilateral_rates(kernel_size: int, sigma_spatial: float, sigma_range: float) -> tuple:
    """The kernel's exponent rates ``(a_s, a_r) = log2(e) / (2 sigma^2)`` of
    the spatial and the range Gaussian, after checking what the kernel takes:
    an odd positive ``kernel_size`` and positive sigmas."""
    if kernel_size < 1 or kernel_size % 2 == 0:
        raise ValueError(f"bilateral_filter: kernel_size must be odd and positive, got {kernel_size}")
    if not (sigma_spatial > 0 and sigma_range > 0):
        raise ValueError("bilateral_filter: sigmas must be positive")
    return _LOG2E / (2.0 * sigma_spatial ** 2), _LOG2E / (2.0 * sigma_range ** 2)


def bilateral_filter(x: torch.Tensor, kernel_size: int = 5, sigma_spatial: float = 1.0,
                     sigma_range: float = 0.1) -> torch.Tensor:
    """:func:`bilateral_filter_plain`'s function. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (float32 planes, the result
    cast back to x's dtype) or raises."""
    _check(x, "bilateral_filter")
    if x.device.type == "cpu":
        return bilateral_filter_plain(x, kernel_size, sigma_spatial, sigma_range)
    _kernel_device(x, "bilateral_filter")
    a_s, a_r = bilateral_rates(kernel_size, sigma_spatial, sigma_range)
    pad = kernel_size // 2
    if pad >= x.shape[1] or pad >= x.shape[2]:
        raise ValueError("bilateral_filter: reflect padding needs kernel_size // 2 < H and W")
    planes = _planes(x)
    p, h, w = planes.shape
    out = torch.empty_like(planes)
    err = _build.library().bilateral_filter_launch(
        planes.data_ptr(), out.data_ptr(), p, h, w, kernel_size, a_s, a_r,
        _build.current_stream(x.device))
    bilateral_filter.launches += 1
    _build.check(err, "bilateral_filter")
    return _unplanes(out, x)


bilateral_filter.launches = 0


def edge_smooth_plain(mask: torch.Tensor, threshold: float = 0.5,
                      blur_strength: float = 3.0) -> torch.Tensor:
    """Binary-mask edge smoothing of (B, H, W, C) in float32: |3x3 Laplacian|
    -> sigmoid(. * blur_strength) -> blend with the 1-2-1 blur -> ``>
    threshold``, zero padding; returned in the mask's dtype."""
    _check(mask, "edge_smooth")
    m = mask.to(torch.float32)
    edges = depthwise_conv2d(m, _LAPLACIAN).abs()
    edge_w = torch.sigmoid(edges * blur_strength)
    blurred = depthwise_conv2d(m, _GAUSS3)
    smoothed = m * (1.0 - edge_w) + blurred * edge_w
    return (smoothed > threshold).to(mask.dtype)


def edge_smooth_vec(planes: torch.Tensor, out: torch.Tensor) -> int:
    """Columns a lane of the edge-smoothing kernel: 4 (one 16-byte load and
    store a row) when the width is a multiple of 4 and both planes start on
    16 bytes, else 1 (any width and alignment)."""
    aligned = planes.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return 4 if planes.shape[-1] % 4 == 0 and aligned else 1


def edge_smooth(mask: torch.Tensor, threshold: float = 0.5,
                blur_strength: float = 3.0) -> torch.Tensor:
    """:func:`edge_smooth_plain`'s function. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (its four-column form where
    :func:`edge_smooth_vec` allows, else its one-column form) or raises."""
    _check(mask, "edge_smooth")
    if mask.device.type == "cpu":
        return edge_smooth_plain(mask, threshold, blur_strength)
    _kernel_device(mask, "edge_smooth")
    planes = _planes(mask)
    p, h, w = planes.shape
    out = torch.empty_like(planes)
    vec = edge_smooth_vec(planes, out)
    err = _build.library().edge_smooth_launch(
        planes.data_ptr(), out.data_ptr(), p, h, w, vec, blur_strength, threshold,
        _build.current_stream(mask.device))
    edge_smooth.launches += 1
    edge_smooth.last_vec = vec
    _build.check(err, "edge_smooth")
    return _unplanes(out, mask)


edge_smooth.launches = 0
edge_smooth.last_vec = None  # the form of the latest launch: columns a lane
