"""Max/average pooling, dilation and erosion of NHWC maps (torch pooling
semantics)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Max pool over H, W of an NHWC tensor with implicit -inf padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding)
    return y.permute(0, 2, 3, 1)


def dilate(x: torch.Tensor, pixels: int) -> torch.Tensor:
    """Dilation by ``pixels`` via a stride-1 (2p+1) max pool."""
    if pixels <= 0:
        return x
    return max_pool2d(x, 2 * pixels + 1, 1, pixels)


def erode(x: torch.Tensor, pixels: int) -> torch.Tensor:
    """Erosion: ``1 - dilate(1 - x)``."""
    if pixels <= 0:
        return x
    return 1.0 - dilate(1.0 - x, pixels)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Average pool over H, W of an NHWC tensor; the zero padding counts
    (``count_include_pad=True``, torch's default)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding, count_include_pad=True)
    return y.permute(0, 2, 3, 1)
