"""Attention modules (NCHW): squeeze-excite channel attention, spatial
attention, CBAM and the additive attention gate.

Counterpart of ``human_instance_segmentation_tpu/ops/attention.py``, with
its parameter names (``fc1``/``fc2``, ``conv``, ``channel``/``spatial``,
``W_g``/``W_x``/``psi``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .activations import get_activation
from .sampling import resize_bilinear


class ChannelAttention(nn.Module):
    """x * sigmoid(fc2(act(fc1(mean_hw(x))))), bias-free 1x1 convs with a
    bottleneck of max(C / reduction_ratio, min_channels)."""

    def __init__(self, channels: int, reduction_ratio: int = 8, min_channels: int = 8,
                 activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        bottleneck = max(channels // reduction_ratio, min_channels)
        self.act = get_activation(activation, activation_beta)
        self.fc1 = nn.Conv2d(channels, bottleneck, 1, bias=False)
        self.fc2 = nn.Conv2d(bottleneck, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.fc2(self.act(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(a)


class SpatialAttention(nn.Module):
    """x * sigmoid(conv_kxk([mean_c(x), max_c(x)])), one bias-free conv."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(stats))


class CBAM(nn.Module):
    """Channel attention, then spatial attention."""

    def __init__(self, channels: int, reduction_ratio: int = 8, kernel_size: int = 7,
                 activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        self.channel = ChannelAttention(channels, reduction_ratio, activation=activation,
                                        activation_beta=activation_beta)
        self.spatial = SpatialAttention(kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial(self.channel(x))


class AttentionGate(nn.Module):
    """Additive gate: x * sigmoid(psi(act(W_g(g) + W_x(x)))), with g resized
    bilinearly to x's size first."""

    def __init__(self, channels: int, gate_channels: int, inter_channels: Optional[int] = None,
                 activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        inter = inter_channels or max(channels // 2, 1)
        self.act = get_activation(activation, activation_beta)
        self.W_g = nn.Conv2d(gate_channels, inter, 1)
        self.W_x = nn.Conv2d(channels, inter, 1)
        self.psi = nn.Conv2d(inter, 1, 1)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if g.shape[2:] != x.shape[2:]:
            g = resize_bilinear(g, x.shape[2], x.shape[3], axes=(2, 3))
        psi = self.psi(self.act(self.W_g(g) + self.W_x(x)))
        return x * torch.sigmoid(psi)
