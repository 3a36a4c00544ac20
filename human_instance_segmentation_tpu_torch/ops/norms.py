"""LayerNorm2d and eval-mode BatchNorm2d (NCHW modules).

Counterpart of ``human_instance_segmentation_tpu/ops/norms.py``: only the
two norms the flagship serves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm2d(nn.Module):
    """LayerNorm over (C, H, W) jointly per sample, per-channel affine.

    Statistics in float32 with the biased variance and eps 1e-5; the
    normalised map is cast back to the input dtype before the affine, as
    the JAX module does.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class BatchNorm2d(nn.Module):
    """Inference BatchNorm: running statistics only, no update.

    Holds exactly ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` (no ``num_batches_tracked``), the four leaves the JAX
    package's ``nn.BatchNorm`` keeps.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


def get_normalization(norm_type: str, channels: int) -> nn.Module:
    if norm_type.lower() in ("layer", "layernorm", "layernorm2d"):
        return LayerNorm2d(channels)
    raise NotImplementedError(f"normalization {norm_type!r} is not ported yet")
