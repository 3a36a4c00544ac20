"""Normalisation zoo (NCHW modules).

Counterpart of ``human_instance_segmentation_tpu/ops/norms.py``: the
factory ``get_normalization`` with the GroupNorm 8 -> 4 -> 2 -> 1 divisor
fallback, and every norm behind it. Module and leaf names follow the JAX
tree (``ZooBatchNorm2d``, the JAX ``BatchNorm2d``, holds its
``BatchNorm_0``, ``GroupNorm2d`` its
``GroupNorm_0``, ``MixedNormalization`` its ``BatchNorm2d_0`` and
``InstanceNorm2d_0``, ``ForegroundAwareNorm`` its ``Conv_0`` and
``Conv_1``), so ``weights.from_jax_params`` maps them leaf by leaf.

Running statistics. :class:`BatchNorm2d` (flax's ``nn.BatchNorm``, also
the stage-1 BN) and :class:`AdaptiveInstanceNorm2d` update theirs in train
mode (Python scalars applied as JAX's weak typing applies them, rounded
to the operand's dtype first). Where the JAX package returns them from
``apply(..., mutable=["batch_stats"])`` and the step decides whether to keep them, here
a module writes its new statistics into its buffers, unless
:func:`deferred_running_stats` is active: then it hands them to the
collector, and the caller writes them (``training.steps`` does, after the
NaN guard). The values are flax's to the rounding: ``running = 0.9 *
running + 0.1 * batch`` with ``0.9 * running`` in the buffer's dtype, and
the *biased* batch variance as ``max(E[x^2] - E[x]^2, 0)`` in float32
(flax 0.12's ``use_fast_variance``). ``F.batch_norm(training=True)`` is not
used: it keeps the unbiased variance and reads momentum the other way
round.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (module, buffer name) -> new value, while deferred_running_stats() is active
_COLLECTOR: Optional[Dict[Tuple[nn.Module, str], torch.Tensor]] = None


@contextlib.contextmanager
def deferred_running_stats() -> Iterator[Dict[Tuple[nn.Module, str], torch.Tensor]]:
    """Within the block, modules in train mode leave their running-statistic
    buffers alone and put the new values into the yielded dict, keyed by
    ``(module, buffer name)``; the caller writes them (or drops them)."""
    global _COLLECTOR
    prev, _COLLECTOR = _COLLECTOR, {}
    try:
        yield _COLLECTOR
    finally:
        _COLLECTOR = prev


def _update_running(module: nn.Module, name: str, value: torch.Tensor) -> None:
    value = value.detach()
    if _COLLECTOR is not None:
        _COLLECTOR[(module, name)] = value
        return
    with torch.no_grad():
        getattr(module, name).copy_(value)


def _weak(value: float, t: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing applies it to ``t``: rounded to
    t's dtype first (0.9 * a bf16 array multiplies by bf16(0.9))."""
    return _rounded(value, t.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def running_stat_modules(model: nn.Module):
    """Every module under ``model`` that keeps running statistics (its
    ``running_mean`` and ``running_var`` buffers: the JAX ``batch_stats``)."""
    return [m for m in model.modules() if isinstance(m, (BatchNorm2d, AdaptiveInstanceNorm2d))]


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over (C, H, W) jointly per sample of NCHW x, per-channel
    affine: statistics in float32 with the biased variance, the normalised
    map cast back to x's dtype before the affine, as the JAX module does.
    ``stats``, (N, 2) float32 means and biased variances, stands for the
    statistics, which are then not computed."""
    xf = x.to(torch.float32)
    if stats is None:
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    else:
        mean, var = (stats[:, i].view(-1, 1, 1, 1) for i in (0, 1))
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight[:, None, None] + bias[:, None, None]


class LayerNorm2d(nn.Module):
    """LayerNorm over (C, H, W) jointly per sample, per-channel affine
    (:func:`layer_norm_2d`, eps 1e-5). Served chains of it run through
    :func:`.cuda_norm.norm_act`."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias, self.eps)


class BatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm(momentum)`` over (B, H, W) of NCHW x.

    Holds exactly ``weight``, ``bias``, ``running_mean`` and
    ``running_var`` (no ``num_batches_tracked``), the four leaves flax
    keeps. Eval mode normalises with the running statistics. Train mode
    normalises with the batch statistics, computed in float32 or x's wider
    dtype (the output cast back to x's dtype once, as flax does), and
    updates the running ones (see the module docstring).
    """

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # flax's sense: running = m * running + (1 - m) * batch
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        m, ra_mean, ra_var = self.momentum, self.running_mean, self.running_var
        _update_running(self, "running_mean", _weak(m, ra_mean) * ra_mean + (1 - m) * mean)
        _update_running(self, "running_var", _weak(m, ra_var) * ra_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class ZooBatchNorm2d(nn.Module):
    """The zoo's BatchNorm (the JAX ``BatchNorm2d``: momentum 0.9, eps
    1e-5), holding its :class:`BatchNorm2d` as ``BatchNorm_0``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.BatchNorm_0 = BatchNorm2d(channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(x)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: statistics over (C/G, H, W) per group, in
    float32 (or x's wider dtype) with the fast variance, per-channel affine."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xg = xf.reshape(b, g, c // g, h, w)
        mean = xg.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, min=0.0)

        def per_channel(v):  # (b, g, 1, 1, 1) -> (b, c, 1, 1)
            return v.expand(b, g, c // g, 1, 1).reshape(b, c, 1, 1)

        mul = per_channel(torch.rsqrt(var + self.eps)) * self.weight[:, None, None]
        y = (xf - per_channel(mean)) * mul + self.bias[:, None, None]
        return y.to(x.dtype)


class GroupNorm2d(nn.Module):
    """JAX ``GroupNorm2d``: its :class:`GroupNorm` as ``GroupNorm_0``."""

    def __init__(self, channels: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels, num_groups, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


def _instance_stats(x: torch.Tensor):
    """Per-sample, per-channel mean and biased variance over (H, W), in x's
    dtype (the JAX modules reduce x as it is)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return mean, var


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalisation over (H, W), optional affine."""

    def __init__(self, channels: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _instance_stats(x)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y


class AdaptiveInstanceNorm2d(nn.Module):
    """Instance norm + affine that also tracks running statistics (the
    batch mean of the instance means and variances, momentum 0.1 in torch's
    sense); the forward always uses the instance statistics."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _instance_stats(x)
        if self.training:
            m, ra_mean, ra_var = self.momentum, self.running_mean, self.running_var
            bm, bv = mean.mean(dim=0).reshape(-1), var.mean(dim=0).reshape(-1)
            _update_running(self, "running_mean",
                            _weak(1 - m, ra_mean) * ra_mean + _weak(m, bm) * bm)
            _update_running(self, "running_var",
                            _weak(1 - m, ra_var) * ra_var + _weak(m, bv) * bv)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class ForegroundAwareNorm(nn.Module):
    """Instance norm whose affine blends a foreground and a background pair
    by a learned foreground map: two 1x1 convs (``Conv_0`` C -> max(C/4, 1),
    ReLU, ``Conv_1`` -> 1, sigmoid) on ``x.detach()``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.Conv_0 = nn.Conv2d(channels, max(channels // 4, 1), 1)
        self.Conv_1 = nn.Conv2d(max(channels // 4, 1), 1, 1)
        self.fg_scale = nn.Parameter(torch.ones(channels))
        self.fg_bias = nn.Parameter(torch.zeros(channels))
        self.bg_scale = nn.Parameter(torch.ones(channels))
        self.bg_bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _instance_stats(x)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        fg = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(x.detach()))))
        bg = 1.0 - fg

        def c(v):
            return v[:, None, None]

        scale = fg * c(self.fg_scale) + bg * c(self.bg_scale)
        bias = fg * c(self.fg_bias) + bg * c(self.bg_bias)
        return y * scale + bias


class MixedNormalization(nn.Module):
    """``mix * BatchNorm + (1 - mix) * InstanceNorm`` in train mode,
    BatchNorm alone in eval mode.

    The JAX module creates its ``InstanceNorm2d_0`` parameters only when it
    is initialised in train mode (a model initialised for eval has none,
    and cannot train); the port always holds them, at flax's initial values
    (scale 1, bias 0), and ``weights.from_jax_params`` leaves them at those
    values when the JAX tree lacks them.
    """

    def __init__(self, channels: int, mix_ratio: float = 0.5):
        super().__init__()
        self.mix_ratio = mix_ratio
        self.BatchNorm2d_0 = ZooBatchNorm2d(channels)
        self.InstanceNorm2d_0 = InstanceNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.BatchNorm2d_0(x)
        if self.training:
            return self.mix_ratio * bn + (1.0 - self.mix_ratio) * self.InstanceNorm2d_0(x)
        return bn


def _group_fallback(channels: int, groups: int) -> int:
    if channels % groups == 0:
        return groups
    for g in (8, 4, 2, 1):
        if channels % g == 0:
            return g
    return 1


def get_normalization(norm_type: str, channels: int, num_groups: int = 8) -> nn.Module:
    """The JAX factory (``get_normalization_layer``), GroupNorm's divisor
    fallback included."""
    t = norm_type.lower()
    if t in ("layer", "layernorm", "layernorm2d"):
        return LayerNorm2d(channels)
    if t in ("batch", "batchnorm", "batchnorm2d"):
        return ZooBatchNorm2d(channels)
    if t in ("instance", "instancenorm", "instancenorm2d"):
        return InstanceNorm2d(channels)
    if t in ("group", "groupnorm", "spatial_group"):
        return GroupNorm2d(channels, _group_fallback(channels, num_groups))
    if t == "adaptive_instance":
        return AdaptiveInstanceNorm2d(channels)
    if t == "foreground_aware":
        return ForegroundAwareNorm(channels)
    if t == "mixed":
        return MixedNormalization(channels)
    raise ValueError(f"Unknown normalization type: {norm_type}")
