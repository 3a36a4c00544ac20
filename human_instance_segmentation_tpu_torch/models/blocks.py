"""Shared conv blocks of the stage-2 heads and the RGB extractor (NCHW).

Counterpart of the JAX package's ``models/blocks.py``. Parameter names
follow the JAX tree (``conv``/``norm``, ``conv1``/``norm1``/``conv2``/
``norm2``, ``deconv``), so ``weights.from_jax_params`` maps it leaf by
leaf.

``ConvNormAct`` and ``ResidualBlock`` take the fused CUDA kernel
(``ops/cuda_head.py``) under the JAX package's gate: eval mode, the
``fused_head`` flag on (set by the inference engine through
:func:`set_head_fusion`; JAX's thread-local ``head_fusion()`` context),
LayerNorm2d + ReLU, and a tiny-spatial high-channel shape. Outside it
their norm, residual add, activation and the int8 quantize between a
ResidualBlock's convs run through :func:`..ops.cuda_norm.norm_act` (the
LayerNorm2d kernel pair when serving on CUDA).

Their convs are :class:`..ops.quant.QConv`. Under int8 serving (set by
:func:`..ops.quant.set_int8_serving`) the JAX package's two rules hold: an
int8 input is never fused, and a fused unit whose conv has a calibrated
scale takes it as ``xscale`` (blocks.py:70-85). :func:`prequantize_for` is
the producer-side quantization point (blocks.py:40).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_head
from ..ops.activations import get_activation
from ..ops.cuda_norm import norm_act
from ..ops.norms import get_normalization
from ..ops.quant import MIN_INT8_CONTRACTION, QConv
from ..ops.s2d import quantize_static


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _hwio(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()


_NO_FUSE = object()


def producer_scale(conv: QConv, channels: int, k: int = 3) -> Optional[float]:
    """The calibrated scale at which a producer quantizes a ``channels``-wide
    map for its single consumer ``conv`` (the producer-side quantize of
    blocks.py:40), or None whenever the consumer would not run int8:
    serving off, denied, a contraction below 48 or no calibrated scale."""
    if not conv.serving or conv.denied or k * k * channels < MIN_INT8_CONTRACTION:
        return None
    return conv.static_scale


def prequantize_for(conv: QConv, x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Quantize x to int8 for its single consumer ``conv`` at
    :func:`producer_scale`; x unchanged where that is None or x is already
    int8."""
    scale = None if x.dtype == torch.int8 else producer_scale(conv, x.shape[1], k)
    return x if scale is None else quantize_static(x, scale)


def _fused_xscale(conv: QConv, x: torch.Tensor, k: int):
    """The fused kernel's activation scale (blocks.py:70): None outside int8
    serving or for a denied conv (the kernel runs in x's dtype), the
    calibrated scale, or ``_NO_FUSE`` when int8 serving is on but the conv
    has no calibrated scale (then the unfused QConv path runs)."""
    if not conv.serving or conv.denied:
        return None
    if conv.static_scale is None or k * k * x.shape[1] < MIN_INT8_CONTRACTION:
        return _NO_FUSE
    return conv.static_scale


class _Fusable(nn.Module):
    """Holds the ``fused_head`` flag and the fused-kernel gate."""

    norm_type: str
    activation: str
    features: int

    def __init__(self):
        super().__init__()
        self.fused_head = False

    def _conv_ln_act(self, x: torch.Tensor, conv: QConv, norm: nn.Module, residual=None, *,
                     xscale=None, **kwargs) -> torch.Tensor:
        """The fused unit on NHWC x with ``conv``'s and ``norm``'s parameters.
        Its int8 form, and its bf16 form at the wgmma kernel's shapes, get the
        prepared operands that ``conv`` keeps until a parameter (or the
        scale) changes, and the weight only as a view."""
        prepared = None
        if xscale is None and x.dtype == torch.bfloat16 and cuda_head.wgmma_shape(
                x.shape[-1], conv.out_channels):
            w = conv.weight.permute(2, 3, 1, 0).to(x.dtype)  # a view of bf16 weights
            prepared = conv.cached(
                "fused_bf16", (conv.weight, conv.bias, norm.weight, norm.bias), (x.dtype,),
                lambda: cuda_head.prepare_bf16(w, conv.bias, norm.weight, norm.bias))
        elif xscale is None:
            w = _hwio(conv, x.dtype)
        else:
            w = conv.weight.permute(2, 3, 1, 0)
            prepared = conv.cached(
                "fused", (conv.weight, conv.bias, norm.weight, norm.bias), (x.dtype, xscale),
                lambda: cuda_head.prepare_s8(w.detach().to(x.dtype), xscale, conv.bias,
                                             norm.weight, norm.bias))
        return cuda_head.conv_ln_act(x, w, conv.bias, norm.weight, norm.bias, residual,
                                     xscale=xscale, prepared=prepared, **kwargs)

    def _fusable(self, x: torch.Tensor) -> bool:
        if self.training or not self.fused_head or x.dtype == torch.int8:
            return False
        if self.norm_type != "layernorm2d" or self.activation != "relu":
            return False
        _, ci, h, w = x.shape
        return cuda_head.fusable_shape(h, w, ci, self.features)


class ConvNormAct(_Fusable):
    """k x k conv (stride 1 or 2, padding k//2) -> norm -> activation."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 norm: str = "layernorm2d", activation: str = "relu", use_bias: bool = True,
                 norm_groups: int = 8, activation_beta: float = 1.0):
        super().__init__()
        self.features, self.kernel, self.stride = features, kernel, stride
        self.norm_type, self.activation = norm, activation
        self.conv = QConv(in_channels, features, kernel, stride=stride, padding=kernel // 2,
                          bias=use_bias)
        self.norm = get_normalization(norm, features, min(norm_groups, features))
        self.act = get_activation(activation, activation_beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        if (self.stride == 1 and k in (1, 3) and self.conv.bias is not None
                and self._fusable(x)):
            xs = _fused_xscale(self.conv, x, k)
            if xs is not _NO_FUSE:
                _, _, h, w = x.shape
                y = self._conv_ln_act(_nhwc(x), self.conv, self.norm, height=h, width=w,
                                      kernel=k, xscale=xs)
                return y.permute(0, 3, 1, 2)
        return norm_act(self.conv(x), self.norm, self.act)


class ResidualBlock(_Fusable):
    """conv3-norm-act-conv3-norm + skip -> act."""

    def __init__(self, features: int, norm: str = "layernorm2d", activation: str = "relu",
                 norm_groups: int = 8, activation_beta: float = 1.0):
        super().__init__()
        self.features, self.norm_type, self.activation = features, norm, activation
        g = min(norm_groups, features)
        self.conv1 = QConv(features, features, 3, padding=1)
        self.norm1 = get_normalization(norm, features, g)
        self.conv2 = QConv(features, features, 3, padding=1)
        self.norm2 = get_normalization(norm, features, g)
        self.act = get_activation(activation, activation_beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == self.features and self._fusable(x):
            xs1 = _fused_xscale(self.conv1, x, 3)
            xs2 = _fused_xscale(self.conv2, x, 3)
            if xs1 is not _NO_FUSE and xs2 is not _NO_FUSE:
                _, _, h, w = x.shape
                xh = _nhwc(x)
                y = self._conv_ln_act(xh, self.conv1, self.norm1, height=h, width=w, xscale=xs1)
                y = self._conv_ln_act(y, self.conv2, self.norm2, residual=xh, height=h, width=w,
                                      xscale=xs2)
                return y.permute(0, 3, 1, 2)
        # single-use internal boundary: int8 flows into conv2 (serving)
        h = norm_act(self.conv1(x), self.norm1, self.act,
                     qscale=producer_scale(self.conv2, self.features))
        return norm_act(self.conv2(h), self.norm2, self.act, residual=x)


class Dropout2d(nn.Module):
    """Channel-wise spatial dropout (the JAX package's ``Dropout2d``, torch
    ``nn.Dropout2d`` semantics): in training mode each (sample, channel)
    map is kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``,
    or zeroed; in eval mode, or at ``p = 0``, the identity. The masks are
    drawn from ``generator`` (set for each step by the train step through
    :func:`set_dropout_generator`), on x's device. Holds no parameters."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        shape = (x.shape[0], x.shape[1], 1, 1)
        u = torch.rand(shape, generator=self.generator, device=x.device, dtype=torch.float32)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def set_dropout_generator(module: nn.Module, generator) -> None:
    """Draw the masks of every :class:`Dropout2d` under ``module`` from
    ``generator`` (a ``torch.Generator`` on the model's device)."""
    for m in module.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator


class ConvTranspose2x(nn.Module):
    """2x upsampling transposed conv (k=2, s=2), held as ``deconv``.

    The JAX ``_TConv2x`` kernel's spatial taps are flipped relative to
    torch's ConvTranspose2d; ``weights.from_jax_params`` flips them.
    """

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_channels, features, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(x)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C*r^2, H, W) -> (B, C, H*r, W*r), channels ordered (C, r, r)
    major to minor: ``nn.PixelShuffle``, and the JAX ``pixel_shuffle`` on
    NHWC."""
    return F.pixel_shuffle(x, factor)


def set_head_fusion(module: nn.Module, enabled: bool) -> None:
    """Route every ConvNormAct/ResidualBlock under ``module`` through the
    fused unit (where its gate allows) or through the unfused chain."""
    for m in module.modules():
        if isinstance(m, _Fusable):
            m.fused_head = enabled
