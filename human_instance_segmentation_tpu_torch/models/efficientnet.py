"""EfficientNet encoders (NCHW) with the five UNet feature taps.

Counterpart of the JAX package's ``models/efficientnet.py`` without its
space-to-depth front: MBConv + squeeze-excite, SiLU, BatchNorm eps 1e-3
(flax's, momentum 0.9: batch statistics and a running update in train
mode, ``ops.norms.BatchNorm2d``), and TF ``'SAME'`` padding.
``EfficientNetEncoder(fused_blocks=N)`` runs the first N MBConv blocks
through the fused kernel (``ops/cuda_mbconv``) in eval mode only, as the
JAX encoder gates it (``fused_blocks=0 if train``): the fused block folds
the running statistics, so it cannot serve a training forward. At stride 2
SAME padding is asymmetric (480 -> 240 with k=3 pads (0, 1), with k=5
(1, 2)); a symmetric ``padding=k//2`` would shift every stride-2 output by
a pixel, so :class:`Conv2dSame` pads explicitly and convolves unpadded.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_mbconv
from ..ops.norms import BatchNorm2d
from ..ops.quant import QConv

# (expand_ratio, kernel, stride, out_channels, num_repeat) for B0
_B0_STAGES = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)

# (width_mult, depth_mult, default drop_rate)
VARIANTS = {
    "tiny": (0.25, 0.25, 0.0),  # test variant: 7 blocks, 8-ch stem
    "b0": (1.0, 1.0, 0.2),
    "b1": (1.0, 1.1, 0.2),
    "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3),
    "b4": (1.4, 1.8, 0.4),
    "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5),
    "b7": (2.0, 3.1, 0.5),
}

_BN_EPS = 1e-3


def round_channels(c: float, width_mult: float, divisor: int = 8) -> int:
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Conv2d with TF/XLA 'SAME' padding (explicit, possibly asymmetric)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        top, bottom = _same_pads(x.shape[-2], kh, sh)
        left, right = _same_pads(x.shape[-1], kw, sw)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, squeeze_channels, 1)
        self.expand = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation.

    The SE squeeze width is ``int(in_ch * se_ratio)`` of the block input,
    not of the expanded width.

    ``fused=True`` (eval mode only, a block with squeeze-excitation) computes
    the same function through ``ops/cuda_mbconv.fused_mbconv``: the three BNs
    folded into the convs, the folded weights cast to the activation dtype;
    the hand-written CUDA kernel on a CUDA tensor, its plain version on the
    CPU or with ``use_kernel = False``. Same parameters by name.
    """

    def __init__(self, in_channels: int, out_channels: int, expand_ratio: int, kernel: int,
                 stride: int, se_ratio: float = 0.25, fused: bool = False):
        super().__init__()
        mid = in_channels * expand_ratio
        self.kernel = kernel
        self.stride = stride
        self.fused = fused
        self.use_kernel = True  # False: the fused block's plain version on any device
        self._fold = None
        self.residual = stride == 1 and in_channels == out_channels
        if expand_ratio != 1:
            self.expand_conv = QConv(in_channels, mid, 1, bias=False)
            self.bn0 = BatchNorm2d(mid, _BN_EPS)
        else:
            self.expand_conv = None
        self.dw_conv = Conv2dSame(mid, mid, kernel, stride=stride, groups=mid, bias=False)
        self.bn1 = BatchNorm2d(mid, _BN_EPS)
        self.se = (SqueezeExcite(mid, max(1, int(in_channels * se_ratio)))
                   if se_ratio > 0 else None)
        self.project_conv = QConv(mid, out_channels, 1, bias=False)
        self.bn2 = BatchNorm2d(out_channels, _BN_EPS)

    def _folded(self, dt: torch.dtype):
        """``fused_mbconv``'s weight operands in ``dt``: the BNs folded as the
        JAX package's ``MBConv._fused`` folds them (efficientnet.py:260), made
        once and kept until a parameter or buffer changes (its storage, its
        version counter, as ``QConv.quantized_weight`` keeps its codes)."""
        tensors = list(self.parameters()) + list(self.buffers())
        keep = not any(t.is_inference() for t in tensors)
        key = (dt, tuple((t.device, t.data_ptr(), t._version) for t in tensors)) if keep else None
        if keep and self._fold is not None and self._fold[0] == key:
            return self._fold[1]

        def bn(m):
            return cuda_mbconv.fold_bn(m.weight, m.bias, m.running_mean, m.running_var, m.eps)

        def mat(conv):  # (Cout, Cin, 1, 1) -> (Cin, Cout)
            return conv.weight[:, :, 0, 0].t()

        with torch.inference_mode(False), torch.no_grad():
            if self.expand_conv is not None:
                g0, b0 = bn(self.bn0)
                we, be = (mat(self.expand_conv).float() * g0).to(dt).contiguous(), b0.to(dt)
            else:
                we = be = None
            g1, b1 = bn(self.bn1)
            wdw = (self.dw_conv.weight[:, 0].float() * g1[:, None, None]).permute(1, 2, 0)
            g2, b2 = bn(self.bn2)
            wp = (mat(self.project_conv).float() * g2).to(dt).contiguous()
            se = self.se
            ops = (we, be, wdw.to(dt).contiguous(), b1.to(dt),
                   mat(se.reduce).to(dt).contiguous(), se.reduce.bias.to(dt),
                   mat(se.expand).to(dt).contiguous(), se.expand.bias.to(dt), wp, b2.to(dt))
        if keep:
            self._fold = (key, ops, tensors)  # the tensors held, so no address is reused
        return ops

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        fn = cuda_mbconv.fused_mbconv if self.use_kernel else cuda_mbconv.fused_mbconv_plain
        return fn(x, *self._folded(x.dtype), kernel=self.kernel, stride=self.stride,
                  residual=self.residual)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and not self.training and self.se is not None:
            return self._fused(x)
        h = x
        if self.expand_conv is not None:
            h = F.silu(self.bn0(self.expand_conv(h)))
        h = F.silu(self.bn1(self.dw_conv(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn2(self.project_conv(h))
        return h + x if self.residual else h


class EfficientNetEncoder(nn.Module):
    """EfficientNet backbone returning five maps: stem@s2, stage1@s4,
    stage2@s8, stage4@s16, stage6@s32 (the smp encoder contract)."""

    _TAP_AFTER = (1, 2, 4, 6)

    def __init__(self, variant: str = "b0", in_channels: int = 3, fused_blocks: int = 0):
        """``fused_blocks``: serving only, the first N MBConv blocks (the
        high-resolution ones) run through the fused kernel in eval mode."""
        super().__init__()
        self.fused_blocks = fused_blocks
        width, depth, _ = VARIANTS[variant]
        stem_ch = round_channels(32, width)
        self.stem_conv = Conv2dSame(in_channels, stem_ch, 3, stride=2, bias=False)
        self.stem_bn = BatchNorm2d(stem_ch, _BN_EPS)
        self.stages: List[List[str]] = []
        ch = stem_ch
        block_idx = 0
        for stage_i, (e, k, s, c, r) in enumerate(_B0_STAGES):
            out_ch = round_channels(c, width)
            names = []
            for j in range(round_repeats(r, depth)):
                name = f"stage{stage_i}_block{j}"
                self.add_module(name, MBConv(ch, out_ch, e, k, s if j == 0 else 1,
                                             fused=block_idx < fused_blocks))
                names.append(name)
                ch = out_ch
                block_idx += 1
            self.stages.append(names)

    def set_fused_kernels(self, use_kernel: bool) -> None:
        """``False`` routes the fused blocks through their plain version on
        any device (the path a GPU run holds the kernel against)."""
        for m in self.modules():
            if isinstance(m, MBConv):
                m.use_kernel = use_kernel

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = F.silu(self.stem_bn(self.stem_conv(x)))
        features = [h]
        for stage_i, names in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            if stage_i in self._TAP_AFTER:
                features.append(h)
        return tuple(features)


def encoder_feature_channels(variant: str) -> Tuple[int, ...]:
    """Channel counts of the five taps (s2, s4, s8, s16, s32)."""
    width, _, _ = VARIANTS[variant]
    chans = [round_channels(c, width) for (_, _, _, c, _) in _B0_STAGES]
    return (round_channels(32, width), chans[1], chans[2], chans[4], chans[6])
