"""Hierarchical ROI segmentation heads, stage 2 (NCHW).

Counterpart of the JAX package's ``models/heads.py``: ``EnhancedUNet``,
``ShallowUNet``, ``HierarchicalHeadV2`` (with its optional attention
module: spatial attention after ``tnt_res0``, channel attention after the
``tnt`` upsample), the head variants ``HierarchicalHeadV1``, ``V3`` and
``V4`` (V4's cross-branch attention is :class:`SelfAttention`, flax's
arithmetic in plain tensor ops), the refinement modules (``BoundaryRefinement``,
``ProgressiveUpsamplingDecoder``, ``SubPixelDecoder``, ``ContourBranch``,
``DistanceTransformDecoder``), ``RefinedHierarchicalHead`` and
``PretrainedUNetGuidedHead``. Heads return ``(final_logits, aux)`` with
NCHW tensors; the assembly turns them into the JAX package's NHWC.
Every module takes the JAX heads' ``norm``, ``norm_groups``, ``activation``
and ``activation_beta``. ``HierarchicalHeadV2`` and the guided head drop
whole channels (:class:`.blocks.Dropout2d`) where the JAX heads do
(heads.py:198-252, :690-694); in eval mode these are the identity, and
they hold no parameters.

The 1x1/3x3 convs the JAX package builds as ``QConv`` are
:class:`..ops.quant.QConv` here too (its plain ``nn.Conv`` are
``nn.Conv2d``), and the producer-side int8 quantization points
(``prequantize_for``) sit where the JAX heads put them (heads.py:96, :107,
:117, :123, :230-233). Each bare norm -> activation runs through
:func:`..ops.cuda_norm.norm_act` (the LayerNorm2d kernel pair when serving
on CUDA).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops.activations import get_activation
from ..ops.attention import ChannelAttention, SpatialAttention
from ..ops.cuda_norm import norm_act
from ..ops.norms import get_normalization
from ..ops.quant import QConv
from ..ops.sampling import resize_bilinear
from .blocks import (ConvNormAct, ConvTranspose2x, Dropout2d, ResidualBlock, max_pool_2x,
                     pixel_shuffle, prequantize_for)

_NCHW = (2, 3)


def _resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if tuple(x.shape[2:]) == (h, w):
        return x
    return resize_bilinear(x, h, w, axes=_NCHW)


def _kw(norm: str, norm_groups: int, activation: str, activation_beta: float) -> dict:
    return dict(norm=norm, norm_groups=norm_groups, activation=activation,
                activation_beta=activation_beta)


class EnhancedUNet(nn.Module):
    """Depth-N UNet with two residual blocks per level and a sigmoid
    attention bottleneck; 2-class (bg/fg) logits."""

    def __init__(self, in_channels: int, base_channels: int = 96, depth: int = 3,
                 norm: str = "layernorm2d", activation: str = "relu", norm_groups: int = 8,
                 activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        chans = [base_channels * (2 ** i) for i in range(depth)]
        self.depth = depth
        for i in range(depth):
            if i == 0:
                self.enc0_in = ConvNormAct(in_channels, chans[0], **kw)
                self.enc0_res0 = ResidualBlock(chans[0], **kw)
                self.enc0_res1 = ResidualBlock(chans[0], **kw)
            else:
                self.add_module(f"enc{i}_res0", ResidualBlock(chans[i - 1], **kw))
                self.add_module(f"enc{i}_res1", ResidualBlock(chans[i - 1], **kw))
                self.add_module(f"enc{i}_out", ConvNormAct(chans[i - 1], chans[i], **kw))
        self.bott_res0 = ResidualBlock(chans[-1], **kw)
        self.bott_res1 = ResidualBlock(chans[-1], **kw)
        self.bott_cna = ConvNormAct(chans[-1], chans[-1], **kw)
        self.bott_att = QConv(chans[-1], chans[-1], 1)
        self.bott_conv = QConv(chans[-1], chans[-1], 3, padding=1)
        for d, i in enumerate(range(depth - 1, 0, -1)):
            self.add_module(f"up{d}", ConvTranspose2x(chans[i], chans[i - 1]))
            self.add_module(f"dec{d}_in", ConvNormAct(2 * chans[i - 1], chans[i - 1], **kw))
            self.add_module(f"dec{d}_res0", ResidualBlock(chans[i - 1], **kw))
            self.add_module(f"dec{d}_res1", ResidualBlock(chans[i - 1], **kw))
        self.final_cna = ConvNormAct(chans[0], chans[0] // 2, **kw)
        self.final_out = QConv(chans[0] // 2, 2, 1)

    def _run(self, x: torch.Tensor, *names: str) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.depth):
            if i == 0:
                x = self._run(x, "enc0_in", "enc0_res0", "enc0_res1")
            else:
                x = self._run(x, f"enc{i}_res0", f"enc{i}_res1")
                cna = getattr(self, f"enc{i}_out")
                x = cna(prequantize_for(cna.conv, x))
            skips.append(x)
            if i < self.depth - 1:
                x = max_pool_2x(x)
        a = self._run(x, "bott_res0", "bott_res1", "bott_cna")
        a = torch.sigmoid(self.bott_att(prequantize_for(self.bott_att, a, k=1)))
        x = self.bott_conv(x) * a
        for d, i in enumerate(range(self.depth - 1, 0, -1)):
            skip = skips[i - 1]
            x = getattr(self, f"up{d}")(x)
            if x.shape[2:] != skip.shape[2:]:  # an odd size pooled down (15 -> 7 -> 14)
                tracing.count("unet_skip_resizes")
            x = _resize_to(x, skip.shape[2], skip.shape[3])
            x = torch.cat([x, skip], dim=1)
            cna = getattr(self, f"dec{d}_in")
            x = self._run(cna(prequantize_for(cna.conv, x)), f"dec{d}_res0", f"dec{d}_res1")
        x = self.final_cna(x)
        return self.final_out(prequantize_for(self.final_out, x, k=1))


class ShallowUNet(nn.Module):
    """Depth-2 UNet with two conv-norm-act units per level; 2-class logits."""

    def __init__(self, in_channels: int, base_channels: int = 64, norm: str = "layernorm2d",
                 activation: str = "relu", norm_groups: int = 8, activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        bc = base_channels
        self.enc1a = ConvNormAct(in_channels, bc, **kw)
        self.enc1b = ConvNormAct(bc, bc, **kw)
        self.enc2a = ConvNormAct(bc, bc * 2, **kw)
        self.enc2b = ConvNormAct(bc * 2, bc * 2, **kw)
        self.bota = ConvNormAct(bc * 2, bc * 4, **kw)
        self.botb = ConvNormAct(bc * 4, bc * 4, **kw)
        self.up2 = ConvTranspose2x(bc * 4, bc * 2)
        self.dec2a = ConvNormAct(bc * 4, bc * 2, **kw)
        self.dec2b = ConvNormAct(bc * 2, bc * 2, **kw)
        self.up1 = ConvTranspose2x(bc * 2, bc)
        self.dec1a = ConvNormAct(bc * 2, bc, **kw)
        self.dec1b = ConvNormAct(bc, bc, **kw)
        self.final = QConv(bc, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.enc1b(self.enc1a(x))
        e2 = self.enc2b(self.enc2a(max_pool_2x(e1)))
        h = self.botb(self.bota(max_pool_2x(e2)))
        h = _resize_to(self.up2(h), e2.shape[2], e2.shape[3])
        h = self.dec2b(self.dec2a(torch.cat([h, e2], dim=1)))
        h = _resize_to(self.up1(h), e1.shape[2], e1.shape[3])
        h = self.dec1b(self.dec1a(torch.cat([h, e1], dim=1)))
        return self.final(h)


def _combine(bg_fg_logits: torch.Tensor, tnt_logits: torch.Tensor,
             target_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hierarchical combine: [bgfg0, bgfg1 + tnt0 * P(fg) (* the target
    gate), bgfg1 + tnt1 * P(fg)]."""
    fg_p = torch.softmax(bg_fg_logits, dim=1)[:, 1:2]
    t0 = tnt_logits[:, 0:1] * fg_p
    if target_gate is not None:
        t0 = t0 * target_gate
    fg = bg_fg_logits[:, 1:2]
    return torch.cat([bg_fg_logits[:, 0:1], fg + t0, fg + tnt_logits[:, 1:2] * fg_p], dim=1)


class HierarchicalHeadV2(nn.Module):
    """Shared trunk -> (a) EnhancedUNet bg/fg logits, 2x deconv to the mask
    size; (b) an fg gate from the low-res bg/fg logits on the shared
    features for the target/non-target branch. Combine:
        final[0] = bgfg[0]
        final[1] = bgfg[1] + tnt[0] * P(fg)
        final[2] = bgfg[1] + tnt[1] * P(fg)
    ``use_attention_module`` adds ``tnt_satt`` (spatial attention, k 7)
    after ``tnt_res0`` and ``tnt_catt`` (channel attention, reduction 8)
    after the tnt upsample. ``expose_shared`` adds the trunk's output to
    aux as ``shared_features``.
    """

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), norm: str = "layernorm2d",
                 activation: str = "relu", base_channels: int = 96, depth: int = 3,
                 dropout_rate: float = 0.1, use_attention_module: bool = False,
                 norm_groups: int = 8, activation_beta: float = 1.0,
                 expose_shared: bool = False):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        mc = mid_channels
        self.mask_size = tuple(mask_size)
        self.expose_shared = expose_shared
        self.act = get_activation(activation, activation_beta)
        self.shared_in = ConvNormAct(in_channels, mc, **kw)
        self.shared_drop0 = Dropout2d(dropout_rate)
        self.shared_res0 = ResidualBlock(mc, **kw)
        self.shared_drop1 = Dropout2d(dropout_rate)
        self.shared_res1 = ResidualBlock(mc, **kw)
        self.bg_vs_fg_unet = EnhancedUNet(mc, base_channels, depth, **kw)
        self.upsample_deconv = ConvTranspose2x(2, 32)
        self.upsample_norm = get_normalization(norm, 32, min(norm_groups, 32))
        self.upsample_out = QConv(32, 2, 1)
        self.gate0 = QConv(2, mc // 4, 1)
        self.gate_drop = Dropout2d(dropout_rate * 0.5)
        self.gate1 = QConv(mc // 4, mc // 2, 1)
        self.gate2 = QConv(mc // 2, mc, 1)
        self.tnt_res0 = ResidualBlock(mc, **kw)
        self.tnt_satt = SpatialAttention(7) if use_attention_module else None
        self.tnt_drop0 = Dropout2d(dropout_rate)
        self.tnt_deconv = ConvTranspose2x(mc, mc // 2)
        self.tnt_norm = get_normalization(norm, mc // 2, min(norm_groups, mc // 2))
        self.tnt_catt = (ChannelAttention(mc // 2, 8, activation=activation,
                                          activation_beta=activation_beta)
                         if use_attention_module else None)
        self.tnt_drop1 = Dropout2d(dropout_rate)
        self.tnt_res1 = ResidualBlock(mc // 2, **dict(kw, norm_groups=min(norm_groups, mc // 2)))
        self.tnt_out = QConv(mc // 2, 2, 1)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        act = self.act
        mh, mw = self.mask_size
        shared = self.shared_drop0(self.shared_in(features))
        shared = self.shared_res1(self.shared_drop1(self.shared_res0(shared)))

        with tracing.span("model.head.bgfg_unet"):
            bg_fg_low = self.bg_vs_fg_unet(shared)
        up = norm_act(self.upsample_deconv(bg_fg_low), self.upsample_norm, act)
        bg_fg_logits = _resize_to(self.upsample_out(up), mh, mw)

        g = self.gate_drop(act(self.gate0(bg_fg_low)))
        g = act(self.gate1(prequantize_for(self.gate1, g, k=1)))
        fg_attention = torch.sigmoid(self.gate2(prequantize_for(self.gate2, g, k=1)))

        t = self.tnt_res0(shared * fg_attention)
        if self.tnt_satt is not None:
            t = self.tnt_satt(t)
        t = norm_act(self.tnt_deconv(self.tnt_drop0(t)), self.tnt_norm, act)
        if self.tnt_catt is not None:
            t = self.tnt_catt(t)
        t = self.tnt_res1(self.tnt_drop1(t))
        tnt_logits = _resize_to(self.tnt_out(t), mh, mw)

        final = _combine(bg_fg_logits, tnt_logits)
        aux = {
            "bg_fg_logits": bg_fg_logits,
            "bg_fg_logits_low": bg_fg_low,
            "target_nontarget_logits": tnt_logits,
            "fg_attention": fg_attention,
        }
        if self.expose_shared:
            aux["shared_features"] = shared
        return final, aux


class HierarchicalHeadV1(nn.Module):
    """V1: a ``ShallowUNet(128)`` bg/fg branch, the V2 gate and combine, no
    dropout."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), norm: str = "layernorm2d",
                 activation: str = "relu", norm_groups: int = 8, activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        mc = mid_channels
        self.mask_size = tuple(mask_size)
        self.act = get_activation(activation, activation_beta)
        self.shared_in = ConvNormAct(in_channels, mc, **kw)
        self.shared_res0 = ResidualBlock(mc, **kw)
        self.shared_res1 = ResidualBlock(mc, **kw)
        self.bg_vs_fg_unet = ShallowUNet(mc, 128, **kw)
        self.upsample_deconv = ConvTranspose2x(2, 32)
        self.upsample_norm = get_normalization(norm, 32, min(norm_groups, 32))
        self.upsample_out = QConv(32, 2, 1)
        self.gate0 = QConv(2, mc // 4, 1)
        self.gate1 = QConv(mc // 4, mc // 2, 1)
        self.gate2 = QConv(mc // 2, mc, 1)
        self.tnt_res0 = ResidualBlock(mc, **kw)
        self.tnt_deconv = ConvTranspose2x(mc, mc // 2)
        self.tnt_norm = get_normalization(norm, mc // 2, min(norm_groups, mc // 2))
        self.tnt_res1 = ResidualBlock(mc // 2, **dict(kw, norm_groups=min(norm_groups, mc // 2)))
        self.tnt_out = QConv(mc // 2, 2, 1)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        act = self.act
        mh, mw = self.mask_size
        shared = self.shared_res1(self.shared_res0(self.shared_in(features)))
        bg_fg_low = self.bg_vs_fg_unet(shared)
        up = norm_act(self.upsample_deconv(bg_fg_low), self.upsample_norm, act)
        bg_fg_logits = _resize_to(self.upsample_out(up), mh, mw)
        g = act(self.gate1(act(self.gate0(bg_fg_low))))
        fg_attention = torch.sigmoid(self.gate2(g))
        t = self.tnt_res0(shared * fg_attention)
        t = norm_act(self.tnt_deconv(t), self.tnt_norm, act)
        tnt_logits = _resize_to(self.tnt_out(self.tnt_res1(t)), mh, mw)
        aux = {"bg_fg_logits": bg_fg_logits, "bg_fg_logits_low": bg_fg_low,
               "target_nontarget_logits": tnt_logits, "fg_attention": fg_attention}
        return _combine(bg_fg_logits, tnt_logits), aux


class HierarchicalHeadV3(nn.Module):
    """V3: an EnhancedUNet bg/fg branch and a ``ShallowUNet(64)``
    target/non-target branch on the fg-gated features, with a second
    (target) gate on the target channel."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), base_channels: int = 96, depth: int = 3,
                 norm: str = "layernorm2d", activation: str = "relu", norm_groups: int = 8,
                 activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        mc = mid_channels
        self.mask_size = tuple(mask_size)
        self.act = get_activation(activation, activation_beta)
        self.shared_in = ConvNormAct(in_channels, mc, **kw)
        self.shared_res0 = ResidualBlock(mc, **kw)
        self.shared_res1 = ResidualBlock(mc, **kw)
        self.bg_vs_fg_unet = EnhancedUNet(mc, base_channels, depth, **kw)
        self.up_bgfg_deconv = ConvTranspose2x(2, 32)
        self.up_bgfg_norm = get_normalization(norm, 32, min(norm_groups, 32))
        self.up_bgfg_out = QConv(32, 2, 1)
        self.fg_gate0 = QConv(2, mc // 4, 1)
        self.fg_gate1 = QConv(mc // 4, mc, 1)
        self.target_nontarget_unet = ShallowUNet(mc, 64, **kw)
        self.up_tnt_deconv = ConvTranspose2x(2, 32)
        self.up_tnt_norm = get_normalization(norm, 32, min(norm_groups, 32))
        self.up_tnt_out = QConv(32, 2, 1)
        self.target_gate0 = QConv(2, 32, 1)
        self.target_gate1 = QConv(32, 1, 1)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        act = self.act
        mh, mw = self.mask_size
        shared = self.shared_res1(self.shared_res0(self.shared_in(features)))
        bg_fg_low = self.bg_vs_fg_unet(shared)
        up = norm_act(self.up_bgfg_deconv(bg_fg_low), self.up_bgfg_norm, act)
        bg_fg_logits = _resize_to(self.up_bgfg_out(up), mh, mw)
        fg_attention = torch.sigmoid(self.fg_gate1(act(self.fg_gate0(bg_fg_low))))
        tnt_low = self.target_nontarget_unet(shared * fg_attention)
        upt = norm_act(self.up_tnt_deconv(tnt_low), self.up_tnt_norm, act)
        tnt_logits = _resize_to(self.up_tnt_out(upt), mh, mw)
        target_attention = torch.sigmoid(self.target_gate1(act(self.target_gate0(tnt_low))))
        final = _combine(bg_fg_logits, tnt_logits, _resize_to(target_attention, mh, mw))
        aux = {"bg_fg_logits": bg_fg_logits, "bg_fg_logits_low": bg_fg_low,
               "target_nontarget_logits": tnt_logits, "target_logits_low": tnt_low,
               "fg_attention": fg_attention, "target_attention": target_attention}
        return final, aux


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention(num_heads, qkv_features)`` over tokens
    (N, L, C), in plain tensor ops: ``query``/``key``/``value`` projections
    to ``num_heads`` heads, the query scaled by 1/sqrt(head_dim), q.k^T
    softmaxed over the keys in float32, no dropout, the heads merged by
    ``out`` back to C features. The four ``nn.Linear`` hold flax's
    ``DenseGeneral`` kernels flattened (``weights.from_jax_params``)."""

    def __init__(self, features: int, num_heads: int = 1, qkv_features: Optional[int] = None):
        super().__init__()
        qkv = qkv_features or features
        if qkv % num_heads:
            raise ValueError(f"qkv_features {qkv} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.head_dim = num_heads, qkv // num_heads
        self.query = nn.Linear(features, qkv)
        self.key = nn.Linear(features, qkv)
        self.value = nn.Linear(features, qkv)
        self.out = nn.Linear(qkv, features)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        n, length, _ = tokens.shape

        def heads(t: torch.Tensor) -> torch.Tensor:  # (N, L, H*D) -> (N, H, L, D)
            return t.reshape(n, length, self.num_heads, self.head_dim).transpose(1, 2)

        q = heads(self.query(tokens)) / math.sqrt(self.head_dim)
        k, v = heads(self.key(tokens)), heads(self.value(tokens))
        weights = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        merged = (weights @ v).transpose(1, 2).reshape(n, length, -1)
        return self.out(merged)


class HierarchicalHeadV4(nn.Module):
    """V4: two EnhancedUNet branches (bg/fg at base 128, depth 4;
    target/non-target at base 96, depth 3), each upsampled to 64 channels
    with a residual block, cross-branch self-attention over the four logit
    channels of every mask pixel, and a fusion conv stack to 3 classes."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), norm: str = "layernorm2d",
                 activation: str = "relu", norm_groups: int = 8, activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        mc = mid_channels
        self.mask_size = tuple(mask_size)
        self.act = get_activation(activation, activation_beta)
        self.shared_in = ConvNormAct(in_channels, mc, **kw)
        for i in range(3):
            self.add_module(f"shared_res{i}", ResidualBlock(mc, **kw))
        for name, base, depth in (("bgfg", 128, 4), ("tnt", 96, 3)):
            self.add_module(f"{name}_unet", EnhancedUNet(mc, base, depth, **kw))
            self.add_module(f"{name}_deconv", ConvTranspose2x(2, 64))
            self.add_module(f"{name}_norm", get_normalization(norm, 64, min(norm_groups, 64)))
            self.add_module(f"{name}_res", ResidualBlock(64, **kw))
            self.add_module(f"{name}_out", QConv(64, 2, 1))
        self.cross_attention = SelfAttention(4, num_heads=1, qkv_features=4)
        self.fusion_in = ConvNormAct(4, 64, **kw)
        self.fusion_res = ResidualBlock(64, **kw)
        self.fusion_out = QConv(64, 3, 1)

    def _branch(self, name: str, shared: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mh, mw = self.mask_size
        low = getattr(self, f"{name}_unet")(shared)
        u = norm_act(getattr(self, f"{name}_deconv")(low), getattr(self, f"{name}_norm"), self.act)
        out = getattr(self, f"{name}_out")(getattr(self, f"{name}_res")(u))
        return low, _resize_to(out, mh, mw)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mh, mw = self.mask_size
        shared = self.shared_in(features)
        for i in range(3):
            shared = getattr(self, f"shared_res{i}")(shared)
        bg_fg_low, bg_fg_logits = self._branch("bgfg", shared)
        tnt_low, tnt_logits = self._branch("tnt", shared)
        n = features.shape[0]
        combined = torch.cat([bg_fg_logits, tnt_logits], dim=1)  # (N, 4, mh, mw)
        tokens = combined.permute(0, 2, 3, 1).reshape(n, mh * mw, 4)
        attended = self.cross_attention(tokens).reshape(n, mh, mw, 4).permute(0, 3, 1, 2)
        final = self.fusion_out(self.fusion_res(self.fusion_in(attended)))
        aux = {"bg_fg_logits": bg_fg_logits, "bg_fg_logits_low": bg_fg_low,
               "target_nontarget_logits": tnt_logits, "target_logits_low": tnt_low,
               "attended_features": attended}
        return final, aux


def _small_init(conv: nn.Conv2d) -> nn.Conv2d:
    """Mark ``conv`` for the JAX modules' ``variance_scaling(0.01, "fan_avg",
    "uniform")`` kernel init (``inference.init_weights`` reads the mark)."""
    conv.init_scale = 0.01
    return conv


def _sqrt_zero_grad(s: torch.Tensor) -> torch.Tensor:
    """``sqrt(s)`` for ``s >= 0`` whose gradient at ``s == 0`` is 0, not
    ``inf * 0 = NaN``: the value is sqrt's bit for bit."""
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))


class BoundaryRefinement(nn.Module):
    """Edge-gated residual refinement of the class logits: an edge map
    (the channel mean of the probabilities' forward-difference magnitude,
    min-max normalised over the whole batch) gates ``blend_weight *
    edge_out(...)`` added to the logits.

    One stated deviation (ROADMAP C9): where two neighbouring probabilities
    are equal in both directions, the magnitude ``sqrt(dy^2 + dx^2)`` is
    differentiated as 0 here; the JAX module's gradient there is NaN, and
    in bf16, where such ties are common, it makes every train step
    non-finite (the JAX step skips them all). The forward is the same.
    """

    def __init__(self, num_classes: int = 3, edge_channels: int = 32,
                 norm: str = "layernorm2d", norm_groups: int = 8, activation: str = "relu",
                 activation_beta: float = 1.0):
        super().__init__()
        g = min(norm_groups, edge_channels)
        self.act = get_activation(activation, activation_beta)
        self.edge0 = _small_init(nn.Conv2d(num_classes, edge_channels, 3, padding=1))
        self.edge_norm0 = get_normalization(norm, edge_channels, g)
        self.edge1 = _small_init(nn.Conv2d(edge_channels, edge_channels, 3, padding=1))
        self.edge_norm1 = get_normalization(norm, edge_channels, g)
        self.edge_out = _small_init(nn.Conv2d(edge_channels, num_classes, 1))
        self.blend_weight = nn.Parameter(torch.tensor(0.01))

    def forward(self, mask_logits: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(mask_logits, dim=1)
        dy = (probs[:, :, 1:] - probs[:, :, :-1]).abs()
        dx = (probs[:, :, :, 1:] - probs[:, :, :, :-1]).abs()
        dy = torch.cat([dy, dy[:, :, -1:]], dim=2)  # edge padding at the bottom
        dx = torch.cat([dx, dx[:, :, :, -1:]], dim=3)  # and at the right
        edges = _sqrt_zero_grad(dy ** 2 + dx ** 2).mean(dim=1, keepdim=True)
        emin, emax = edges.amin(), edges.amax()
        edges = torch.where(emax - emin < 1e-6, torch.zeros_like(edges),
                            (edges - emin) / (emax - emin + 1e-6))
        h = norm_act(self.edge0(mask_logits), self.edge_norm0, self.act)
        h = norm_act(self.edge1(h), self.edge_norm1, self.act)
        return mask_logits + self.blend_weight * self.edge_out(h) * edges


class ProgressiveUpsamplingDecoder(nn.Module):
    """Two 2x stages (transposed conv k 4, stride 2, flax's SAME padding ->
    norm -> act -> residual block, halving the channels each time), a 1x1
    projection to the classes, resized to the target size."""

    def __init__(self, in_channels: int, num_classes: int = 3, norm: str = "layernorm2d",
                 norm_groups: int = 8, activation: str = "relu",
                 activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.act = get_activation(activation, activation_beta)
        ch_in = in_channels
        for i, ch in enumerate((in_channels // 2, in_channels // 4)):
            # lax.conv_transpose with SAME padding at k 4, s 2 pads the
            # zero-stuffed input by 2 on each side: torch's padding 1
            self.add_module(f"stage{i}_deconv", nn.ConvTranspose2d(ch_in, ch, 4, stride=2,
                                                                   padding=1))
            self.add_module(f"stage{i}_norm", get_normalization(norm, ch, min(norm_groups, ch)))
            self.add_module(f"stage{i}_res", ResidualBlock(ch, **kw))
            ch_in = ch
        self.proj = QConv(ch_in, num_classes, 1)

    def forward(self, features: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
        x = features
        for i in range(2):
            x = getattr(self, f"stage{i}_deconv")(x)
            x = norm_act(x, getattr(self, f"stage{i}_norm"), self.act)
            x = getattr(self, f"stage{i}_res")(x)
        return _resize_to(self.proj(x), target_hw[0], target_hw[1])


class SubPixelDecoder(nn.Module):
    """3x3 conv to ``num_classes * r^2`` channels, then pixel shuffle by r."""

    def __init__(self, in_channels: int, num_classes: int = 3, upscale_factor: int = 2):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.conv = QConv(in_channels, num_classes * upscale_factor ** 2, 3, padding=1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.conv(features), self.upscale_factor)


class ContourBranch(nn.Module):
    """Single-channel sigmoid contour map."""

    def __init__(self, in_channels: int, contour_channels: int = 64,
                 norm: str = "layernorm2d", activation: str = "relu", norm_groups: int = 8,
                 activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.c0 = ConvNormAct(in_channels, contour_channels, **kw)
        self.c1 = ConvNormAct(contour_channels, contour_channels, **kw)
        self.out = QConv(contour_channels, 1, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.out(self.c1(self.c0(features))))


class DistanceTransformDecoder(nn.Module):
    """Distance-map regression with a learned sharp-sigmoid threshold."""

    def __init__(self, in_channels: int, distance_channels: int = 128,
                 norm: str = "layernorm2d", activation: str = "relu", norm_groups: int = 8,
                 activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.d0 = ConvNormAct(in_channels, distance_channels, **kw)
        self.d_res = ResidualBlock(distance_channels, **kw)
        self.out = QConv(distance_channels, 1, 1)
        self.threshold = nn.Parameter(torch.tensor(0.3))

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        distance_map = self.out(self.d_res(self.d0(features)))
        mask = torch.sigmoid((distance_map - self.threshold) * 10.0)
        return mask, distance_map


class RefinedHierarchicalHead(nn.Module):
    """HierarchicalHeadV2 plus the optional refinement modules, applied in
    the JAX head's order: the progressive or (else) the sub-pixel decoder
    replaces the logits, the boundary refinement refines them, and the
    contour and distance branches read the shared features into aux."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), use_contour_detection: bool = False,
                 use_distance_transform: bool = False, norm: str = "layernorm2d",
                 activation: str = "relu", base_channels: int = 96, depth: int = 3,
                 use_attention_module: bool = False, use_boundary_refinement: bool = False,
                 use_progressive_upsampling: bool = False, use_subpixel_conv: bool = False,
                 norm_groups: int = 8, activation_beta: float = 1.0,
                 dropout_rate: float = 0.1):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.mask_size = tuple(mask_size)
        self.base_head = HierarchicalHeadV2(
            in_channels, mid_channels, mask_size, base_channels=base_channels, depth=depth,
            dropout_rate=dropout_rate, use_attention_module=use_attention_module,
            expose_shared=True, **kw)
        self.progressive = (ProgressiveUpsamplingDecoder(mid_channels, 3, **kw)
                            if use_progressive_upsampling else None)
        self.subpixel = (SubPixelDecoder(mid_channels, 3)
                         if use_subpixel_conv and not use_progressive_upsampling else None)
        self.boundary = BoundaryRefinement(3, **kw) if use_boundary_refinement else None
        self.contour = ContourBranch(mid_channels, **kw) if use_contour_detection else None
        self.distance = (DistanceTransformDecoder(mid_channels, **kw)
                         if use_distance_transform else None)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mh, mw = self.mask_size
        logits, aux = self.base_head(features)
        shared = aux["shared_features"]
        if self.progressive is not None:
            logits = self.progressive(shared, (mh, mw))
        elif self.subpixel is not None:
            logits = _resize_to(self.subpixel(shared), mh, mw)
        if self.boundary is not None:
            logits = self.boundary(logits)
        # branches that feed only training losses: no deployed output reads them
        with tracing.span("model.head.unread"):
            if self.contour is not None:
                aux["contours"] = _resize_to(self.contour(shared), mh, mw)
            if self.distance is not None:
                dmask, dmap = self.distance(shared)
                aux["distance_mask"] = _resize_to(dmask, mh, mw)
                aux["distance_map"] = _resize_to(dmap, mh, mw)
        return logits, aux


class PretrainedUNetGuidedHead(nn.Module):
    """Direct 3-class head guided by the stage-1 foreground probability
    (the JAX model takes it when no refinement flag is set). ``forward(
    features (N, C, h, w), bg_fg_mask (N, 2 or 1, h, w))``: channel 1 of a
    two-channel mask is read as the foreground logit (the reference's
    quirk, kept for checkpoint parity); aux ``bg_fg_logits`` are the log
    probabilities of that mask, so the hierarchical loss still applies."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 mask_size: Tuple[int, int] = (56, 56), dropout_rate: float = 0.1,
                 use_attention_module: bool = False, norm: str = "layernorm2d",
                 norm_groups: int = 8, activation: str = "relu",
                 activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        mc = mid_channels
        self.mask_size = tuple(mask_size)
        self.act = get_activation(activation, activation_beta)
        self.input_adjust = QConv(in_channels + 1, in_channels, 1)
        self.fp_in = ConvNormAct(in_channels, mc, **kw)
        self.fp_drop0 = Dropout2d(dropout_rate)
        self.fp_res0 = ResidualBlock(mc, **kw)
        self.fp_drop1 = Dropout2d(dropout_rate)
        self.fp_res1 = ResidualBlock(mc, **kw)
        if use_attention_module:
            self.att0 = QConv(mc, mc // 4, 1)
            self.att1 = QConv(mc // 4, 1, 1)
        else:
            self.att0 = self.att1 = None
        self.cls0 = ConvNormAct(mc, mc // 2, **kw)
        self.cls_out = nn.Conv2d(mc // 2, 3, 1)
        self.cls_out.init_bias = (0.0, 0.0, -0.5)  # non-target rarer (JAX bias_init)

    def forward(self, features: torch.Tensor,
                bg_fg_mask: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mh, mw = self.mask_size
        fg_logit = bg_fg_mask[:, 1:2] if bg_fg_mask.shape[1] == 2 else bg_fg_mask
        fg_prob = torch.sigmoid(fg_logit)
        fg_prob_ds = _resize_to(fg_prob, features.shape[2], features.shape[3])

        x = self.input_adjust(torch.cat([features, fg_prob_ds], dim=1))
        x = self.fp_drop0(self.fp_in(x))
        x = self.fp_res1(self.fp_drop1(self.fp_res0(x)))
        if self.att0 is not None:
            a = torch.sigmoid(self.att1(self.act(self.att0(x))))
            x = x * (a * (0.5 + 0.5 * fg_prob_ds))
        final = _resize_to(self.cls_out(self.cls0(x)), mh, mw)

        # the sigmoid of the resized logit, not a resized probability
        if tuple(fg_logit.shape[2:]) != (mh, mw):
            fg_prob_full = torch.sigmoid(_resize_to(fg_logit, mh, mw))
        else:
            fg_prob_full = fg_prob
        bg_fg_logits = torch.cat([torch.log(1.0 - fg_prob_full + 1e-7),
                                  torch.log(fg_prob_full + 1e-7)], dim=1)
        aux = {
            "bg_fg_logits": bg_fg_logits,
            "target_nontarget_logits": final[:, 1:3],
            "fg_prob": fg_prob_full,
        }
        return final, aux
