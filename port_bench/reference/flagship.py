"""The flagship's served outputs in plain float32 PyTorch: the yardstick.

A two-stage person instance segmenter as it is deployed
(``create_flagship``'s model: an EfficientNet-UNet over the whole image, RoI
crops of the image and of the stage-1 logit map, an RGB feature stack and the
hierarchical head), written from the architecture with plain ``torch``
operations and nothing else: no kernels, no quantization, no caches. Module
and parameter names follow the checkpoint layout, so one state dict loads
into the served model and into this one.

The outputs are the deployed contract:

* ``binary``: P(person) per pixel, ``softmax(wrapper(unet(image)))[0]``;
* ``instance``: per RoI, 1.0 where ``argmax`` of the 3-class logits is the
  target class, after the +2 dilation boost of the target logit.

Only what these outputs need is computed: the served model's contour and
distance branches feed nothing that is deployed, so they are left out here
and their parameters go unread.

Departures that leave the function unchanged: RoIAlign is ``F.grid_sample``
(bilinear, zero padding, ``align_corners=True``, the grid at the box corners
in pixel space), resizes are ``F.interpolate``, and the stage-1 logit map is
cropped at one channel before the 1 -> 2 channel wrapper (a 1x1 map, so the
two commute up to the wrapper's bias on out-of-image samples).

Two switches serve the benchmark's checks and are off for the reference:
:func:`record_ranges` records each conv's input abs-max (the control's
calibration), and :func:`quantize_convs` makes chosen convs compute on
symmetric ``bits``-bit fake-quantized inputs and weights (the control).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# EfficientNet-B0 stages: (expand ratio, kernel, stride, out channels, repeats)
B0_STAGES = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2), (6, 3, 2, 80, 3),
             (6, 5, 1, 112, 3), (6, 5, 2, 192, 4), (6, 3, 1, 320, 1))
# variant -> (width multiplier, depth multiplier)
VARIANTS = {"tiny": (0.25, 0.25), "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
            "b3": (1.2, 1.4), "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6),
            "b7": (2.0, 3.1)}
ENCODER_TAPS = (1, 2, 4, 6)  # the stages after which the encoder hands a skip on
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def round_channels(c: float, width: float, divisor: int = 8) -> int:
    c *= width
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return new_c + divisor if new_c < 0.9 * c else new_c


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def fake_quant(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric round-to-nearest onto ``bits``-bit codes and back."""
    top = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x / scale), -top, top) * scale


class Conv(nn.Module):
    """A dense or depthwise conv: symmetric zero padding ``k // 2``, or TF
    'SAME' padding (``same``, possibly asymmetric at stride 2)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True,
                 groups: int = 1, same: bool = False):
        super().__init__()
        self.stride, self.groups, self.same = stride, groups, same
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.ranges: Optional[List[torch.Tensor]] = None  # input abs-max, while recording
        self.quant: Optional[Tuple[torch.Tensor, int]] = None  # (input scale, bits)

    @property
    def contraction(self) -> int:
        return self.weight[0].numel()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.ranges is not None:
            self.ranges.append(x.abs().amax())
        if self.quant is not None:
            xscale, bits = self.quant
            wscale = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12)
            x = fake_quant(x, xscale, bits)
            w = fake_quant(w, wscale / (2 ** (bits - 1) - 1), bits)
        k = w.shape[-1]
        if self.same:
            top, bottom = _same_pads(x.shape[-2], k, self.stride)
            left, right = _same_pads(x.shape[-1], k, self.stride)
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        else:
            pad = k // 2
        return F.conv2d(x, w, self.bias, self.stride, pad, 1, self.groups)


class Deconv(nn.Module):
    """2x upsampling transposed conv (kernel 2, stride 2), held as ``deconv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


class BatchNorm(nn.Module):
    """Eval-mode batch norm with running statistics."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]


class LayerNorm2d(nn.Module):
    """Normalise over (C, H, W) of each sample (biased variance, eps 1e-5),
    then a per-channel affine."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


# ---- stage 1: EfficientNet encoder and UNet decoder ------------------------


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, squeeze: int):
        super().__init__()
        self.reduce = Conv(c, squeeze, 1)
        self.expand = Conv(squeeze, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.expand(F.silu(self.reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Inverted bottleneck: 1x1 expand, k x k depthwise, squeeze-excite on a
    quarter of the block's input width, 1x1 project; BN eps 1e-3, SiLU."""

    def __init__(self, cin: int, cout: int, expand: int, k: int, stride: int):
        super().__init__()
        mid = cin * expand
        if expand != 1:
            self.expand_conv = Conv(cin, mid, 1, bias=False)
            self.bn0 = BatchNorm(mid, 1e-3)
        else:
            self.expand_conv = None
        self.dw_conv = Conv(mid, mid, k, stride, bias=False, groups=mid, same=True)
        self.bn1 = BatchNorm(mid, 1e-3)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25)))
        self.project_conv = Conv(mid, cout, 1, bias=False)
        self.bn2 = BatchNorm(cout, 1e-3)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = F.silu(self.bn0(self.expand_conv(h)))
        h = self.se(F.silu(self.bn1(self.dw_conv(h))))
        h = self.bn2(self.project_conv(h))
        return h + x if self.residual else h


class Encoder(nn.Module):
    """Stem (3x3 stride 2) and the seven MBConv stages; returns the stem's map
    and the maps after stages 1, 2, 4 and 6."""

    def __init__(self, variant: str):
        super().__init__()
        width, depth = VARIANTS[variant]
        ch = round_channels(32, width)
        self.stem_conv = Conv(3, ch, 3, 2, bias=False, same=True)
        self.stem_bn = BatchNorm(ch, 1e-3)
        self.stages: List[List[str]] = []
        for i, (e, k, s, c, r) in enumerate(B0_STAGES):
            out, names = round_channels(c, width), []
            for j in range(int(math.ceil(depth * r))):
                self.add_module(f"stage{i}_block{j}", MBConv(ch, out, e, k, s if j == 0 else 1))
                names.append(f"stage{i}_block{j}")
                ch = out
            self.stages.append(names)

    @staticmethod
    def tap_channels(variant: str) -> Tuple[int, ...]:
        width, _ = VARIANTS[variant]
        chans = [round_channels(c, width) for (_, _, _, c, _) in B0_STAGES]
        return (round_channels(32, width), chans[1], chans[2], chans[4], chans[6])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.silu(self.stem_bn(self.stem_conv(x)))
        taps = [h]
        for i, names in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            if i in ENCODER_TAPS:
                taps.append(h)
        return taps


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if tuple(x.shape[2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class DecoderBlock(nn.Module):
    """2x bilinear upsample, concat the skip, (3x3 conv, BN eps 1e-5, ReLU) x 2."""

    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.conv0 = Conv(cin + skip, cout, 3, bias=False)
        self.bn0 = BatchNorm(cout, 1e-5)
        self.conv1 = Conv(cout, cout, 3, bias=False)
        self.bn1 = BatchNorm(cout, 1e-5)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
        x = _resize(x, 2 * x.shape[2], 2 * x.shape[3])
        if skip is not None:
            x = torch.cat([_resize(x, skip.shape[2], skip.shape[3]), skip], dim=1)
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


class UNet(nn.Module):
    """Images in [0, 1] (B, 3, H, W) -> one-channel person logits (B, 1, H, W)."""

    def __init__(self, variant: str, decoder: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = Encoder(variant)
        taps = Encoder.tap_channels(variant)
        skips, ch = list(taps[:-1])[::-1], taps[-1]
        self.n_decoders = len(decoder)
        for i, out in enumerate(decoder):
            self.add_module(f"decoder{i}",
                            DecoderBlock(ch, skips[i] if i < len(skips) else 0, out))
            ch = out
        self.seg_head = Conv(ch, 1, 3)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=images.device)[:, None, None]
        taps = self.encoder((images - mean) / std)
        skips, h = taps[:-1][::-1], taps[-1]
        for i in range(self.n_decoders):
            h = getattr(self, f"decoder{i}")(h, skips[i] if i < len(skips) else None)
        return self.seg_head(h)


class Wrapper(nn.Module):
    """The 1 -> 2 channel 1x1 map after the UNet; channel 0 is the person."""

    def __init__(self):
        super().__init__()
        self.output_conv = Conv(1, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_conv(x)


# ---- stage 2: RGB features and the hierarchical head ------------------------


class ConvNormAct(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv = Conv(cin, cout, k)
        self.norm = LayerNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x)))


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.norm1 = Conv(c, c, 3), LayerNorm2d(c)
        self.conv2, self.norm2 = Conv(c, c, 3), LayerNorm2d(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(h)) + x)


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = Deconv(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(x)


class RGBFeatures(nn.Module):
    """3 -> 64 -> 128 -> 256 (3x3 conv-norm-ReLU, then a residual block, each),
    then a 1x1 projection to ``features``."""

    def __init__(self, features: int = 256):
        super().__init__()
        ch = 3
        for i, out in enumerate((64, 128, 256)):
            self.add_module(f"conv{i}", ConvNormAct(ch, out))
            self.add_module(f"res{i}", ResidualBlock(out))
            ch = out
        self.proj = ConvNormAct(256, features, k=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"res{i}")(getattr(self, f"conv{i}")(x))
        return self.proj(x)


class EnhancedUNet(nn.Module):
    """Depth-3 UNet (two residual blocks a level, base width doubling) with a
    sigmoid-gated bottleneck; 2-class (bg/fg) logits at the input's size."""

    def __init__(self, cin: int, base: int = 96, depth: int = 3):
        super().__init__()
        ch = [base * 2 ** i for i in range(depth)]
        self.depth = depth
        self.enc0_in = ConvNormAct(cin, ch[0])
        self.enc0_res0, self.enc0_res1 = ResidualBlock(ch[0]), ResidualBlock(ch[0])
        for i in range(1, depth):
            self.add_module(f"enc{i}_res0", ResidualBlock(ch[i - 1]))
            self.add_module(f"enc{i}_res1", ResidualBlock(ch[i - 1]))
            self.add_module(f"enc{i}_out", ConvNormAct(ch[i - 1], ch[i]))
        self.bott_res0, self.bott_res1 = ResidualBlock(ch[-1]), ResidualBlock(ch[-1])
        self.bott_cna = ConvNormAct(ch[-1], ch[-1])
        self.bott_att = Conv(ch[-1], ch[-1], 1)
        self.bott_conv = Conv(ch[-1], ch[-1], 3)
        for d, i in enumerate(range(depth - 1, 0, -1)):
            self.add_module(f"up{d}", Up(ch[i], ch[i - 1]))
            self.add_module(f"dec{d}_in", ConvNormAct(2 * ch[i - 1], ch[i - 1]))
            self.add_module(f"dec{d}_res0", ResidualBlock(ch[i - 1]))
            self.add_module(f"dec{d}_res1", ResidualBlock(ch[i - 1]))
        self.final_cna = ConvNormAct(ch[0], ch[0] // 2)
        self.final_out = Conv(ch[0] // 2, 2, 1)

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
                x = self._run(x, f"enc{i}_res0", f"enc{i}_res1", f"enc{i}_out")
            skips.append(x)
            if i < self.depth - 1:
                x = F.max_pool2d(x, 2, 2)
        a = torch.sigmoid(self.bott_att(self._run(x, "bott_res0", "bott_res1", "bott_cna")))
        x = self.bott_conv(x) * a
        for d, i in enumerate(range(self.depth - 1, 0, -1)):
            skip = skips[i - 1]
            x = _resize(getattr(self, f"up{d}")(x), skip.shape[2], skip.shape[3])
            x = self._run(torch.cat([x, skip], dim=1), f"dec{d}_in", f"dec{d}_res0",
                          f"dec{d}_res1")
        return self.final_out(self.final_cna(x))


class HierarchicalHead(nn.Module):
    """Shared trunk; bg/fg logits from the EnhancedUNet, upsampled 2x; an fg
    gate on the shared features for the target/non-target branch; combine
    ``[bgfg0, bgfg1 + tnt0 * P(fg), bgfg1 + tnt1 * P(fg)]``."""

    def __init__(self, cin: int, mid: int, mask_size: Tuple[int, int], base: int, depth: int):
        super().__init__()
        self.mask_size = tuple(mask_size)
        self.shared_in = ConvNormAct(cin, mid)
        self.shared_res0, self.shared_res1 = ResidualBlock(mid), ResidualBlock(mid)
        self.bg_vs_fg_unet = EnhancedUNet(mid, base, depth)
        self.upsample_deconv = Up(2, 32)
        self.upsample_norm = LayerNorm2d(32)
        self.upsample_out = Conv(32, 2, 1)
        self.gate0 = Conv(2, mid // 4, 1)
        self.gate1 = Conv(mid // 4, mid // 2, 1)
        self.gate2 = Conv(mid // 2, mid, 1)
        self.tnt_res0 = ResidualBlock(mid)
        self.tnt_deconv = Up(mid, mid // 2)
        self.tnt_norm = LayerNorm2d(mid // 2)
        self.tnt_res1 = ResidualBlock(mid // 2)
        self.tnt_out = Conv(mid // 2, 2, 1)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        mh, mw = self.mask_size
        shared = self.shared_res1(self.shared_res0(self.shared_in(features)))
        low = self.bg_vs_fg_unet(shared)
        up = F.relu(self.upsample_norm(self.upsample_deconv(low)))
        bg_fg = _resize(self.upsample_out(up), mh, mw)
        g = F.relu(self.gate1(F.relu(self.gate0(low))))
        t = self.tnt_res0(shared * torch.sigmoid(self.gate2(g)))
        t = self.tnt_res1(F.relu(self.tnt_norm(self.tnt_deconv(t))))
        tnt = _resize(self.tnt_out(t), mh, mw)
        fg_p = torch.softmax(bg_fg, dim=1)[:, 1:2]
        fg = bg_fg[:, 1:2]
        return torch.cat([bg_fg[:, 0:1], fg + tnt[:, 0:1] * fg_p, fg + tnt[:, 1:2] * fg_p], 1)


class RefinedHead(nn.Module):
    """The served head: the hierarchical head held as ``base_head``."""

    def __init__(self, cin: int, mid: int, mask_size: Tuple[int, int], base: int, depth: int):
        super().__init__()
        self.base_head = HierarchicalHead(cin, mid, mask_size, base, depth)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.base_head(features)


# ---- the whole model ----------------------------------------------------------


def roi_align(maps: torch.Tensor, rois: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """maps (B, C, H, W), rois (N, 5) ``[image, x1, y1, x2, y2]`` in [0, 1] ->
    (N, C, oh, ow): bilinear samples on an evenly spaced grid from corner to
    corner of each box (pixel space, no half-pixel shift), zero outside."""
    _, _, h, w = maps.shape
    t_y = torch.linspace(0.0, 1.0, oh, device=maps.device)
    t_x = torch.linspace(0.0, 1.0, ow, device=maps.device)
    y = rois[:, 2, None] * h + t_y * ((rois[:, 4] - rois[:, 2]) * h)[:, None]  # (N, oh)
    x = rois[:, 1, None] * w + t_x * ((rois[:, 3] - rois[:, 1]) * w)[:, None]  # (N, ow)
    gy = (2.0 * y / (h - 1) - 1.0)[:, :, None].expand(-1, oh, ow)
    gx = (2.0 * x / (w - 1) - 1.0)[:, None, :].expand(-1, oh, ow)
    grid = torch.stack([gx, gy], dim=-1)
    picked = maps.index_select(0, rois[:, 0].long())
    return F.grid_sample(picked, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


class Flagship(nn.Module):
    """The served two-stage model. :meth:`stage1` gives the one-channel logit
    map and the binary masks of a block of images; :meth:`stage2` the class
    logits and the instance masks of a block of RoIs, from the images and
    that map."""

    def __init__(self, variant: str, roi_size: Tuple[int, int], mask_size: Tuple[int, int],
                 image_size: Tuple[int, int], mid_channels: int, feature_dim: int = 256,
                 base_channels: int = 96, depth: int = 3, dilation_pixels: int = 1):
        super().__init__()
        self.roi_size, self.mask_size = tuple(roi_size), tuple(mask_size)
        self.image_size = tuple(image_size)
        self.dilation_pixels = dilation_pixels
        self.pretrained_unet = UNet(variant)
        self.unet_wrapper = Wrapper()
        self.rgb_extractor = RGBFeatures(feature_dim)
        self.feature_combiner = Conv(feature_dim + 2, feature_dim, 1)
        self.head = RefinedHead(feature_dim, mid_channels, mask_size, base_channels, depth)

    def stage1(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) in [0, 1] -> (logits (B, 1, H, W), binary (B, H, W, 1))."""
        logits = self.pretrained_unet(images.permute(0, 3, 1, 2))
        binary = torch.softmax(self.unet_wrapper(logits), dim=1)[:, 0:1]
        return logits, binary.permute(0, 2, 3, 1)

    def stage2(self, images: torch.Tensor, logits: torch.Tensor,
               rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3), stage-1 logits (B, 1, H, W) of the same images,
        rois (N, 5) naming them -> (class logits (N, 3, mh, mw), instance
        masks (N, mh, mw, 1))."""
        rh, rw = self.roi_size
        out = self.from_crops(roi_align(images.permute(0, 3, 1, 2), rois, rh, rw),
                              roi_align(logits, rois, rh, rw))
        return out, instance_masks(out, self.dilation_pixels)

    def from_crops(self, rgb: torch.Tensor, logit_crop: torch.Tensor) -> torch.Tensor:
        """RGB crops (N, 3, rh, rw) and one-channel logit crops (N, 1, rh, rw)
        -> class logits (N, 3, mh, mw)."""
        feats = self.rgb_extractor(rgb)
        bg_fg = self.unet_wrapper(logit_crop)
        return self.head(self.feature_combiner(torch.cat([feats, bg_fg], dim=1)))


def instance_masks(logits: torch.Tensor, dilation_pixels: int) -> torch.Tensor:
    """Class logits (N, 3, mh, mw) -> (N, mh, mw, 1): 1.0 where the target
    class wins once its logit gets +2 wherever the (2d+1) max-pooled target
    probability exceeds the probability by more than 0.1."""
    if dilation_pixels > 0:
        target = torch.softmax(logits, dim=1)[:, 1:2]
        dilated = F.max_pool2d(target, 2 * dilation_pixels + 1, 1, dilation_pixels)
        boost = torch.where(dilated - target > 0.1, 2.0, 0.0)
        logits = torch.cat([logits[:, 0:1], logits[:, 1:2] + boost, logits[:, 2:]], dim=1)
    return (logits.argmax(dim=1) == 1).to(torch.float32)[..., None]


# the model switches this reference implements, at the values it implements
# them (the contour and distance branches feed only auxiliary outputs)
IMPLEMENTS = {"norm": "layernorm2d", "activation": "relu", "stage1_upsample_mode": "bilinear",
              "unet_decoder_channels": [256, 128, 64, 32, 16], "use_attention_module": False,
              "use_boundary_refinement": False, "use_progressive_upsampling": False,
              "use_subpixel_conv": False, "use_guided_head": False}


def build(config: dict, device) -> Flagship:
    """The reference of a configuration file (its ``model`` block holds the
    served model's keyword arguments, its ``engine`` block the dilation),
    with empty parameters on ``device`` (``meta`` to count work without
    memory). A switch it does not implement raises."""
    m = config["model"]
    for key, want in IMPLEMENTS.items():
        if m[key] != want:
            raise ValueError(f"the flagship reference implements {key}={want!r}, "
                             f"not {m[key]!r}")
    if not (m["use_contour_detection"] or m["use_distance_transform"]):
        raise ValueError("the flagship reference implements the refined head")
    with torch.device(device):
        return Flagship(m["encoder_variant"], m["roi_size"], m["mask_size"], m["image_size"],
                        m["mid_channels"], m["feature_dim"], m["base_channels"], m["depth"],
                        config["engine"]["dilation_pixels"]).eval()


def load(model: Flagship, weights: Dict[str, torch.Tensor]) -> None:
    """Copy every parameter and buffer of ``model`` from ``weights`` (by
    name, as float32); a missing name or a shape that differs raises."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    with torch.no_grad():
        for name, t in own.items():
            if name not in weights:
                raise KeyError(f"reference parameter {name} not among the weights")
            if tuple(weights[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: {tuple(weights[name].shape)} != {tuple(t.shape)}")
            t.copy_(weights[name].to(torch.float32))


def convs(model: nn.Module) -> Iterator[Tuple[str, Conv]]:
    """(path with ``/`` separators, conv) of every :class:`Conv`."""
    for name, mod in model.named_modules():
        if isinstance(mod, Conv):
            yield name.replace(".", "/"), mod


@contextlib.contextmanager
def record_ranges(model: nn.Module) -> Iterator[Dict[str, float]]:
    """Record each conv's input abs-max while the block runs; on exit the
    yielded dict holds the largest per path."""
    found: Dict[str, float] = {}
    pairs = list(convs(model))
    for _, c in pairs:
        c.ranges = []
    try:
        yield found
    finally:
        for path, c in pairs:
            if c.ranges:
                found[path] = float(torch.stack(c.ranges).max())
            c.ranges = None


def quantize_convs(model: nn.Module, ranges: Dict[str, float], groups: Iterable[str],
                   min_contraction: int, bits: int) -> List[str]:
    """Make every conv under one of ``groups`` (path prefixes) whose
    contraction is at least ``min_contraction`` compute on ``bits``-bit
    symmetric codes: per-tensor input scales from ``ranges``, per-channel
    weight scales. Returns the paths so quantized."""
    groups = tuple(groups)
    done = []
    for path, c in convs(model):
        if path.startswith(groups) and c.contraction >= min_contraction and path in ranges:
            scale = max(ranges[path], 1e-12) / (2 ** (bits - 1) - 1)
            c.quant = (torch.tensor(scale, device=c.weight.device), bits)
            done.append(path)
    return done
