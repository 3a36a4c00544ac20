"""Multi-scale and variable-ROI model families (the YOLO-feature lineage).

Counterpart of the JAX package's ``models/multiscale.py``. The feature
source is a protocol: any dict ``{layer_id: (B, h, w, C)}`` of NHWC maps
with the (channels, stride) of :data:`FEATURE_SPECS` (precomputed YOLOv9
activations, ``data/yolo_features.py``), or :class:`ConvFeaturePyramid`, a
conv backbone that produces the same pyramid in the model.

- :class:`ConvFeaturePyramid`, :class:`FeaturePyramidFusion` (fpn /
  concat / sum);
- :class:`MultiScaleRoIAlign`, :class:`MultiScaleFeatureFusion` (concat /
  sum / adaptive softmax) and :class:`MultiScaleSegmentationModel`;
- :class:`HierarchicalFeatureFusion`, :class:`LightweightRGBEncoder` and
  :class:`VariableROISegmentationModel`.

The models take NHWC images in [0, 1] and ``(N, 5)`` rois and return NHWC
``(logits, aux)`` as the other families do; the submodules run NCHW. A
model built with ``pyramid=False`` has no ``pyramid`` parameters (the JAX
tree of a model initialised with ``features=``) and needs ``features=`` at
every call. Every crop is the plain ``ops.sampling.roi_align`` with
``aligned=True`` at the map's own extent, as the JAX models crop.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.sampling import resize_bilinear, roi_align
from .blocks import ConvNormAct, ResidualBlock
from .heads import HierarchicalHeadV2

# (channels, stride) of the YOLOv9 feature taps
FEATURE_SPECS: Dict[str, Tuple[int, int]] = {
    "layer_3": (256, 4),
    "layer_19": (256, 4),
    "layer_5": (512, 8),
    "layer_22": (512, 8),
    "layer_34": (1024, 8),
}

_NCHW = (2, 3)
Features = Dict[str, torch.Tensor]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _kw(norm: str, norm_groups: int, activation: str, activation_beta: float) -> dict:
    return dict(norm=norm, norm_groups=norm_groups, activation=activation,
                activation_beta=activation_beta)


def _crop(x_nhwc: torch.Tensor, rois: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """RoIAlign of an NHWC map at its own extent (``aligned=True``) -> NCHW."""
    h, w = x_nhwc.shape[1:3]
    return _nchw(roi_align(x_nhwc, rois, rh, rw, spatial_scale=(float(h), float(w)),
                           aligned=True))


def _softmax_sum(weights: torch.Tensor, maps) -> torch.Tensor:
    """``sum(softmax(weights)[i] * maps[i])``, in the JAX module's order."""
    w = torch.softmax(weights, dim=0)
    return sum(w[i] * f for i, f in enumerate(maps))


class ConvFeaturePyramid(nn.Module):
    """A strided conv backbone emitting the FEATURE_SPECS pyramid: images
    (B, 3, H, W) -> ``{layer: (B, C, H / stride, W / stride)}``."""

    def __init__(self, layers: Tuple[str, ...] = ("layer_3", "layer_22", "layer_34"),
                 norm: str = "layernorm2d", norm_groups: int = 8, activation: str = "relu",
                 activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.layers = tuple(layers)
        self.stem0 = ConvNormAct(3, 64, stride=2, **kw)
        self.stem1 = ConvNormAct(64, 128, stride=2, **kw)
        self.s4_res = ResidualBlock(128, **kw)
        self.down8 = ConvNormAct(128, 256, stride=2, **kw)
        self.s8_res = ResidualBlock(256, **kw)
        for layer in self.layers:
            ch, stride = FEATURE_SPECS[layer]
            self.add_module(f"proj_{layer}",
                            ConvNormAct(128 if stride == 4 else 256, ch, kernel=1, **kw))

    def forward(self, images: torch.Tensor) -> Features:
        s4 = self.s4_res(self.stem1(self.stem0(images)))
        s8 = self.s8_res(self.down8(s4))
        return {layer: getattr(self, f"proj_{layer}")(s4 if FEATURE_SPECS[layer][1] == 4 else s8)
                for layer in self.layers}


class FeaturePyramidFusion(nn.Module):
    """FPN-style fusion of a pyramid ``{layer: (B, C, h, w)}``: 1x1 lateral
    convs to ``out_channels``; ``fpn`` adds each coarser level, resized, to
    the next finer one (the levels in the dict's order, sorted by height,
    finest first) and smooths every level with a 3x3 conv; ``concat`` and
    ``sum`` return the laterals."""

    def __init__(self, in_channels: Dict[str, int], out_channels: int = 256,
                 fusion_method: str = "fpn"):
        super().__init__()
        self.fusion_method = fusion_method
        for layer, ch in in_channels.items():
            self.add_module(f"lateral_{layer}", nn.Conv2d(ch, out_channels, 1))
            if fusion_method == "fpn":
                self.add_module(f"smooth_{layer}",
                                nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, features: Features) -> Features:
        lateral = {layer: getattr(self, f"lateral_{layer}")(f) for layer, f in features.items()}
        if self.fusion_method in ("sum", "concat"):
            return lateral
        order = sorted(lateral, key=lambda layer: -lateral[layer].shape[2])
        out: Features = {}
        prev = None
        for layer in reversed(order):  # coarse -> fine
            f = lateral[layer]
            if prev is not None and prev.shape[2:] != f.shape[2:]:
                prev = resize_bilinear(prev, f.shape[2], f.shape[3], axes=_NCHW)
            f = f if prev is None else f + prev
            out[layer] = getattr(self, f"smooth_{layer}")(f)
            prev = f
        return out


class MultiScaleRoIAlign(nn.Module):
    """Per-layer RoIAlign at each map's own extent: ``{layer: (B, h, w, C)}``
    NHWC and normalised rois -> ``{layer: (N, C, rh, rw)}``."""

    def __init__(self, roi_size: Tuple[int, int] = (28, 28)):
        super().__init__()
        self.roi_size = tuple(roi_size)

    def forward(self, features: Features, rois: torch.Tensor) -> Features:
        return {layer: _crop(feat, rois, *self.roi_size) for layer, feat in features.items()}


class MultiScaleFeatureFusion(nn.Module):
    """Each layer's ROI features (sorted by name) reduced by a 1x1
    conv-norm-act to ``out_channels``, fused by ``concat``, ``sum`` or
    ``adaptive`` (a softmax over the learned ``fusion_weights``, ones at
    init), then a 1x1 projection."""

    def __init__(self, in_channels: Dict[str, int], out_channels: int = 256,
                 method: str = "adaptive", norm: str = "layernorm2d", norm_groups: int = 8,
                 activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        if method not in ("concat", "sum", "adaptive"):
            raise ValueError(f"unknown fusion method {method}")
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.method = method
        self.layers = sorted(in_channels)
        for layer in self.layers:
            self.add_module(f"reduce_{layer}",
                            ConvNormAct(in_channels[layer], out_channels, kernel=1, **kw))
        if method == "adaptive":
            self.fusion_weights = nn.Parameter(torch.ones(len(self.layers)))
        fused = out_channels * (len(self.layers) if method == "concat" else 1)
        self.proj = ConvNormAct(fused, out_channels, kernel=1, **kw)

    def forward(self, roi_feats: Features) -> torch.Tensor:
        reduced = [getattr(self, f"reduce_{layer}")(roi_feats[layer]) for layer in self.layers]
        if self.method == "concat":
            fused = torch.cat(reduced, dim=1)
        elif self.method == "sum":
            fused = sum(reduced)
        else:
            fused = _softmax_sum(self.fusion_weights, reduced)
        return self.proj(fused)


class MultiScaleSegmentationModel(nn.Module):
    """Pyramid (or ``features=``) -> per-layer RoIAlign -> fusion ->
    ``HierarchicalHeadV2``; aux adds ``roi_features``, the fused map."""

    def __init__(self, layers: Tuple[str, ...] = ("layer_3", "layer_22", "layer_34"),
                 roi_size: Tuple[int, int] = (28, 28), mask_size: Tuple[int, int] = (56, 56),
                 mid_channels: int = 256, fusion_method: str = "adaptive",
                 use_attention_module: bool = False, norm: str = "layernorm2d",
                 norm_groups: int = 8, activation: str = "relu", activation_beta: float = 1.0,
                 pyramid: bool = True):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.layers = tuple(layers)
        self.roi_size, self.mask_size = tuple(roi_size), tuple(mask_size)
        self.pyramid = ConvFeaturePyramid(self.layers, **kw) if pyramid else None
        self.roi_align = MultiScaleRoIAlign(roi_size)
        self.fusion = MultiScaleFeatureFusion({l: FEATURE_SPECS[l][0] for l in self.layers},
                                              mid_channels, fusion_method, **kw)
        self.head = HierarchicalHeadV2(mid_channels, mid_channels, mask_size,
                                       use_attention_module=use_attention_module, **kw)

    def forward(self, images: torch.Tensor, rois: torch.Tensor,
                features: Optional[Features] = None):
        """images (B, H, W, 3), rois (N, 5), ``features`` an NHWC dict ->
        (logits (N, mh, mw, 3), aux) NHWC."""
        features = _features(self.pyramid, images, features)
        fused = self.fusion(self.roi_align(features, rois))
        logits, aux = self.head(fused)
        aux["roi_features"] = fused
        return _nhwc(logits), {k: _nhwc(v) for k, v in aux.items()}


def _features(pyramid: Optional[ConvFeaturePyramid], images: torch.Tensor,
              features: Optional[Features]) -> Features:
    """The NHWC pyramid: ``features`` as given, else the model's own."""
    if features is not None:
        return features
    if pyramid is None:
        raise ValueError("a model built with pyramid=False needs features=")
    return {k: _nhwc(v) for k, v in pyramid(_nchw(images)).items()}


class HierarchicalFeatureFusion(nn.Module):
    """Variable-ROI fusion: each layer (sorted by name) reduced by a 1x1
    conv-norm-act, brought to ``target_size``: twice the target by a
    stride-2 unit and a 3x3 unit; otherwise larger by a 3x3 unit (twice the
    width at 42), a resize and a 3x3 unit; smaller by a resize and a 3x3
    unit. Then a softmax over ``fusion_weights``, a fusion unit and a
    residual block."""

    def __init__(self, roi_sizes: Dict[str, int], in_channels: Dict[str, int],
                 out_channels: int = 256, target_size: int = 28, norm: str = "layernorm2d",
                 norm_groups: int = 8, activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        oc, ts = out_channels, target_size
        self.roi_sizes, self.target_size = dict(roi_sizes), ts
        self.layers = sorted(in_channels)
        for layer in self.layers:
            self.add_module(f"reduce_{layer}",
                            ConvNormAct(in_channels[layer], oc, kernel=1, **kw))
            rs = self.roi_sizes.get(layer, ts)
            if rs == 2 * ts:
                self.add_module(f"adj_{layer}_a", ConvNormAct(oc, oc, stride=2, **kw))
                self.add_module(f"adj_{layer}_b", ConvNormAct(oc, oc, **kw))
            elif rs > ts:
                wide = oc * 2 if rs == 42 else oc
                self.add_module(f"adj_{layer}_a", ConvNormAct(oc, wide, **kw))
                self.add_module(f"adj_{layer}_b", ConvNormAct(wide, oc, **kw))
            elif rs < ts:
                self.add_module(f"adj_{layer}_up", ConvNormAct(oc, oc, **kw))
        self.fusion_weights = nn.Parameter(torch.ones(len(self.layers)))
        self.fusion_conv = ConvNormAct(oc, oc, **kw)
        self.fusion_res = ResidualBlock(oc, **kw)

    def forward(self, roi_feats: Features) -> torch.Tensor:
        ts = self.target_size
        adjusted = []
        for layer in self.layers:
            f = getattr(self, f"reduce_{layer}")(roi_feats[layer])
            rs = self.roi_sizes.get(layer, ts)
            if rs == 2 * ts:
                f = getattr(self, f"adj_{layer}_b")(getattr(self, f"adj_{layer}_a")(f))
            elif rs > ts:
                f = resize_bilinear(getattr(self, f"adj_{layer}_a")(f), ts, ts, axes=_NCHW)
                f = getattr(self, f"adj_{layer}_b")(f)
            elif rs < ts:
                f = getattr(self, f"adj_{layer}_up")(resize_bilinear(f, ts, ts, axes=_NCHW))
            adjusted.append(f)
        fused = _softmax_sum(self.fusion_weights, adjusted)
        return self.fusion_res(self.fusion_conv(fused))


class LightweightRGBEncoder(nn.Module):
    """3 -> 32 -> ``out_channels`` 3x3 units and a residual block over ROI
    RGB patches."""

    def __init__(self, out_channels: int = 64, norm: str = "layernorm2d", norm_groups: int = 8,
                 activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.c0 = ConvNormAct(3, 32, **kw)
        self.c1 = ConvNormAct(32, out_channels, **kw)
        self.res = ResidualBlock(out_channels, **kw)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.res(self.c1(self.c0(patches)))


class VariableROISegmentationModel(nn.Module):
    """Each layer cropped at its own ROI size (``roi_sizes``, e.g.
    ``{layer_3: 56, layer_22: 42, layer_34: 28}``) -> hierarchical fusion to
    28 x 28 -> ``HierarchicalHeadV2``; aux adds ``roi_features``. With
    ``use_rgb_enhancement`` each layer of ``rgb_enhanced_layers`` that is
    cropped gets the image's RGB crop at its size through a
    :class:`LightweightRGBEncoder`, concatenated and fused back to the
    layer's width by a 1x1 unit."""

    def __init__(self, roi_sizes: Dict[str, int], mask_size: Tuple[int, int] = (56, 56),
                 mid_channels: int = 256, use_rgb_enhancement: bool = False,
                 rgb_enhanced_layers: Tuple[str, ...] = ("layer_34",),
                 use_attention_module: bool = False, norm: str = "layernorm2d",
                 norm_groups: int = 8, activation: str = "relu", activation_beta: float = 1.0,
                 pyramid: bool = True):
        super().__init__()
        kw = _kw(norm, norm_groups, activation, activation_beta)
        self.roi_sizes = dict(roi_sizes)
        self.mask_size = tuple(mask_size)
        self.layers = tuple(sorted(self.roi_sizes))
        self.pyramid = ConvFeaturePyramid(self.layers, **kw) if pyramid else None
        self.rgb_layers = (tuple(l for l in rgb_enhanced_layers if l in self.roi_sizes)
                           if use_rgb_enhancement else ())
        for layer in self.rgb_layers:
            ch = FEATURE_SPECS[layer][0]
            self.add_module(f"rgb_enc_{layer}", LightweightRGBEncoder(**kw))
            self.add_module(f"rgb_fuse_{layer}", ConvNormAct(ch + 64, ch, kernel=1, **kw))
        self.fusion = HierarchicalFeatureFusion(
            self.roi_sizes, {l: FEATURE_SPECS[l][0] for l in self.layers}, mid_channels, **kw)
        self.head = HierarchicalHeadV2(mid_channels, mid_channels, mask_size,
                                       use_attention_module=use_attention_module, **kw)

    def forward(self, images: torch.Tensor, rois: torch.Tensor,
                features: Optional[Features] = None):
        """images (B, H, W, 3), rois (N, 5), ``features`` an NHWC dict ->
        (logits (N, mh, mw, 3), aux) NHWC."""
        features = _features(self.pyramid, images, features)
        sizes = self.roi_sizes
        roi_feats = {layer: _crop(features[layer], rois, sizes[layer], sizes[layer])
                     for layer in self.layers}
        for layer in self.rgb_layers:
            rgb = getattr(self, f"rgb_enc_{layer}")(
                _crop(images, rois, sizes[layer], sizes[layer]))
            enhanced = torch.cat([roi_feats[layer], rgb], dim=1)
            roi_feats[layer] = getattr(self, f"rgb_fuse_{layer}")(enhanced)
        fused = self.fusion(roi_feats)
        logits, aux = self.head(fused)
        aux["roi_features"] = fused
        return _nhwc(logits), {k: _nhwc(v) for k, v in aux.items()}
