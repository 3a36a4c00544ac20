"""The flagship two-stage model: full-image UNet, RoI crops, RGB feature
stack and the hierarchical head.

Counterpart of the JAX package's ``models/assembly.py`` in its plain branch
(assembly.py:260-264): the stage-1 logit map is materialised at full
resolution, and both RoI crops (the RGB image and the 2-channel logit map)
are taken by one launch of ``ops.cuda_roi_align.roi_align_pair`` when
``pallas_roi_align`` is on (the JAX flag name; here it is on by default and
covers both crops). With it off, and in training, the crops call the plain
``ops.sampling.roi_align`` once each.

With ``pallas_tail=True`` it is the JAX package's dense branch
(assembly.py:246-259): stage 1 ends in the fused tail (``ops/cuda_tail``)
and hands over a one-channel ``(B, H, W)`` logit map, which is cropped at
one channel before the 1 -> 2 channel wrapper (RoIAlign is linear, so the
two commute, except that a wrapper bias then also reaches the crop's
zero-padded out-of-image samples, as in the JAX package) and gives
``aux["person_prob_dense"]``. ``encoder_fused_blocks=N`` is handed down to
the stage-1 encoder (the first N MBConv blocks through the fused kernel).

Stage 1 is frozen by default (``freeze_pretrained=True``, the JAX default,
assembly.py:117): the UNet and the wrapper stay in eval mode after
``model.train()`` and run without autograd (``torch.no_grad``, where JAX
has ``stop_gradient``, assembly.py:186-195, :253-263), so no gradient
reaches them and, on the GPU, the fused tail and the fused MBConv blocks
run inside every train step as they do when serving. With
``freeze_pretrained=False`` stage 1 trains: ``model.train()`` reaches it,
its BatchNorms normalise with batch statistics and update their running
ones, gradients reach it through the plain crops, and the fused stage-1
kernels stay off in train mode (they fold running statistics), as the JAX
gates keep them off.

With no refinement flag, or ``use_guided_head``, the head is the JAX
model's ``PretrainedUNetGuidedHead`` fed by the RGB features and the
logit crop, with no ``feature_combiner`` (assembly.py:161-183).

Also here, the other hierarchical families of the JAX package:
:class:`PureRGBHierarchicalModel` (no stage 1; crops with ``aligned=False``
into :class:`RGBFeatureExtractor`, assembly.py:354-384),
:class:`ROIPretrainedHierarchicalModel` (the people-segmentation UNet runs
on each ROI crop, assembly.py:290-351) and
:class:`MultiScaleRGBHierarchicalModel` (three RGB crops, each through its
own extractor, fused at 28 x 28, assembly.py:387-443). They crop with the
plain ``ops.sampling.roi_align``, as the JAX models use no Pallas crop
there.

Public I/O is NHWC as in the JAX package; the modules run NCHW inside.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
from torch import nn

from .. import tracing
from ..ops import cuda_roi_align, sampling
from ..ops.quant import QConv
from .blocks import ConvNormAct, ResidualBlock, prequantize_for
from .heads import HierarchicalHeadV2, PretrainedUNetGuidedHead, RefinedHierarchicalHead
from .unet import PeopleSegmentationUNet, PeopleSegUNetWrapper, kept_constant


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class RGBPatchFeatureExtractor(nn.Module):
    """Stride-1 conv stack over ROI RGB patches: 3 -> 64 -> 128 -> 256 with
    a residual block after each conv, then a 1x1 projection."""

    def __init__(self, feature_dim: int = 256, norm: str = "layernorm2d",
                 activation: str = "relu", norm_groups: int = 8, activation_beta: float = 1.0):
        super().__init__()
        kw = dict(norm=norm, activation=activation, activation_beta=activation_beta)
        ch = 3
        for i, out in enumerate((64, 128, 256)):
            g = min(norm_groups, out)
            self.add_module(f"conv{i}", ConvNormAct(ch, out, norm_groups=g, **kw))
            self.add_module(f"res{i}", ResidualBlock(out, norm_groups=g, **kw))
            ch = out
        self.proj = ConvNormAct(256, feature_dim, kernel=1,
                                norm_groups=min(norm_groups, feature_dim), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            cna = getattr(self, f"conv{i}")
            if i > 0:  # res{i-1}'s output is single-use: int8 flows (serving)
                x = prequantize_for(cna.conv, x)
            x = getattr(self, f"res{i}")(cna(x))
        return self.proj(prequantize_for(self.proj.conv, x, k=1))


class RGBFeatureExtractor(nn.Module):
    """Standalone N-layer extractor of the pure-RGB model: 3 -> 64 -> 128 ->
    192 -> out_channels (the first ``num_layers``), stride 1, a residual
    block after each conv from the second on."""

    def __init__(self, out_channels: int = 256, num_layers: int = 4, norm: str = "layernorm2d",
                 norm_groups: int = 8, activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        kw = dict(norm=norm, activation=activation, activation_beta=activation_beta)
        self.num_layers = num_layers
        ch = 3
        for i, out in enumerate([64, 128, 192, out_channels][:num_layers]):
            g = min(norm_groups, out)
            self.add_module(f"conv{i}", ConvNormAct(ch, out, norm_groups=g, **kw))
            if i >= 1:
                self.add_module(f"res{i}", ResidualBlock(out, norm_groups=g, **kw))
            ch = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x)
            if i >= 1:
                x = getattr(self, f"res{i}")(x)
        return x


def _stage1_context(frozen: bool):
    """``torch.no_grad()`` for a frozen stage 1 (JAX's ``stop_gradient``)."""
    return torch.no_grad() if frozen else contextlib.nullcontext()


class HierarchicalInstanceSegmenter(nn.Module):
    """``forward(images (B, H, W, 3) in [0, 1], rois (N, 5)) ->
    (logits (N, mh, mw, 3), aux)``; rois rows are ``[batch_idx, x1, y1, x2,
    y2]`` normalised to [0, 1]. Every aux tensor is NHWC, with the JAX
    package's keys."""

    def __init__(self, encoder_variant: str = "b0", roi_size: Tuple[int, int] = (64, 48),
                 mask_size: Tuple[int, int] = (128, 96),
                 image_size: Tuple[int, int] = (480, 640), feature_dim: int = 256,
                 mid_channels: int = 256, use_contour_detection: bool = True,
                 use_distance_transform: bool = True, norm: str = "layernorm2d",
                 activation: str = "relu", base_channels: int = 96, depth: int = 3,
                 unet_decoder_channels: Tuple[int, ...] = (256, 128, 64, 32, 16),
                 stage1_upsample_mode: str = "bilinear", pallas_roi_align: bool = True,
                 pallas_tail: bool = False, encoder_fused_blocks: int = 0,
                 freeze_pretrained: bool = True, use_attention_module: bool = False,
                 use_boundary_refinement: bool = False,
                 use_progressive_upsampling: bool = False, use_subpixel_conv: bool = False,
                 use_guided_head: bool = False, norm_groups: int = 8,
                 activation_beta: float = 1.0):
        super().__init__()
        self.encoder_variant = encoder_variant
        self.freeze_pretrained = freeze_pretrained
        self.roi_size = tuple(roi_size)
        self.mask_size = tuple(mask_size)
        self.image_size = tuple(image_size)
        self.pallas_roi_align = pallas_roi_align
        self._kept: Dict[tuple, torch.Tensor] = {}  # person_prob's probe (kept_constant)
        kw = dict(norm=norm, norm_groups=norm_groups, activation=activation,
                  activation_beta=activation_beta)
        self.pretrained_unet = PeopleSegmentationUNet(
            encoder_variant, unet_decoder_channels, upsample_mode=stage1_upsample_mode,
            pallas_tail=pallas_tail, encoder_fused_blocks=encoder_fused_blocks)
        self.unet_wrapper = PeopleSegUNetWrapper()
        self.rgb_extractor = RGBPatchFeatureExtractor(feature_dim, **kw)
        self.use_refinement = any([
            use_boundary_refinement, use_progressive_upsampling, use_subpixel_conv,
            use_contour_detection, use_distance_transform]) and not use_guided_head
        if self.use_refinement:
            self.feature_combiner = QConv(feature_dim + 2, feature_dim, 1)
            self.head = RefinedHierarchicalHead(
                feature_dim, mid_channels, mask_size, use_contour_detection,
                use_distance_transform, base_channels=base_channels, depth=depth,
                use_attention_module=use_attention_module,
                use_boundary_refinement=use_boundary_refinement,
                use_progressive_upsampling=use_progressive_upsampling,
                use_subpixel_conv=use_subpixel_conv, **kw)
        else:
            self.feature_combiner = None
            self.head = PretrainedUNetGuidedHead(
                feature_dim, mid_channels, mask_size,
                use_attention_module=use_attention_module, **kw)

    def train(self, mode: bool = True) -> "HierarchicalInstanceSegmenter":
        """Set the mode; a frozen stage 1 (the UNet and its wrapper) stays in
        eval mode, as the JAX model runs it with ``train=False``."""
        super().train(mode)
        if self.freeze_pretrained:
            self.pretrained_unet.eval()
            self.unet_wrapper.eval()
        return self

    def stage1(self, images: torch.Tensor) -> torch.Tensor:
        """Full-image two-channel person logits ``(B, H, W, 2)`` ([fg, bg] =
        [+x, -x] at the wrapper's initial weights), without autograd when
        stage 1 is frozen."""
        with _stage1_context(self.freeze_pretrained):
            return _nhwc(self.unet_wrapper(self.pretrained_unet(_nchw(images))))

    def _crops(self, images: torch.Tensor, logits: torch.Tensor,
               rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ROI crops of the RGB image and of the logit map, contiguous
        NHWC from either path, so the convs that follow see one layout
        (cuDNN's float32 result depends on it, and int8 serving turns a
        one-ulp difference into whole codes). With ``pallas_roi_align`` (in
        eval mode) one kernel launch crops both maps as they lie; otherwise
        two plain calls on contiguous copies."""
        rh, rw = self.roi_size
        scale = (float(self.image_size[0]), float(self.image_size[1]))
        if self.pallas_roi_align and not self.training:
            return cuda_roi_align.roi_align_pair(images, logits, rois, rh, rw,
                                                 spatial_scale=scale, aligned=True)
        return tuple(sampling.roi_align(x.contiguous(), rois, rh, rw, spatial_scale=scale,
                                        aligned=True).contiguous() for x in (images, logits))

    def person_prob(self, x: torch.Tensor) -> torch.Tensor:
        """``softmax(wrapper(x))[channel 0]`` of one-channel logits of any
        shape, as ``sigmoid((w0 - w1) x + (b0 - b1))``: the wrapper's weights
        are read by a two-point probe, so this holds for any trained
        wrapper and stays elementwise."""
        probe = self.unet_wrapper(kept_constant(self._kept, "probe", [[[[0.0]]], [[[1.0]]]], x))
        bias = probe[0, :, 0, 0]
        wvec = probe[1, :, 0, 0] - bias
        return torch.sigmoid(x * (wvec[0] - wvec[1]) + (bias[0] - bias[1]))

    def stage2(self, roi_rgb: torch.Tensor,
               roi_bg_fg: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The per-ROI stage: RGB crops (N, rh, rw, 3) and stage-1 logit
        crops (N, rh, rw, 2) -> (logits (N, mh, mw, 3), the head's aux),
        NHWC."""
        with tracing.span("model.stage2"):
            rgb_features = self.rgb_extractor(_nchw(roi_rgb))
            if self.feature_combiner is None:
                logits, aux = self.head(rgb_features, _nchw(roi_bg_fg))
            else:
                combined = self.feature_combiner(torch.cat([rgb_features, _nchw(roi_bg_fg)],
                                                           dim=1))
                logits, aux = self.head(combined)
            return _nhwc(logits), {k: _nhwc(v) for k, v in aux.items()}

    def forward(self, images: torch.Tensor,
                rois: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self.from_stage1(images, *self.stage1_raw(images), rois)

    def stage1_raw(self, images: torch.Tensor) -> Tuple[str, torch.Tensor]:
        """The UNet's raw output ``(form, x1)`` on (B, H, W, 3) images
        (``PeopleSegmentationUNet.forward(raw=True)``): per image, so a mesh
        can run it on its slice of the batch and gather the slices."""
        if tuple(images.shape[1:3]) != self.image_size:
            raise ValueError(f"model built for {self.image_size}, got {tuple(images.shape[1:3])}")
        with tracing.span("model.stage1"), _stage1_context(self.freeze_pretrained):
            return self.pretrained_unet(_nchw(images), raw=True)

    def from_stage1(self, images: torch.Tensor, form: str, x1: torch.Tensor,
                    rois: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The rest of :meth:`forward` from :meth:`stage1_raw`'s output for
        the whole batch: the full-image maps, the crops of ``rois`` and
        stage 2."""
        # a frozen stage 1 and the crops need no gradient
        with tracing.span("model.crops"), _stage1_context(self.freeze_pretrained):
            if form == "dense":  # x1 (B, H, W): the fused tail's one-channel logit map
                roi_rgb, roi1 = self._crops(images, x1[..., None], rois)
                roi_bg_fg = _nhwc(self.unet_wrapper(_nchw(roi1))).contiguous()
                full_image_logits = _nhwc(self.unet_wrapper(x1[:, None]))
                person_prob = self.person_prob(x1)
            else:
                full_image_logits = _nhwc(self.unet_wrapper(x1))
                roi_rgb, roi_bg_fg = self._crops(images, full_image_logits, rois)

        logits, aux = self.stage2(roi_rgb, roi_bg_fg)
        aux["full_image_logits"] = full_image_logits
        if form == "dense":
            aux["person_prob_dense"] = person_prob
        aux["roi_bg_fg"] = roi_bg_fg
        aux["roi_patches"] = roi_rgb
        return logits, aux


class ROIPretrainedHierarchicalModel(nn.Module):
    """The people-segmentation UNet on each ROI crop (JAX
    ``ROIPretrainedHierarchicalModel``): RoIAlign RGB patch (``aligned=True``)
    -> UNet -> wrapper -> 2-channel bg/fg logits -> a feature processor
    (2 -> 64 -> 128, a residual block after each, -> ``feature_dim``) ->
    ``HierarchicalHeadV2`` at mid 256. Stage 1 trains unless
    ``freeze_pretrained`` (the registry's config trains it, BatchNorms
    included). Same I/O contract as :class:`HierarchicalInstanceSegmenter`;
    aux adds ``pretrained_bg_fg_logits`` and ``roi_patches``."""

    def __init__(self, encoder_variant: str = "b3", roi_size: Tuple[int, int] = (64, 48),
                 mask_size: Tuple[int, int] = (64, 48), image_size: Tuple[int, int] = (640, 640),
                 feature_dim: int = 256, use_attention_module: bool = False,
                 norm: str = "layernorm2d", norm_groups: int = 8, activation: str = "relu",
                 activation_beta: float = 1.0, freeze_pretrained: bool = False,
                 unet_decoder_channels: Tuple[int, ...] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.freeze_pretrained = freeze_pretrained
        self.roi_size, self.mask_size = tuple(roi_size), tuple(mask_size)
        self.image_size = tuple(image_size)
        kw = dict(norm=norm, activation=activation, activation_beta=activation_beta)
        self.pretrained_unet = PeopleSegmentationUNet(encoder_variant, unet_decoder_channels)
        self.unet_wrapper = PeopleSegUNetWrapper()
        ch = 2
        for i, out in enumerate((64, 128)):
            g = min(norm_groups, out)
            self.add_module(f"proc_conv{i}", ConvNormAct(ch, out, norm_groups=g, **kw))
            self.add_module(f"proc_res{i}", ResidualBlock(out, norm_groups=g, **kw))
            ch = out
        self.proc_out = ConvNormAct(128, feature_dim, norm_groups=min(norm_groups, feature_dim),
                                    **kw)
        self.head = HierarchicalHeadV2(feature_dim, 256, mask_size,
                                       use_attention_module=use_attention_module,
                                       norm_groups=norm_groups, **kw)

    def train(self, mode: bool = True) -> "ROIPretrainedHierarchicalModel":
        """Set the mode; a frozen stage 1 stays in eval mode."""
        super().train(mode)
        if self.freeze_pretrained:
            self.pretrained_unet.eval()
            self.unet_wrapper.eval()
        return self

    def forward(self, images: torch.Tensor,
                rois: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rh, rw = self.roi_size
        scale = (float(self.image_size[0]), float(self.image_size[1]))
        patches = sampling.roi_align(images.contiguous(), rois, rh, rw, spatial_scale=scale,
                                     aligned=True)
        with _stage1_context(self.freeze_pretrained):
            bg_fg = self.unet_wrapper(self.pretrained_unet(_nchw(patches)))
        x = bg_fg
        for i in range(2):
            x = getattr(self, f"proc_res{i}")(getattr(self, f"proc_conv{i}")(x))
        logits, aux = self.head(self.proc_out(x))
        aux["pretrained_bg_fg_logits"] = bg_fg
        aux = {k: _nhwc(v) for k, v in aux.items()}
        aux["roi_patches"] = patches
        return _nhwc(logits), aux


class PureRGBHierarchicalModel(nn.Module):
    """The RGB-only hierarchical model (JAX ``PureRGBHierarchicalModel``):
    RoIAlign RGB patch with ``aligned=False`` -> :class:`RGBFeatureExtractor`
    -> ``HierarchicalHeadV2`` at mid 256 (base 96, depth 3). No stage 1, so
    aux has no full-image map; it adds ``roi_patches``."""

    def __init__(self, roi_size: Tuple[int, int] = (28, 28),
                 mask_size: Tuple[int, int] = (56, 56), image_size: Tuple[int, int] = (640, 640),
                 feature_dim: int = 256, use_attention_module: bool = False,
                 norm: str = "layernorm2d", norm_groups: int = 8, activation: str = "relu",
                 activation_beta: float = 1.0):
        super().__init__()
        self.roi_size, self.mask_size = tuple(roi_size), tuple(mask_size)
        self.image_size = tuple(image_size)
        kw = dict(norm=norm, norm_groups=norm_groups, activation=activation,
                  activation_beta=activation_beta)
        self.rgb_extractor = RGBFeatureExtractor(feature_dim, **kw)
        self.head = HierarchicalHeadV2(feature_dim, 256, mask_size,
                                       use_attention_module=use_attention_module, **kw)

    def forward(self, images: torch.Tensor,
                rois: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rh, rw = self.roi_size
        scale = (float(self.image_size[0]), float(self.image_size[1]))
        patches = sampling.roi_align(images.contiguous(), rois, rh, rw, spatial_scale=scale,
                                     aligned=False)
        logits, aux = self.head(self.rgb_extractor(_nchw(patches)))
        aux = {k: _nhwc(v) for k, v in aux.items()}
        aux["roi_patches"] = patches
        return _nhwc(logits), aux


class MultiScaleRGBHierarchicalModel(nn.Module):
    """Three-scale RGB crops fused before the hierarchical head (JAX
    ``MultiScaleRGBHierarchicalModel``): for each size of ``roi_sizes`` a
    crop (``aligned=False``, at the image's extent) through its own
    :class:`RGBFeatureExtractor` (``rgb_extractor{i}``), resized to 28 x 28;
    ``concat``, ``sum`` or ``adaptive`` (softmax over ``fusion_weights``)
    fusion; a 1x1 projection to ``feature_dim``; ``HierarchicalHeadV2`` at
    mid 256. The 28 x 28 fusion size and the head's width are the JAX
    model's constants. aux adds ``roi_patches``, the first size's crop."""

    def __init__(self, roi_sizes: Tuple[int, ...] = (56, 42, 28),
                 mask_size: Tuple[int, int] = (56, 56), image_size: Tuple[int, int] = (640, 640),
                 feature_dim: int = 256, fusion_method: str = "concat",
                 use_attention_module: bool = False, norm: str = "layernorm2d",
                 norm_groups: int = 8, activation: str = "relu", activation_beta: float = 1.0):
        super().__init__()
        if fusion_method not in ("concat", "sum", "adaptive"):
            raise ValueError(f"unknown fusion method {fusion_method}")
        self.roi_sizes = tuple(roi_sizes)
        self.mask_size, self.image_size = tuple(mask_size), tuple(image_size)
        self.fusion_method = fusion_method
        kw = dict(norm=norm, norm_groups=norm_groups, activation=activation,
                  activation_beta=activation_beta)
        for i in range(len(self.roi_sizes)):
            self.add_module(f"rgb_extractor{i}", RGBFeatureExtractor(feature_dim, **kw))
        if fusion_method == "adaptive":
            self.fusion_weights = nn.Parameter(torch.ones(len(self.roi_sizes)))
        fused = feature_dim * (len(self.roi_sizes) if fusion_method == "concat" else 1)
        self.fusion_proj = ConvNormAct(fused, feature_dim, kernel=1,
                                       **dict(kw, norm_groups=min(norm_groups, feature_dim)))
        self.head = HierarchicalHeadV2(feature_dim, 256, mask_size,
                                       use_attention_module=use_attention_module, **kw)

    def forward(self, images: torch.Tensor,
                rois: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        scale = (float(self.image_size[0]), float(self.image_size[1]))
        images = images.contiguous()
        feats, patches0 = [], None
        for i, rs in enumerate(self.roi_sizes):
            patches = sampling.roi_align(images, rois, rs, rs, spatial_scale=scale,
                                         aligned=False)
            if i == 0:
                patches0 = patches
            f = getattr(self, f"rgb_extractor{i}")(_nchw(patches))
            if tuple(f.shape[2:]) != (28, 28):
                f = sampling.resize_bilinear(f, 28, 28, axes=(2, 3))
            feats.append(f)
        if self.fusion_method == "concat":
            fused = torch.cat(feats, dim=1)
        elif self.fusion_method == "sum":
            fused = sum(feats)
        else:
            w = torch.softmax(self.fusion_weights, dim=0)
            fused = sum(w[i] * f for i, f in enumerate(feats))
        logits, aux = self.head(self.fusion_proj(fused))
        aux = {k: _nhwc(v) for k, v in aux.items()}
        aux["roi_patches"] = patches0
        return _nhwc(logits), aux
