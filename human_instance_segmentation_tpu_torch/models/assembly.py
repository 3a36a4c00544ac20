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

Stage 1 is frozen (``freeze_pretrained=True``, the JAX default,
assembly.py:117): the UNet and the wrapper stay in eval mode after
``model.train()`` and run without autograd (``torch.no_grad``, where JAX
has ``stop_gradient``, assembly.py:186-195, :253-263), so no gradient
reaches them and, on the GPU, the fused tail and the fused MBConv blocks
run inside every train step as they do when serving.

Public I/O is NHWC as in the JAX package; the modules run NCHW inside.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..ops import cuda_roi_align, sampling
from ..ops.quant import QConv
from .blocks import ConvNormAct, ResidualBlock, prequantize_for
from .heads import RefinedHierarchicalHead
from .unet import PeopleSegmentationUNet, PeopleSegUNetWrapper


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class RGBPatchFeatureExtractor(nn.Module):
    """Stride-1 conv stack over ROI RGB patches: 3 -> 64 -> 128 -> 256 with
    a residual block after each conv, then a 1x1 projection."""

    def __init__(self, feature_dim: int = 256, norm: str = "layernorm2d",
                 activation: str = "relu"):
        super().__init__()
        kw = dict(norm=norm, activation=activation)
        ch = 3
        for i, out in enumerate((64, 128, 256)):
            self.add_module(f"conv{i}", ConvNormAct(ch, out, **kw))
            self.add_module(f"res{i}", ResidualBlock(out, **kw))
            ch = out
        self.proj = ConvNormAct(256, feature_dim, kernel=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            cna = getattr(self, f"conv{i}")
            if i > 0:  # res{i-1}'s output is single-use: int8 flows (serving)
                x = prequantize_for(cna.conv, x)
            x = getattr(self, f"res{i}")(cna(x))
        return self.proj(prequantize_for(self.proj.conv, x, k=1))


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
                 freeze_pretrained: bool = True):
        super().__init__()
        if not (use_contour_detection or use_distance_transform):
            # the JAX model then takes PretrainedUNetGuidedHead instead
            raise NotImplementedError("PretrainedUNetGuidedHead is not ported yet")
        if not freeze_pretrained:
            # stage 1 would then train its BatchNorms on batch statistics
            raise NotImplementedError(
                "freeze_pretrained=False is not ported yet (ROADMAP A3: the port's BatchNorm2d "
                "is eval only, so an unfrozen stage 1 would train on frozen statistics)")
        self.freeze_pretrained = freeze_pretrained
        self.roi_size = tuple(roi_size)
        self.mask_size = tuple(mask_size)
        self.image_size = tuple(image_size)
        self.pallas_roi_align = pallas_roi_align
        self.pretrained_unet = PeopleSegmentationUNet(
            encoder_variant, unet_decoder_channels, upsample_mode=stage1_upsample_mode,
            pallas_tail=pallas_tail, encoder_fused_blocks=encoder_fused_blocks)
        self.unet_wrapper = PeopleSegUNetWrapper()
        self.rgb_extractor = RGBPatchFeatureExtractor(feature_dim, norm, activation)
        self.feature_combiner = QConv(feature_dim + 2, feature_dim, 1)
        self.head = RefinedHierarchicalHead(
            feature_dim, mid_channels, mask_size, use_contour_detection,
            use_distance_transform, norm, activation, base_channels, depth)

    def train(self, mode: bool = True) -> "HierarchicalInstanceSegmenter":
        """Set the mode of stage 2; the frozen stage 1 (the UNet and its
        wrapper) stays in eval mode, as the JAX model runs it with
        ``train=False``."""
        super().train(mode)
        self.pretrained_unet.eval()
        self.unet_wrapper.eval()
        return self

    def stage1(self, images: torch.Tensor) -> torch.Tensor:
        """Full-image two-channel person logits ``(B, H, W, 2)`` ([fg, bg] =
        [+x, -x] at the wrapper's initial weights), without autograd."""
        with torch.no_grad():
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
        probe = self.unet_wrapper(torch.tensor([0.0, 1.0], dtype=x.dtype,
                                               device=x.device).reshape(2, 1, 1, 1))
        bias = probe[0, :, 0, 0]
        wvec = probe[1, :, 0, 0] - bias
        return torch.sigmoid(x * (wvec[0] - wvec[1]) + (bias[0] - bias[1]))

    def stage2(self, roi_rgb: torch.Tensor,
               roi_bg_fg: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The per-ROI stage: RGB crops (N, rh, rw, 3) and stage-1 logit
        crops (N, rh, rw, 2) -> (logits (N, mh, mw, 3), the head's aux),
        NHWC."""
        rgb_features = self.rgb_extractor(_nchw(roi_rgb))
        combined = self.feature_combiner(torch.cat([rgb_features, _nchw(roi_bg_fg)], dim=1))
        logits, aux = self.head(combined)
        return _nhwc(logits), {k: _nhwc(v) for k, v in aux.items()}

    def forward(self, images: torch.Tensor,
                rois: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if tuple(images.shape[1:3]) != self.image_size:
            raise ValueError(f"model built for {self.image_size}, got {tuple(images.shape[1:3])}")
        with torch.no_grad():  # the frozen stage 1 and the crops, which need no gradient
            form, x1 = self.pretrained_unet(_nchw(images), raw=True)
            if form == "dense":  # x1 (B, H, W): the fused tail's one-channel logit map
                roi_rgb, roi1 = self._crops(images, x1[..., None], rois)
                roi_bg_fg = _nhwc(self.unet_wrapper(_nchw(roi1))).contiguous()
                full_image_logits = _nhwc(self.unet_wrapper(x1[:, None]))
                person_prob = self.person_prob(x1)
            else:
                full_image_logits = _nhwc(self.unet_wrapper(x1))
                roi_rgb, roi_bg_fg = self._crops(images, full_image_logits, rois)

        logits, aux = self.stage2(roi_rgb, roi_bg_fg)
        if form == "dense":
            aux["person_prob_dense"] = person_prob
        aux["full_image_logits"] = full_image_logits
        aux["roi_bg_fg"] = roi_bg_fg
        aux["roi_patches"] = roi_rgb
        return logits, aux
