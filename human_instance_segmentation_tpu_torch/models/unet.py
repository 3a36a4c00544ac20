"""Full-image people-segmentation UNet, stage 1 (NCHW, plain form).

Counterpart of the JAX package's ``models/unet.py`` without the phase-form
serving rewrites (``fused_tail``, ``encoder_s2d_front``, ``n4_tail``):
ImageNet normalisation, the EfficientNet encoder, five smp decoder stages
(2x upsample, skip concat, (conv3x3-BN-ReLU) x 2, BN eps 1e-5) and a 3x3
segmentation head with bias.

``pallas_tail=True`` (the JAX flag's name) computes the last decoder stage
and the seg head as one fused unit, ``ops/cuda_tail.tail``: a hand-written
CUDA kernel on a CUDA tensor, its plain version on the CPU. Under int8
serving with the three calibrated scales of the tail (``<path>/decoder4#x``,
``<path>/decoder4#mid``, ``<path>#head``, recorded by a calibration pass) the
unit is ``ops/cuda_tail.tail_q``, its s8 form; without them it stays the
float one, as in the JAX package. ``encoder_fused_blocks=N`` runs the first N
encoder blocks through the fused MBConv kernel in eval mode. The parameters
are the same by name, so checkpoints swap between the forms.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_tail
from ..ops.norms import BatchNorm2d
from ..ops.quant import QConv
from ..ops.s2d import upsample_2x_nearest
from ..ops.sampling import resize_bilinear
from .efficientnet import EfficientNetEncoder, encoder_feature_channels

_NCHW = (2, 3)


def kept_constant(kept: Dict[tuple, torch.Tensor], name: str, values,
                  like: torch.Tensor) -> torch.Tensor:
    """``torch.tensor(values)`` in ``like``'s dtype on its device, made at
    the first forward that asks and kept in ``kept`` under (``name``, dtype,
    device), so a later forward copies nothing from the host (a CUDA graph
    cannot capture such a copy). Made outside inference mode, so autograd
    may save it; nothing is kept under ``torch.export`` or
    ``torch.compile``, whose tracing tensors are no constants."""
    key = (name, like.dtype, like.device)
    t = kept.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=like.dtype, device=like.device)
        if not torch.compiler.is_compiling():
            kept[key] = t
    return t


class DecoderBlock(nn.Module):
    """2x upsample -> concat skip -> (conv-BN-ReLU) x 2."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 upsample_mode: str = "bilinear"):
        super().__init__()
        if upsample_mode not in ("bilinear", "nearest"):
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}")
        self.upsample_mode = upsample_mode
        self.conv0 = QConv(in_channels + skip_channels, features, 3, padding=1, bias=False)
        self.bn0 = BatchNorm2d(features)
        self.conv1 = QConv(features, features, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor],
                sow: Optional[Callable[[str, torch.Tensor], None]] = None) -> torch.Tensor:
        """``sow(tag, tensor)``, when given, is handed the block's input
        (``"x"``) and conv1's input (``"mid"``): the calibration points of
        the fused tail."""
        h, w = x.shape[2:]
        if sow is not None:
            sow("x", x)
        if self.upsample_mode == "nearest":
            x = upsample_2x_nearest(x, _NCHW)
        else:
            x = resize_bilinear(x, 2 * h, 2 * w, axes=_NCHW)
        if skip is not None:
            if x.shape[2:] != skip.shape[2:]:
                x = resize_bilinear(x, skip.shape[2], skip.shape[3], axes=_NCHW)
            x = torch.cat([x, skip], dim=1)
        x = F.relu(self.bn0(self.conv0(x)))
        if sow is not None:
            sow("mid", x)
        return F.relu(self.bn1(self.conv1(x)))


class PeopleSegmentationUNet(nn.Module):
    """EfficientNet-UNet: images in [0, 1] (B, 3, H, W) -> logits
    (B, classes, H, W); ImageNet normalisation inside."""

    tail_builds = 0  # packs made by _tail_operands() (always on; still in steady serving)

    def __init__(self, encoder_variant: str = "b0",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16), classes: int = 1,
                 normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406),
                 normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225),
                 upsample_mode: str = "bilinear", pallas_tail: bool = False,
                 encoder_fused_blocks: int = 0):
        super().__init__()
        self.classes = classes
        self.upsample_mode = upsample_mode
        self.pallas_tail = pallas_tail
        # (s_x, s_mid, s_head) of the s8 tail, set by ops.quant.set_int8_serving
        self.tail_scales: Optional[Tuple[float, float, float]] = None
        # {(sub-path, tag): [abs-max, ...]} while ops.quant.calibration records
        self.calib_tags: Optional[Dict[Tuple[str, str], list]] = None
        self._tail_packed = None  # (key, weights kept alive, packed operands)
        self.normalize_mean = tuple(normalize_mean)
        self.normalize_std = tuple(normalize_std)
        self._kept: Dict[tuple, torch.Tensor] = {}  # (name, dtype, device) -> constant
        self.encoder = EfficientNetEncoder(encoder_variant, fused_blocks=encoder_fused_blocks)
        taps = encoder_feature_channels(encoder_variant)
        skips = list(taps[:-1])[::-1]  # s16, s8, s4, s2
        ch = taps[-1]
        self.n_decoders = len(decoder_channels)
        for i, out_ch in enumerate(decoder_channels):
            skip_ch = skips[i] if i < len(skips) else 0
            self.add_module(f"decoder{i}", DecoderBlock(ch, skip_ch, out_ch, upsample_mode))
            ch = out_ch
        self.seg_head = nn.Conv2d(ch, classes, 3, padding=1)

    @property
    def _last(self) -> DecoderBlock:
        return getattr(self, f"decoder{self.n_decoders - 1}")

    def set_tail_scales(self, scales: Optional[Dict[str, float]], path: str) -> None:
        """Take the s8 tail's three calibrated scales from a scale dict keyed
        as the JAX package keys them (``path`` is this module's path, ``/``
        separated); ``None`` where one is missing (models/unet.py:382)."""
        pfx = path + "/" if path else ""
        stage = f"{pfx}decoder{self.n_decoders - 1}"
        got = tuple((scales or {}).get(k) for k in (f"{stage}#x", f"{stage}#mid", f"{path}#head"))
        self.tail_scales = None if None in got else got

    def _sow(self, sub: str, tag: str, x: torch.Tensor) -> None:
        self.calib_tags.setdefault((sub, tag), []).append(x.abs().amax().to(torch.float32))

    def _tail_form(self, last_skip: Optional[torch.Tensor]) -> Optional[str]:
        """Which fused tail replaces the last stage: ``None``, ``"float"`` or
        ``"int8"``. What is semantic of the JAX gate (eval mode, bilinear
        upsample, a skip-free last stage, one class, no calibration pass),
        without its TPU tiling conditions; int8 when the stage's convs run
        int8 and the three scales are there."""
        if not (self.pallas_tail and not self.training and self.upsample_mode == "bilinear"
                and last_skip is None and self.classes == 1):
            return None
        last = self._last
        if last.conv0.calib_amax is not None or self.calib_tags is not None:
            return None  # a calibration pass records the unfused stage's ranges
        if last.conv0.runs_int8 and last.conv1.runs_int8 and self.tail_scales is not None:
            return "int8"
        return "float"

    def _tail_operands(self, operands, dtype: torch.dtype, form: str):
        """The fused tail's packed kernel operands (the s8 tail's with its
        float border's for ``"int8"``, the bf16 tail's for ``"float"``), made
        once and kept until a weight, a BN statistic, a scale or the dtype
        changes."""
        tensors = [operands[0], *operands[1], operands[2], *operands[3], *operands[4:]]
        if any(t.is_inference() for t in tensors):
            return None
        key = (form, dtype, self.tail_scales if form == "int8" else None,
               tuple((t.device, t.data_ptr(), t._version) for t in tensors))
        if self._tail_packed is None or self._tail_packed[0] != key:
            PeopleSegmentationUNet.tail_builds += 1
            with torch.inference_mode(False), torch.no_grad():
                if form == "int8":
                    wq = cuda_tail.build_tail_weights_q(*operands, *self.tail_scales)
                    packed = cuda_tail.pack_tail_weights_q(wq, operands, dtype)
                else:
                    packed = cuda_tail.pack_tail_weights(*operands)
                self._tail_packed = (key, tensors, packed)
        return self._tail_packed[2]

    def _fused_tail(self, h: torch.Tensor, form: str) -> torch.Tensor:
        """Decoder output (B, Ci, h, w) -> dense logits (B, 2h, 2w)."""
        last = self._last

        def hwio(conv):
            return conv.weight.permute(2, 3, 1, 0)

        def bn(m):
            return (m.weight, m.bias, m.running_mean, m.running_var)

        operands = (hwio(last.conv0), bn(last.bn0), hwio(last.conv1), bn(last.bn1),
                    hwio(self.seg_head), self.seg_head.bias)
        x = h.permute(0, 2, 3, 1)
        if form == "int8":
            packed = self._tail_operands(operands, h.dtype, form) if h.is_cuda else None
            return cuda_tail.tail_q(x, *operands, *self.tail_scales, packed=packed)
        if h.is_cuda and h.dtype == torch.bfloat16:
            return cuda_tail.tail(x, *operands, packed=self._tail_operands(operands, h.dtype, form))
        return cuda_tail.tail(x, *operands)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """``(images - mean) / std`` over the channel axis of (B, 3, H, W),
        the constants in the images' dtype (:func:`kept_constant`)."""
        mean = kept_constant(self._kept, "mean", self.normalize_mean, images)
        std = kept_constant(self._kept, "std", self.normalize_std, images)
        return (images - mean[:, None, None]) / std[:, None, None]

    def forward(self, images: torch.Tensor, raw: bool = False):
        """Logits (B, classes, H, W). With ``raw=True`` returns ``(form,
        tensor)``: ``("dense", (B, H, W))`` when the fused tail ran (the
        one-class logit map without a channel axis), else ``("plain",
        (B, classes, H, W))``."""
        feats = self.encoder(self.normalize(images))
        skips = list(feats[:-1])[::-1]
        h = feats[-1]
        for i in range(self.n_decoders):
            skip = skips[i] if i < len(skips) else None
            last = i == self.n_decoders - 1
            form = self._tail_form(skip) if last else None
            if form is not None:
                y = self._fused_tail(h, form)
                return ("dense", y) if raw else y[:, None]
            name = f"decoder{i}"
            sow = None
            if last and self.pallas_tail and self.calib_tags is not None:
                sow = functools.partial(self._sow, name)  # the s8 tail's calibration points
            h = getattr(self, name)(h, skip, sow)
            if sow is not None:
                self._sow("", "head", h)
        y = self.seg_head(h)
        return ("plain", y) if raw else y


class PeopleSegUNetWrapper(nn.Module):
    """1ch -> 2ch linear map initialised to [+x, -x] (a real 1x1 conv, so
    perturbed checkpoints stay loadable). ``softmax(...)[:, 0]`` is the
    deployed binary mask."""

    def __init__(self):
        super().__init__()
        self.output_conv = nn.Conv2d(1, 2, 1)
        with torch.no_grad():
            self.output_conv.weight.copy_(torch.tensor([1.0, -1.0]).reshape(2, 1, 1, 1))
            self.output_conv.bias.zero_()

    def forward(self, x1: torch.Tensor) -> torch.Tensor:
        return self.output_conv(x1)
