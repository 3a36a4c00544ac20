"""Inference runtime: ROI bucketing and the deployed output contract.

Counterpart of the JAX package's ``inference.py``. ROI counts are padded
to power-of-two buckets with sentinel rois (batch_idx = -1), whose
instance masks are zeroed, so a server sees few distinct shapes, as in the
JAX engine. ``InferenceEngine(mesh=)`` serves data parallel over the ranks
of a ``parallel.create_mesh`` mesh (JAX ``inference.py:144-151``,
``:216-239``).

Deployed outputs (the reference ONNX graph's contract, NHWC):
  instance_masks: (N, mh, mw, 1)  1.0 where argmax(class) == 1
  binary_masks:   (B, H, W, 1)    P(person) from the stage-1 UNet

``create_flagship(pallas_tail=True)`` ends stage 1 in the fused tail
(``ops/cuda_tail``; its s8 form under calibrated int8 serving); the binary
mask then comes from ``aux["person_prob_dense"]``.
``create_flagship(encoder_fused_blocks=N)`` runs the first N encoder blocks
through the fused MBConv kernel (``ops/cuda_mbconv``).

The entry points run on the GPU unless the caller asks for the CPU:
``create_flagship`` builds on ``device="cuda"`` by default and raises where
there is no CUDA, and the engine serves on its model's device.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from . import tracing
from .models.assembly import HierarchicalInstanceSegmenter
from .models.blocks import set_head_fusion
from .models.postprocess import mask_dilation_logit_boost
from .models.unet import PeopleSegUNetWrapper
from .ops.quant import calibration, collect_scales, merge_scales, set_int8_serving

DeviceLike = Union[str, torch.device]

# Default int8 denylist (inference.py:39): the whole stage-1 encoder stays
# in the engine's float dtype under int8 serving.
ENCODER_INT8_DENY = ("encoder/",)


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device(device)``, refusing CUDA where there is none (no
    silent fallback to the CPU)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return d


def roi_bucket(n: int, min_bucket: int = 1, max_bucket: int = 64) -> int:
    """Round a ROI count up to the next power-of-two bucket."""
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_bucket) if n <= max_bucket else ((n + max_bucket - 1) // max_bucket) * max_bucket


def pad_rois(rois: np.ndarray, bucket: int) -> np.ndarray:
    """Pad (N, 5) rois to (bucket, 5) with sentinel batch_idx = -1."""
    n = rois.shape[0]
    if n == bucket:
        return rois
    pad = np.zeros((bucket - n, 5), dtype=rois.dtype)
    pad[:, 0] = -1.0
    return np.concatenate([rois, pad], axis=0)


def deployed_outputs(
    logits: torch.Tensor,
    full_image_logits: Union[torch.Tensor, Dict[str, torch.Tensor]],
    rois: torch.Tensor,
    dilation_pixels: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (N, mh, mw, 3), stage-1 logits (B, H, W, 2) or the aux dict,
    rois) -> (instance_masks, binary_masks); ``binary_masks`` is None for a
    model without a full-image stage 1 (the pure-RGB and ROI-pretrained
    families, whose aux has no full-image map)."""
    if dilation_pixels > 0:
        logits = mask_dilation_logit_boost(logits, dilation_pixels)
    instance = (logits.argmax(dim=-1) == 1).to(logits.dtype)[..., None]
    valid = (rois[:, 0] >= 0).to(logits.dtype)[:, None, None, None]
    instance = instance * valid
    if isinstance(full_image_logits, dict):
        aux = full_image_logits
        if "person_prob_dense" in aux:  # fused-tail serving: (B, H, W)
            return instance, aux["person_prob_dense"][..., None]
        full_image_logits = aux.get("full_image_logits")
    if full_image_logits is None:
        return instance, None
    binary = torch.softmax(full_image_logits, dim=-1)[..., 0:1]
    return instance, binary


class InferenceEngine:
    """Bucketed inference on one device for the flagship model, and for the
    models without a full-image stage 1 (no binary masks then): the
    pure-RGB, ROI-pretrained and multi-scale RGB hierarchical models, the
    variable-ROI and the baseline models.

    The engine serves its own copy of ``model`` (``engine.model``), cast to
    ``dtype`` (float32 or bfloat16; LayerNorm2d statistics stay float32) on
    ``device`` and in eval mode: the caller's model keeps its dtype, device,
    mode and serving switches, as the JAX engine leaves ``params`` alone.
    ``fused_head=True`` routes the stage-2 conv + LayerNorm2d + ReLU units
    that pass the JAX package's gate through the fused CUDA kernel; the flag
    is set on the copy at every call, as JAX's ``head_fusion()`` context is
    entered at every trace.

    ``quantize="int8"`` runs every eligible, not denied :class:`QConv` in
    s8 x s8 -> s32 (``int8_deny`` path substrings stay in ``dtype``; the
    default denies the stage-1 encoder) and the fused units in their int8
    form. Activation scales are calibrated from the first batch served, or
    by :meth:`calibrate`; until then :meth:`forward` uses dynamic scales.
    ``kernels=False`` computes the fused unit, the int8 convs, the fused
    stage-1 tail (a model built with ``pallas_tail=True``) and the fused
    encoder blocks (``encoder_fused_blocks``) with their plain PyTorch
    versions on any device: the plain path of the same graph that a GPU run
    holds the kernels against. The LayerNorm2d chains of stage 2 take their
    kernel pair (``ops/cuda_norm``) on the card either way, in both paths
    alike. ``pallas_tail`` with int8 ends stage 1 in the
    s8 fused tail once calibration has recorded its three scales, and in the
    float tail until then.

    ``device=None`` serves on the model's device (``create_flagship`` builds
    on the GPU unless told otherwise).

    ``mesh`` (``parallel.create_mesh``) serves data parallel: every rank of
    the mesh calls the engine with the same request, stage 1 runs on the
    rank's slice of the images and stage 2 on its slice of the ROI bucket.
    A rank crops its ROIs from the stage-1 maps of the images they name, so
    the slices of the stage-1 output are gathered first (``all_gather``),
    and the instance masks and logits are gathered after: every rank
    returns the full outputs. An axis whose extent the world size does not
    divide runs replicated, and the engine logs JAX's warning for it; a
    model without the flagship's stage-1 split (the other families) runs
    its whole batch on every rank and shards the ROI bucket only.
    :meth:`calibrate` under a mesh records each rank's shard and takes the
    maximum of the scales over the ranks, so every rank serves the same
    int8 graph.
    """

    def __init__(
        self,
        model: HierarchicalInstanceSegmenter,
        dilation_pixels: int = 0,
        max_bucket: int = 64,
        dtype: torch.dtype = torch.float32,
        fused_head: bool = False,
        device: Optional[DeviceLike] = None,
        quantize: Optional[str] = None,
        int8_deny: Sequence[str] = ENCODER_INT8_DENY,
        kernels: bool = True,
        mesh=None,
    ):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        dev = (resolve_device(device) if device is not None
               else next(model.parameters()).device)
        self.model = copy.deepcopy(model).to(device=dev, dtype=dtype).eval()
        self.device = dev
        self.dtype = dtype
        self.dilation_pixels = dilation_pixels
        self.max_bucket = max_bucket
        self.fused_head = fused_head
        self.quantize = quantize
        self.int8_deny = tuple(int8_deny)
        self.kernels = kernels
        self.mesh = mesh
        self.scales: Optional[Dict[str, float]] = None
        self._warned: set = set()

    def _stage1_kernels(self) -> None:
        unet = getattr(self.model, "pretrained_unet", None)
        if unet is not None:
            unet.tail_use_kernel = self.kernels
            unet.encoder.set_fused_kernels(self.kernels)

    def calibrate(self, images: np.ndarray, rois: np.ndarray) -> None:
        """Record every eligible QConv's input abs-max on (images, rois),
        served unfused and un-quantized in the engine's dtype (and, for a
        ``pallas_tail`` model, the s8 tail's three points), and fold the
        scales into int8 serving (pointwise max over calls)."""
        with tracing.span("engine.calibrate"):
            bucket = roi_bucket(max(rois.shape[0], 1), max_bucket=self.max_bucket)
            rois_p = torch.as_tensor(pad_rois(np.asarray(rois, np.float32), bucket)).to(
                self.device)
            images_t = torch.as_tensor(np.asarray(images, np.float32)).to(self.device, self.dtype)
            set_head_fusion(self.model, False)
            set_int8_serving(self.model, False)
            self._stage1_kernels()
            with torch.inference_mode(), calibration(self.model) as calib:
                self._model_forward(images_t, rois_p)
            scales = collect_scales(calib)
            if self.mesh is not None:  # every rank serves the same graph
                from .parallel.mesh import all_gather_object

                for other in all_gather_object(scales, self.mesh):
                    scales = merge_scales(scales, other)
            self.scales = merge_scales(self.scales, scales) if self.scales else scales

    def _mesh_plan(self, batch: int, bucket: int) -> Tuple[bool, bool]:
        """Whether the images and the ROI bucket shard over the mesh, logging
        each axis that serves replicated (once per request shape)."""
        from .parallel.mesh import world_of

        world = world_of(self.mesh)
        split = hasattr(self.model, "stage1_raw")
        shard_images, shard_rois = split and batch % world == 0, bucket % world == 0
        if (batch, bucket) not in self._warned:
            self._warned.add((batch, bucket))
            log = logging.getLogger(__name__)
            divides = "InferenceEngine mesh: %s=%d does not divide %d devices; that axis " \
                      "serves REPLICATED"
            if not split:
                log.warning("InferenceEngine mesh: %s has no stage-1 split; the batch serves "
                            "REPLICATED", type(self.model).__name__)
            elif not shard_images:
                log.warning(divides, "batch", batch, world)
            if not shard_rois:
                log.warning(divides, "roi bucket", bucket, world)
        return shard_images, shard_rois

    def _model_forward(self, images: torch.Tensor, rois: torch.Tensor):
        """``(logits, aux, rois)`` of the model: on one device the whole
        request; under a mesh this rank's ROI slice (or all of them, where
        the bucket does not divide), cropped from the whole batch's stage-1
        maps."""
        if self.mesh is None:
            return (*self.model(images, rois), rois)
        from .parallel.mesh import all_gather, rank_of, world_of

        world, rank = world_of(self.mesh), rank_of(self.mesh)
        shard_images, shard_rois = self._mesh_plan(images.shape[0], rois.shape[0])
        if shard_rois:
            per = rois.shape[0] // world
            rois = rois[rank * per:(rank + 1) * per]
        if not hasattr(self.model, "stage1_raw"):
            return (*self.model(images, rois), rois)
        if shard_images:
            per = images.shape[0] // world
            form, x1 = self.model.stage1_raw(images[rank * per:(rank + 1) * per])
            with tracing.span("model.stage1"):
                x1 = all_gather(x1, self.mesh)
        else:
            form, x1 = self.model.stage1_raw(images)
        return (*self.model.from_stage1(images, form, x1, rois), rois)

    def forward(self, images: torch.Tensor, rois: torch.Tensor):
        """Device tensors in, device tensors out: images (B, H, W, 3) in
        [0, 1], rois (bucket, 5) float32 already padded ->
        (instance_masks, binary_masks, logits), the whole request's on every
        rank of a mesh."""
        with tracing.span("engine.forward"):
            with tracing.span("engine.switches"):
                set_head_fusion(self.model, self.fused_head, self.kernels)
                set_int8_serving(self.model, self.quantize == "int8", self.scales,
                                 self.int8_deny, self.kernels)
                self._stage1_kernels()
            with torch.inference_mode():
                logits, aux, mine = self._model_forward(images.to(self.dtype),
                                                        rois.to(torch.float32))
                with tracing.span("engine.outputs"):
                    inst, binary = deployed_outputs(logits, aux, mine, self.dilation_pixels)
                if mine.shape[0] != rois.shape[0]:  # the ROI bucket is sharded
                    from .parallel.mesh import all_gather

                    inst, logits = all_gather(inst, self.mesh), all_gather(logits, self.mesh)
        return inst, binary, logits

    def __call__(self, images: np.ndarray, rois: np.ndarray):
        """images (B, H, W, 3) in [0, 1]; rois (N, 5) normalised boxes ->
        numpy (instance_masks (N, mh, mw, 1), binary_masks (B, H, W, 1), or
        None for a model without a full-image stage 1).

        With tracing on (:mod:`.tracing`), the request is an ``engine.call``
        span whose counters hold its ``images``, ``rois``, ``rois_computed``
        (the bucket), ``h2d_bytes`` and ``d2h_bytes``."""
        with tracing.span("engine.call"):
            n = rois.shape[0]
            if self.quantize == "int8" and self.scales is None:
                self.calibrate(images, rois)
            with tracing.span("engine.pad"):
                bucket = roi_bucket(max(n, 1), max_bucket=self.max_bucket)
                rois_p = pad_rois(np.asarray(rois, np.float32), bucket)
                images_np = np.asarray(images, np.float32)
            with tracing.span("engine.upload"):
                images_t = torch.as_tensor(images_np).to(self.device, self.dtype)
                rois_t = torch.as_tensor(rois_p).to(self.device)
            tracing.count("images", images_t.shape[0])
            tracing.count("rois", n)
            tracing.count("rois_computed", bucket)
            tracing.count("h2d_bytes", images_t.nbytes + rois_t.nbytes)
            inst, binary, _ = self.forward(images_t, rois_t)
            with tracing.span("engine.download"):
                inst = inst[:n].float()
                binary = None if binary is None else binary.float()
                tracing.count("d2h_bytes", inst.nbytes + (0 if binary is None else binary.nbytes))
                return inst.cpu().numpy(), None if binary is None else binary.cpu().numpy()

    def warmup(self, batch: int = 1, buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)) -> None:
        """One zero batch through :meth:`forward` for each ROI bucket, on the
        engine's device and in its dtype (the JAX engine's ``warmup``, which
        compiles one program per bucket): here it builds the CUDA kernels and
        their cached operands and warms cuDNN and the allocator. An int8
        engine serves it with whatever scales it has (dynamic ones before
        calibration); it neither calibrates nor records scales."""
        ih, iw = self.model.image_size
        images = torch.zeros((batch, ih, iw, 3), dtype=self.dtype, device=self.device)
        box = torch.tensor([[0.0, 0.25, 0.25, 0.75, 0.75]], device=self.device)
        for b in buckets:
            self.forward(images, box.repeat(b, 1))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict_nchw(self, images: np.ndarray, rois: np.ndarray):
        """Reference-compatible entry point: images (B, 3, H, W) in [0, 1],
        rois (N, 5) -> instance_masks (N, 1, mh, mw), binary_masks
        (B, 1, H, W)."""
        inst, binary = self(np.transpose(np.asarray(images), (0, 2, 3, 1)), rois)
        return (np.transpose(inst, (0, 3, 1, 2)),
                None if binary is None else np.transpose(binary, (0, 3, 1, 2)))


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded initialisation from one ``torch.Generator``: convolution
    kernels LeCun-normal (std 1/sqrt(fan_in), as the JAX package's
    ``lecun_normal``; a conv marked with ``init_scale``, the boundary
    refiner's, ``variance_scaling(init_scale, "fan_avg", "uniform")``), conv
    biases 0 (or the conv's ``init_bias``), norm scales 1 and shifts 0,
    running statistics 0/1, the stage-1 wrapper at [+1, -1], the distance
    threshold at 0.3, the boundary blend at 0.01. Parameters are drawn in
    ``named_modules`` order. Dense kernels (``nn.Linear``, V4's attention)
    are LeCun-normal too, as flax's ``DenseGeneral`` draws them; the fusion
    models' ``fusion_weights`` stay at their ones."""
    gen = torch.Generator().manual_seed(seed)
    fixed = {id(m.output_conv) for m in model.modules() if isinstance(m, PeopleSegUNetWrapper)}
    with torch.no_grad():
        for m in model.modules():
            if id(m) in fixed:
                continue
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
            else:
                continue
            scale = getattr(m, "init_scale", None)
            if scale is None:
                w = torch.randn(m.weight.shape, generator=gen) / float(np.sqrt(fan_in))
            else:  # variance_scaling(scale, "fan_avg", "uniform")
                fan_avg = (fan_in + m.weight.shape[0] * m.weight[0, 0].numel()) / 2.0
                limit = float(np.sqrt(3.0 * scale / fan_avg))
                w = (torch.rand(m.weight.shape, generator=gen) * 2.0 - 1.0) * limit
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.copy_(torch.tensor(getattr(m, "init_bias", 0.0)))


def create_flagship(
    variant: str = "b0",
    roi_size: Tuple[int, int] = (64, 48),
    mask_size: Tuple[int, int] = (128, 96),
    image_size: Tuple[int, int] = (480, 640),
    seed: int = 0,
    device: DeviceLike = "cuda",
    **kwargs,
) -> HierarchicalInstanceSegmenter:
    """Build the flagship (B0 by default) with seeded random weights, in
    eval mode on ``device``: the GPU unless the caller asks for the CPU
    (no CUDA raises). ``kwargs`` go to the model (``mid_channels``,
    ``pallas_tail``, ``encoder_fused_blocks``, ...)."""
    dev = resolve_device(device)
    model = HierarchicalInstanceSegmenter(
        encoder_variant=variant, roi_size=roi_size, mask_size=mask_size,
        image_size=image_size, **kwargs)
    init_weights(model, seed)
    return model.to(dev).eval()
