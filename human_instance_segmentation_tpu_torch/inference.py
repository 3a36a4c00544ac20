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

import contextlib
import copy
import logging
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from . import tracing
from .models.assembly import HierarchicalInstanceSegmenter
from .models.blocks import set_head_fusion
from .models.efficientnet import MBConv
from .models.postprocess import mask_dilation_logit_boost
from .models.unet import PeopleSegmentationUNet, PeopleSegUNetWrapper
from .ops._build import plain
from .ops.quant import QConv, calibration, collect_scales, merge_scales, set_int8_serving

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


def _operand_builds() -> Tuple[int, int, int]:
    """The always-on counters of the operands the served model keeps: the
    QConvs' packed weights and operands, the fused MBConv blocks' folds and
    the fused tail's packs."""
    return QConv.operand_builds, MBConv.fold_builds, PeopleSegmentationUNet.tail_builds


def _copied(out):
    """``out`` (tensors in tuples, lists and dicts) with every tensor cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _copied(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_copied(v) for v in out)
    return out


def _python_hooks(model: nn.Module) -> list:
    """Where Python would run inside ``model``'s forward beside its ops,
    which a replayed graph skips: global module hooks, forward pre-hooks,
    and the forward hooks of its submodules (the model's own forward hooks
    are called after each replay)."""
    from torch.nn.modules import module as modules

    found = modules._global_forward_hooks or modules._global_forward_pre_hooks
    return ["global"] * bool(found) + [name or "model" for name, m in model.named_modules()
                    if m._forward_pre_hooks or (m is not model and m._forward_hooks)]


class _Graph:
    """One request shape's CUDA graph: the static inputs a call copies its
    request into, the captured forward's outputs that a replay writes, and
    the model's own arguments and output, for its forward hooks."""

    __slots__ = ("key", "images", "rois", "graph", "out", "model_args", "model_out")

    def __init__(self, key: tuple, images: torch.Tensor, rois: torch.Tensor):
        self.key, self.images, self.rois = key, images, rois
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: tuple = ()
        self.model_args: tuple = ()
        self.model_out = None


class InferenceEngine:
    """Bucketed inference on one device for the flagship model, and for the
    models without a full-image stage 1 (no binary masks then): the
    pure-RGB, ROI-pretrained and multi-scale RGB hierarchical models, the
    variable-ROI and the baseline models.

    The engine serves its own copy of ``model`` (``engine.model``), cast to
    ``dtype`` (float32 or bfloat16; LayerNorm2d statistics stay float32) on
    ``device`` and in eval mode: the caller's model keeps its dtype, device,
    mode and serving switches, as the JAX engine leaves ``params`` alone.
    The copy's serving state is set when it changes: at construction, when
    :attr:`scales` is set, and around :meth:`calibrate`'s forward;
    :meth:`forward` sets nothing.
    ``fused_head=True`` routes the stage-2 conv + LayerNorm2d + ReLU units
    that pass the JAX package's gate through the fused CUDA kernel.

    ``quantize="int8"`` runs every eligible, not denied :class:`QConv` in
    s8 x s8 -> s32 (``int8_deny`` path substrings stay in ``dtype``; the
    default denies the stage-1 encoder) and the fused units in their int8
    form. Activation scales are calibrated from the first batch served, or
    by :meth:`calibrate`; until then :meth:`forward` uses dynamic scales.
    ``kernels=False`` runs :meth:`forward` and :meth:`calibrate` inside
    ``ops._build.plain()``: every hand kernel (the fused unit, the int8
    convs, the LayerNorm2d pair, the RoIAlign crops, the fused stage-1 tail
    and the fused encoder blocks) computes its plain PyTorch twin on any
    device (the LayerNorm2d pair's on the card with the kernels' own
    statistics), the plain path of the same graph that a GPU run holds the
    kernels against. ``pallas_tail`` with int8 ends stage 1 in the
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

    A request's images are cast into a staging tensor kept for each request
    shape (and the padded RoIs into one kept for each bucket) and sent
    without blocking; the outputs come back without blocking into new host
    tensors, which the returned arrays are views of. On a CUDA device both
    are page-locked, the outputs' from PyTorch's caching host allocator, and
    the call synchronises the stream before it returns. Each call's arrays
    are its own, and their block goes back to the allocator's cache when the
    caller drops them: a caller that keeps many outputs alive keeps as much
    page-locked memory.

    On a CUDA device, without a mesh and with tracing off, ``__call__``
    serves each request shape (the images' shape and layout and the RoI
    bucket) from a CUDA graph of ``engine.forward``, looked up on the
    instance as an eager call looks it up: the first call of a shape serves
    eagerly (it builds the kernels and the operands the model keeps), the
    second captures the graph, and later ones copy the request into the
    graph's static inputs and replay it. Every shape keeps its graph (the
    graphs share one memory pool) until :attr:`scales` is set (by
    :meth:`calibrate` too), which drops them all, since a graph holds the
    int8 scales, the operands and ``engine.forward`` as they were captured:
    after a change to ``engine.model``'s parameters or to
    ``engine.forward``, set ``engine.scales`` to its own value so that the
    next calls serve anew. A shape serves eagerly from then on, logged
    once, where its capture fails (an op a graph cannot hold) or where
    Python would run inside the model's forward at its capture (a global
    module hook, a forward pre-hook, a forward hook of a submodule), which
    a replay would skip. Under tracing (:mod:`.tracing`), whose spans and
    launch counters are host code around each op, and under a mesh, whose
    collectives stay eager, every call serves eagerly. After a replay the
    served model's own forward hooks are called as an eager forward calls
    them, once a call, on the graph's arguments of the model and a copy of
    its output (what they return is not used). The always-on counters
    ``graph_captures``, ``graph_replays`` and ``graph_fallbacks`` count
    captures, replays (calls served by an earlier capture) and shapes left
    eager at their capture.
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
        self._fused_head = fused_head
        self._quantize = quantize
        self._int8_deny = tuple(int8_deny)
        self.kernels = kernels
        self.mesh = mesh
        self._warned: set = set()
        self._staging: Dict[tuple, torch.Tensor] = {}
        self._graphs: Dict[tuple, Optional[_Graph]] = {}
        self._uncapturable: set = set()
        self._pool = None  # the memory pool the engine's graphs share
        self.graph_captures = self.graph_replays = self.graph_fallbacks = 0
        set_head_fusion(self.model, fused_head)
        self.scales = None

    @property
    def fused_head(self) -> bool:
        """Whether the fused stage-2 unit serves (set at construction)."""
        return self._fused_head

    @property
    def quantize(self) -> Optional[str]:
        """The quantize mode, None or ``"int8"`` (set at construction)."""
        return self._quantize

    @property
    def int8_deny(self) -> Tuple[str, ...]:
        """The path substrings that stay in ``dtype`` (set at construction)."""
        return self._int8_deny

    @property
    def scales(self) -> Optional[Dict[str, float]]:
        """The calibrated activation scales (None: dynamic ones). Setting
        them sets int8 serving on the served copy and drops the CUDA graphs
        (a shape left eager at its capture tries again)."""
        return self._scales

    @scales.setter
    def scales(self, scales: Optional[Dict[str, float]]) -> None:
        self._scales = scales
        set_int8_serving(self.model, self.quantize == "int8", scales, self.int8_deny)
        self._graphs.clear()
        self._uncapturable.clear()
        self._pool = None

    def _route(self):
        """The context of the engine's forwards: the hand kernels, or with
        ``kernels=False`` their plain twins."""
        return contextlib.nullcontext() if self.kernels else plain()

    def calibrate(self, images: np.ndarray, rois: np.ndarray) -> None:
        """Record every eligible QConv's input abs-max on (images, rois),
        served unfused and un-quantized in the engine's dtype (and, for a
        ``pallas_tail`` model, the s8 tail's three points), and fold the
        scales into int8 serving (pointwise max over calls). The head fusion
        and int8 serving come back on after it, with the merged scales or,
        where it raises, with the ones it found."""
        with tracing.span("engine.calibrate"):
            bucket = roi_bucket(max(rois.shape[0], 1), max_bucket=self.max_bucket)
            rois_p = torch.as_tensor(pad_rois(np.asarray(rois, np.float32), bucket)).to(
                self.device)
            images_t = torch.as_tensor(np.asarray(images, np.float32)).to(self.device, self.dtype)
            merged = self.scales
            set_head_fusion(self.model, False)
            set_int8_serving(self.model, False)
            try:
                with self._route(), torch.inference_mode(), calibration(self.model) as calib:
                    self._model_forward(images_t, rois_p)
                scales = collect_scales(calib)
                if self.mesh is not None:  # every rank serves the same graph
                    from .parallel.mesh import all_gather_object

                    for other in all_gather_object(scales, self.mesh):
                        scales = merge_scales(scales, other)
                merged = merge_scales(merged, scales) if merged else scales
            finally:
                set_head_fusion(self.model, self.fused_head)
                self.scales = merged

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
            with self._route(), torch.inference_mode():
                logits, aux, mine = self._model_forward(images.to(self.dtype),
                                                        rois.to(torch.float32))
                with tracing.span("engine.outputs"):
                    inst, binary = deployed_outputs(logits, aux, mine, self.dilation_pixels)
                if mine.shape[0] != rois.shape[0]:  # the ROI bucket is sharded
                    from .parallel.mesh import all_gather

                    inst, logits = all_gather(inst, self.mesh), all_gather(logits, self.mesh)
        return inst, binary, logits

    def _graphs_on(self) -> bool:
        """Whether this call may be served from a CUDA graph: on a CUDA
        device, without a mesh and with tracing off."""
        return self.device.type == "cuda" and self.mesh is None and not tracing.enabled()

    def _graph(self, images: torch.Tensor, rois: torch.Tensor) -> Optional[_Graph]:
        """The CUDA graph of the request in the staging tensors ``images``
        and ``rois``, None where the call serves eagerly: off a CUDA device,
        under a mesh, with tracing on, at a shape's first call and for a
        shape left eager at its capture. The graph that the second call
        gets has no capture yet (:meth:`_replay` makes it); its static
        inputs take the staging tensors' layout, as an eager upload does."""
        if not self._graphs_on():
            return None
        key = (tuple(images.shape), images.stride(), rois.shape[0])
        if key in self._uncapturable:
            return None
        if key not in self._graphs:
            self._graphs[key] = None
            return None
        g = self._graphs[key]
        if g is None:
            g = self._graphs[key] = _Graph(key, torch.empty_like(images, device=self.device),
                                           torch.empty_like(rois, device=self.device))
        return g

    def _capture(self, g: _Graph) -> bool:
        """Capture ``engine.forward`` (the instance's, as an eager call
        finds it) on ``g``'s static inputs into a CUDA graph in the engine's
        memory pool; False where the shape serves eagerly instead: Python
        would run inside the model's forward (:func:`_python_hooks`), or the
        capture failed (logged and counted either way). The shape's first
        call built every kernel and kept operand, so a capture builds none:
        one built now would hold the pool's memory and values the capture
        never computed, and raises. The model's forward hooks are held back
        meanwhile (:meth:`_replay` calls them); one of the capture's own
        keeps the model's arguments and output."""
        hooked = _python_hooks(self.model)
        if hooked:
            self._leave_eager(g, f"Python a replay would skip runs in the model's forward "
                                 f"(hooks: {', '.join(hooked)})")
            return False
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        builds = _operand_builds()
        stream = torch.cuda.current_stream(self.device)
        held = {}

        def keep(module, args, out):
            held["args"], held["out"] = args, out

        hooks, self.model._forward_hooks = self.model._forward_hooks, OrderedDict([(-1, keep)])
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self.forward(g.images, g.rois)
        except RuntimeError as err:
            self._abandon_capture(stream)
            self._leave_eager(g, f"its CUDA graph capture failed: {err}")
            return False
        finally:
            self.model._forward_hooks = hooks
        if _operand_builds() != builds:
            raise RuntimeError(
                f"InferenceEngine: the capture of request shape {g.key} built kept operands "
                f"(QConv, MBConv fold, tail pack: {builds} -> {_operand_builds()}); the "
                "shape's eager call should have built them")
        g.graph, g.out = graph, tuple(out)
        g.model_args, g.model_out = held.get("args", ()), held.get("out")
        self.graph_captures += 1
        return True

    def _leave_eager(self, g: _Graph, why: str) -> None:
        """Serve ``g``'s shape eagerly from now on (until the graphs are
        dropped), logged once and counted."""
        del self._graphs[g.key]
        self._uncapturable.add(g.key)
        self.graph_fallbacks += 1
        logging.getLogger(__name__).warning(
            "InferenceEngine: request shape %s serves eagerly; %s", g.key, why)

    def _abandon_capture(self, stream: torch.cuda.Stream) -> None:
        """Undo what a failed capture leaves behind: where ending it raises,
        ``torch.cuda.graph`` restores neither the caller's stream nor the
        allocator, which keeps recording into the pool (the next capture
        would then refuse it). The pool is left to the graphs already in it;
        later captures take a new one."""
        torch.cuda.set_stream(stream)
        try:
            torch._C._cuda_endAllocateToPool(stream.device_index, self._pool)
        except RuntimeError:  # the capture had ended its recording
            pass
        self._pool = None

    def _replay(self, g: _Graph) -> Optional[tuple]:
        """The captured forward's outputs for the request in ``g``'s static
        inputs, from its graph (captured first, where it has none), then
        the model's forward hooks, each on the graph's arguments of the
        model and a copy of its output; None where the shape serves
        eagerly."""
        if g.graph is not None:
            self.graph_replays += 1
        elif not self._capture(g):
            return None
        g.graph.replay()
        m = self.model
        if m._forward_hooks and g.model_out is not None:
            with torch.inference_mode():
                out = _copied(g.model_out)
                for key, hook in list(m._forward_hooks.items()):
                    if key in m._forward_hooks_with_kwargs:
                        hook(m, g.model_args, {}, out)
                    else:
                        hook(m, g.model_args, out)
        return g.out

    def _stage(self, array: np.ndarray, dtype: torch.dtype, pin: bool) -> torch.Tensor:
        """``array`` cast into the staging tensor of its shape and layout
        (built the first time they are seen; page-locked where ``pin``), to
        be sent to the device without blocking the host. The previous call
        synchronised before it returned, so no copy still reads the staging
        tensor when this one refills it."""
        src = torch.from_numpy(array)
        key = (tuple(src.shape), src.stride(), dtype)
        staging = self._staging.get(key)
        if staging is None:
            staging = self._staging[key] = torch.empty_like(src, dtype=dtype, pin_memory=pin)
        return staging.copy_(src)

    def _download(self, t: torch.Tensor, pin: bool) -> torch.Tensor:
        """``t`` copied without blocking into a new host tensor of its layout,
        page-locked where ``pin``; read it only after the stream is
        synchronised."""
        out = torch.empty_like(t, device="cpu", pin_memory=pin)
        return out.copy_(t, non_blocking=True)

    def __call__(self, images: np.ndarray, rois: np.ndarray):
        """images (B, H, W, 3) in [0, 1]; rois (N, 5) normalised boxes ->
        numpy (instance_masks (N, mh, mw, 1), binary_masks (B, H, W, 1), or
        None for a model without a full-image stage 1).

        With tracing on (:mod:`.tracing`), the request is an ``engine.call``
        span whose counters hold its ``images``, ``rois``, ``rois_computed``
        (the bucket), ``h2d_bytes``, ``d2h_bytes``, ``pinned_bytes`` (the
        bytes of both that crossed through page-locked memory) and
        ``staging_builds`` (staging tensors built for a shape not seen
        before)."""
        with tracing.span("engine.call"):
            n = rois.shape[0]
            pin = self.device.type == "cuda"
            if self.quantize == "int8" and self.scales is None:
                self.calibrate(images, rois)
            with tracing.span("engine.pad"):
                bucket = roi_bucket(max(n, 1), max_bucket=self.max_bucket)
                rois_p = pad_rois(np.asarray(rois, np.float32), bucket)
                images_np = np.asarray(images, np.float32)
            with tracing.span("engine.upload"):
                kept = len(self._staging)
                images_s = self._stage(images_np, self.dtype, pin)
                rois_s = self._stage(rois_p, torch.float32, pin)
                graph = self._graph(images_s, rois_s)
                if graph is None:
                    images_t = images_s.to(self.device, non_blocking=True)
                    rois_t = rois_s.to(self.device, non_blocking=True)
                else:
                    images_t = graph.images.copy_(images_s, non_blocking=True)
                    rois_t = graph.rois.copy_(rois_s, non_blocking=True)
            h2d = images_t.nbytes + rois_t.nbytes
            tracing.count("images", images_t.shape[0])
            tracing.count("rois", n)
            tracing.count("rois_computed", bucket)
            tracing.count("h2d_bytes", h2d)
            tracing.count("staging_builds", len(self._staging) - kept)
            out = None if graph is None else self._replay(graph)
            inst, binary, _ = self.forward(images_t, rois_t) if out is None else out
            with tracing.span("engine.download"):
                inst = inst[:n].float()
                binary = None if binary is None else binary.float()
                d2h = inst.nbytes + (0 if binary is None else binary.nbytes)
                tracing.count("d2h_bytes", d2h)
                tracing.count("pinned_bytes", h2d + d2h if pin else 0)
                inst = self._download(inst, pin)
                binary = None if binary is None else self._download(binary, pin)
                if pin:
                    torch.cuda.current_stream(self.device).synchronize()
                return inst.numpy(), None if binary is None else binary.numpy()

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
