"""Export: deployment artifacts of the port.

Counterpart of the JAX package's ``export.py``. An exported model is a
directory:

    params.pt          the folded model's ``state_dict`` (``torch.save``);
                       JAX writes ``params.msgpack``
    metadata.json      the io contract and config, with the JAX package's
                       keys, ``"framework": "human_instance_segmentation_tpu_torch"``
    model_n{N}.pt2     one ``torch.export`` program per ROI bucket N of the
                       deployed forward ``(images, rois) -> (instance_masks,
                       binary_masks)``, loadable and callable without the
                       model code; JAX writes ``model_n{N}.stablehlo``

The exported forward is the plain one: the model in float32, BatchNorm
folded, with ``pallas_roi_align``, ``pallas_tail``, the fused encoder
blocks, the fused head and int8 serving off, followed by
``inference.deployed_outputs`` (the JAX artifact is Pallas-free too). The
hand-written kernels are bound through ``ctypes`` and are opaque to
``torch.export``; a route that carries them would need them as
``torch.library`` custom ops (ROADMAP). A ``torch.export`` program is fixed
to the device it was traced on, so :func:`export_model` exports on the
device the model is on (export on the card for the card), and
:func:`load_exported` refuses a device other than that one.

BatchNorm folding (:func:`fold_batch_stats`) reads each BatchNorm's own
epsilon from the module (:func:`collect_bn_eps`; the encoder's 1e-3, the
decoder's 1e-5), never from its path. It folds the modules that normalise
with their running statistics in eval mode (``ops.norms.BatchNorm2d``),
and leaves ``AdaptiveInstanceNorm2d`` alone, whose forward reads only the
instance statistics; the JAX fold folds every ``batch_stats`` node, that
norm's too (ROADMAP C13).
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .inference import deployed_outputs, pad_rois, resolve_device
from .models.blocks import set_head_fusion
from .models.efficientnet import MBConv
from .models.unet import PeopleSegmentationUNet
from .ops.norms import BatchNorm2d
from .ops.quant import set_int8_serving

_BUCKET = re.compile(r"model_n(\d+)\.pt2$")


def detect_architecture_from_name(name: str) -> str:
    """b0/b1/b3/b7 from a checkpoint or config name (default b1)."""
    s = name.lower()
    for arch in ("b0", "b1", "b3", "b7"):
        if f"from_{arch}" in s or f"best_model_{arch}" in s or f"_{arch}_" in s:
            return arch
    return "b1"


def collect_bn_eps(model: nn.Module) -> Dict[str, float]:
    """Module path ('/'-joined) -> epsilon of every BatchNorm under
    ``model`` that normalises with running statistics, read from the module
    itself."""
    return {name.replace(".", "/"): float(m.eps) for name, m in model.named_modules()
            if isinstance(m, BatchNorm2d)}


@torch.no_grad()
def fold_batch_stats(model: nn.Module, eps_by_path: Optional[Dict[str, float]] = None,
                     default_eps: Optional[float] = None) -> nn.Module:
    """Fold every BatchNorm's running statistics into its scale and bias, in
    place: ``scale' = scale / sqrt(var + eps)``, ``bias' = bias - mean *
    scale'``, ``mean' = 0`` and ``var' = 1 - eps``, so that the eval forward's
    ``rsqrt(var' + eps)`` is exactly 1. The arithmetic is the JAX fold's:
    numpy float32 on the host, in its order (so the same on every device;
    PyTorch's CPU ``sqrt`` is not always correctly rounded). ``eps_by_path`` (from :func:`collect_bn_eps`) gives each module's
    epsilon, ``default_eps`` the one of a module it lacks; with neither the
    fold raises. Written with ``copy_``, so version counters move and every
    cache keyed on them (the fused blocks' folded weights, ``QConv.cached``,
    the kept tail packs) is rebuilt. Returns ``model``."""
    for name, m in model.named_modules():
        if not isinstance(m, BatchNorm2d):
            continue
        path = name.replace(".", "/")
        e = (eps_by_path or {}).get(path, default_eps)
        if e is None:
            raise ValueError(f"no epsilon known for BatchNorm at {path!r}: pass "
                             "eps_by_path=collect_bn_eps(model) or an explicit default_eps")
        mean, var, scale, bias = (t.detach().cpu().numpy() for t in (
            m.running_mean, m.running_var, m.weight, m.bias))
        inv = 1.0 / np.sqrt(var + e)
        new_scale, new_bias = scale * inv, bias - mean * scale * inv  # before any write
        m.weight.copy_(torch.from_numpy(new_scale))
        m.bias.copy_(torch.from_numpy(new_bias))
        m.running_mean.zero_()
        m.running_var.fill_(1.0 - e)
    return model


def plain_copy(model: nn.Module) -> nn.Module:
    """A float32 eval-mode copy of ``model`` on its device with every
    serving route switched to its plain form: no fused head, no int8
    serving, no kernel crop, no fused tail, no fused encoder blocks."""
    m = copy.deepcopy(model).float().eval()
    set_head_fusion(m, False)
    set_int8_serving(m, False)
    if hasattr(m, "pallas_roi_align"):
        m.pallas_roi_align = False
    for mod in m.modules():
        if isinstance(mod, PeopleSegmentationUNet):
            mod.pallas_tail = False
            mod.encoder.fused_blocks = 0
        elif isinstance(mod, MBConv):
            mod.fused = False
    return m


class DeployedForward(nn.Module):
    """``(images, rois) -> deployed_outputs(model(images, rois))``."""

    def __init__(self, model: nn.Module, dilation_pixels: int = 0):
        super().__init__()
        self.model = model
        self.dilation_pixels = dilation_pixels

    def forward(self, images: torch.Tensor, rois: torch.Tensor):
        logits, aux = self.model(images, rois)
        return deployed_outputs(logits, aux, rois, self.dilation_pixels)


def export_model(
    out_dir: str,
    model: nn.Module,
    image_size: Tuple[int, int],
    roi_size: Tuple[int, int],
    mask_size: Tuple[int, int],
    dilation_pixels: int = 0,
    roi_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16),
    batch_size: int = 1,
    config_name: str = "",
    fold_bn: bool = True,
    serialize_executable: bool = True,
) -> str:
    """Write the artifact directory for ``model`` (left as it is: the
    export works on :func:`plain_copy` of it, BatchNorm folded with
    ``fold_bn``), its programs traced on the model's device. Returns the
    directory."""
    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    m = plain_copy(model)
    if fold_bn:
        fold_batch_stats(m, collect_bn_eps(m))
    torch.save(m.state_dict(), d / "params.pt")

    meta = {
        "framework": "human_instance_segmentation_tpu_torch",
        "config_name": config_name,
        "image_size": list(image_size),
        "roi_size": list(roi_size),
        "mask_size": list(mask_size),
        "dilation_pixels": dilation_pixels,
        "roi_buckets": list(roi_buckets),
        "batch_size": batch_size,
        "inputs": {
            "images": f"({batch_size}, {image_size[0]}, {image_size[1]}, 3) float in [0,1] NHWC",
            "rois": "(N, 5) [batch_idx, x1, y1, x2, y2] normalised; pad with batch_idx=-1",
        },
        "outputs": {
            "instance_masks": f"(N, {mask_size[0]}, {mask_size[1]}, 1) {{0,1}}",
            "binary_masks": f"({batch_size}, {image_size[0]}, {image_size[1]}, 1) person prob",
        },
        "model_kwargs": {
            "encoder_variant": getattr(model, "encoder_variant", None),
        },
    }
    (d / "metadata.json").write_text(json.dumps(meta, indent=2))

    if serialize_executable:
        # one trace with the ROI count dynamic (1 to the largest bucket),
        # one file per bucket: each serves its bucket's padded count
        dev = next(m.parameters()).device
        images = torch.zeros((batch_size, image_size[0], image_size[1], 3), device=dev)
        rois = torch.tensor(pad_rois(np.asarray([[0.0, 0.2, 0.2, 0.8, 0.8]], np.float32), 2),
                            device=dev)
        n = torch.export.Dim("n_rois", min=1, max=max(max(roi_buckets), 2))
        program = torch.export.export(DeployedForward(m, dilation_pixels), (images, rois),
                                      dynamic_shapes=(None, {0: n}))
        first = d / f"model_n{roi_buckets[0]}.pt2"
        torch.export.save(program, first)
        for bucket in roi_buckets[1:]:  # the same program: a link, or a copy where none can be
            path = d / f"model_n{bucket}.pt2"
            path.unlink(missing_ok=True)
            try:
                os.link(first, path)
            except OSError:
                shutil.copyfile(first, path)
    return str(d)


def _program_device(program) -> torch.device:
    for t in list(program.state_dict.values()) + list(program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def load_exported(artifact_dir: str, device="cuda"):
    """Load an artifact on ``device`` (the GPU unless the caller asks for the
    CPU; it must be the device the programs were exported on): returns
    ``(call, metadata)``. ``call(images, rois)`` takes numpy (B, H, W, 3)
    images and (N, 5) rois, runs the smallest bucket that holds N ROIs (the
    rois padded with ``inference.pad_rois``) or, above the largest, that
    bucket's program on chunks of the ROIs (stage 1 recomputed per chunk),
    and returns numpy ``(instance_masks[:N], binary_masks)``. A bucket's
    program is loaded at its first use."""
    dev = resolve_device(device)
    d = Path(artifact_dir)
    meta = json.loads((d / "metadata.json").read_text())
    buckets = sorted(int(mt.group(1)) for p in d.glob("model_n*.pt2")
                     if (mt := _BUCKET.match(p.name)))
    fns = {}

    def run(images: torch.Tensor, rois: np.ndarray, bucket: int):
        if bucket not in fns:  # loaded at its first use
            program = torch.export.load(d / f"model_n{bucket}.pt2")
            traced_on = _program_device(program)
            if traced_on.type != dev.type:
                raise ValueError(f"{d}: model_n{bucket}.pt2 was exported on {traced_on}, not "
                                 f"{dev}; export on the device you serve on")
            fns[bucket] = program.module()
        with torch.no_grad():
            inst, binary = fns[bucket](images, torch.as_tensor(pad_rois(rois, bucket)).to(dev))
        return inst.cpu().numpy(), binary.cpu().numpy()

    def call(images: np.ndarray, rois: np.ndarray):
        if not buckets:
            raise ValueError("artifact has no serialised executables")
        n = rois.shape[0]
        rois = np.asarray(rois, np.float32)
        images_t = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
        bucket = next((b for b in buckets if b >= n), None)
        if bucket is not None:
            inst, binary = run(images_t, rois, bucket)
            return inst[:n], binary
        maxb = buckets[-1]
        inst_parts, binary = [], None
        for s in range(0, n, maxb):
            chunk = rois[s:s + maxb]
            inst, b_ = run(images_t, chunk, maxb)
            inst_parts.append(inst[:chunk.shape[0]])
            if binary is None:
                binary = b_
        return np.concatenate(inst_parts, axis=0), binary

    return call, meta


def export_from_config(config_name: str, out_dir: str,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       dilation_pixels: int = 0, device="cuda", **export_kw) -> str:
    """Config-name driven export: ``config.model_from_config`` on ``device``
    (seeded random weights, or ``state_dict``), then :func:`export_model`."""
    from .config import ConfigManager, _as_hw, model_from_config

    cfg = ConfigManager.get_config(config_name)
    model = model_from_config(cfg, seed=0, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return export_model(
        out_dir, model, image_size=_as_hw(cfg.model.image_size),
        roi_size=_as_hw(cfg.model.roi_size), mask_size=_as_hw(cfg.model.mask_size),
        dilation_pixels=dilation_pixels, config_name=config_name, **export_kw)


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of this package (ckpt_<step>.pt, or a directory: its newest)")
    p.add_argument("--dilation", type=int, default=0)
    p.add_argument("--no-executable", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    state_dict = None
    if args.checkpoint:
        from .training.checkpoint import load_model_state

        state_dict = load_model_state(args.checkpoint)
    path = export_from_config(args.config, args.out, state_dict, dilation_pixels=args.dilation,
                              device=args.device, serialize_executable=not args.no_executable)
    print(f"exported to {path}")


if __name__ == "__main__":
    main()
