"""Load reference PyTorch checkpoints (smp.Unet + timm-efficientnet, and the
deployed two-stage assembly) into the port.

Counterpart of the JAX package's ``convert_weights.py``, torch to torch:
each function maps a reference-layout ``state_dict`` (timm/smp names for
stage 1, the reference's own module names for the wrapper and stage 2) to a
``state_dict`` of the port's module of the same architecture, whose module
names follow the JAX package's parameter tree. The leaves stay as they are,
with two exceptions:

- the reference's ``LayerNorm2d`` keeps weight and bias as ``(1, C, 1, 1)``;
  the port's are ``(C,)``;
- BatchNorm's ``num_batches_tracked`` has no counterpart (eval statistics
  only) and is read and dropped.

Conv kernels are OIHW on both sides, and a ``ConvTranspose2d`` weight
``(in, out, kh, kw)`` is taken as it is: the JAX converter flips its
spatial taps for ``lax.conv_transpose``, and ``weights.from_jax_params``
flips them back, so no flip happens here.

Strict, like ``weights.from_jax_params``: a reference key that no port
parameter takes raises, and with ``model`` given, so does a port parameter
that no reference key fills or a shape that differs; keys are never
dropped or guessed (where the JAX converter ignores a guided head's
attention keys without ``use_attention_module``, this one raises).

timm block naming:
  DepthwiseSeparableConv (stage 0): conv_dw,bn1, se, conv_pw,bn2
  InvertedResidual (stages 1-6):    conv_pw,bn1, conv_dw,bn2, se, conv_pwl,bn3
smp decoder: decoder.blocks.{i}.conv{1,2} = Sequential(conv .0, bn .1)
head: segmentation_head.0

Serve converted stage-1 weights with ``upsample_mode="nearest"``
(``stage1_upsample_mode="nearest"`` on the flagship): smp's UnetDecoder
upsamples with ``F.interpolate(scale_factor=2, mode="nearest")``. The fused
tail (``pallas_tail=True``) is gated to the bilinear stencil, so on such a
model the last stage runs unfused.

    python -m human_instance_segmentation_tpu_torch.convert_weights \\
        --checkpoint best.pth --out stage1.pt [--variant b0]
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .models.efficientnet import _B0_STAGES, VARIANTS, round_repeats

def strip_prefixes(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the reference's wrapper prefixes (model. / unet.)."""
    out = {}
    for k, v in state_dict.items():
        for p in ("model.", "unet."):
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def detect_variant_by_key_count(state_dict: Mapping[str, Any]) -> str:
    """Encoder size by key count (the reference's fallback,
    hierarchical_segmentation_unet.py:1806-1830: B0<400<B1<540<B3<700<B7)."""
    n = sum(1 for k in state_dict if k.startswith("encoder."))
    if n < 400:
        return "b0"
    if n < 540:
        return "b1"
    if n < 700:
        return "b3"
    return "b7"


class _Reader:
    """A reference state_dict read key by key under a prefix; every view of
    one state_dict shares the record of the keys taken."""

    def __init__(self, sd: Mapping[str, Any], prefix: str = "", taken: Optional[set] = None):
        self._sd, self._prefix = sd, prefix
        self.taken = set() if taken is None else taken

    def sub(self, prefix: str) -> "_Reader":
        return _Reader(self._sd, self._prefix + prefix, self.taken)

    def __contains__(self, key: str) -> bool:
        return self._prefix + key in self._sd

    def keys(self) -> List[str]:
        n = len(self._prefix)
        return [k[n:] for k in self._sd if k.startswith(self._prefix)]

    def take(self, key: str) -> torch.Tensor:
        full = self._prefix + key
        if full not in self._sd:
            raise KeyError(f"the reference state_dict has no {full!r}")
        self.taken.add(full)
        v = self._sd[full]
        return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))

    def untaken(self) -> List[str]:
        return sorted(set(self._sd) - self.taken)


def _reader(sd) -> _Reader:
    return sd if isinstance(sd, _Reader) else _Reader(sd)


def _under(prefix: str, d: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _bn(r: _Reader, prefix: str) -> Dict[str, torch.Tensor]:
    out = {n: r.take(f"{prefix}.{n}") for n in ("weight", "bias", "running_mean", "running_var")}
    if f"{prefix}.num_batches_tracked" in r:
        r.take(f"{prefix}.num_batches_tracked")  # no counterpart: eval statistics only
    return out


def _norm(r: _Reader, prefix: str) -> Dict[str, torch.Tensor]:
    """LayerNorm2d affine; the reference stores it as (1, C, 1, 1)
    (model.py:18-38), the port as (C,)."""
    return {n: r.take(f"{prefix}.{n}").reshape(-1) for n in ("weight", "bias")}


def _conv_p(r: _Reader, prefix: str) -> Dict[str, torch.Tensor]:
    p = {"weight": r.take(f"{prefix}.weight")}
    if f"{prefix}.bias" in r:
        p["bias"] = r.take(f"{prefix}.bias")
    return p


def _deconv_p(r: _Reader, prefix: str) -> Dict[str, torch.Tensor]:
    """ConvTranspose2d (in, out, kh, kw): the port's ``ConvTranspose2x``
    holds the same module as ``deconv``, so the taps stay as they are."""
    return _under("deconv", {n: r.take(f"{prefix}.{n}") for n in ("weight", "bias")})


def _res_block(r: _Reader, prefix: str) -> Dict[str, torch.Tensor]:
    """Reference ResidualBlock (conv1/norm1/conv2/norm2) ->
    models.blocks.ResidualBlock."""
    return {**_under("conv1", _conv_p(r, f"{prefix}.conv1")),
            **_under("norm1", _norm(r, f"{prefix}.norm1")),
            **_under("conv2", _conv_p(r, f"{prefix}.conv2")),
            **_under("norm2", _norm(r, f"{prefix}.norm2"))}


def _conv_norm_act(r: _Reader, conv_prefix: str, norm_prefix: str) -> Dict[str, torch.Tensor]:
    return {**_under("conv", _conv_p(r, conv_prefix)), **_under("norm", _norm(r, norm_prefix))}


def _merge(parts: Iterable[tuple]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, d in parts:
        out.update(_under(name, d))
    return out


def _finish(r: _Reader, state: Dict[str, torch.Tensor],
            model: Optional[nn.Module]) -> Dict[str, torch.Tensor]:
    """Raise on reference keys nothing took; with ``model``, on port
    parameters nothing filled and on shapes that differ."""
    left = r.untaken()
    if left:
        raise KeyError(f"reference keys no port parameter takes: {left}")
    if model is not None:
        expected = model.state_dict()
        unconsumed = sorted(set(state) - set(expected))
        unfilled = sorted(set(expected) - set(state))
        if unconsumed or unfilled:
            raise KeyError(f"converted keys with no port parameter: {unconsumed}; "
                           f"port parameters no reference key fills: {unfilled}")
        bad = [f"{k}: {tuple(state[k].shape)} vs {tuple(v.shape)}"
               for k, v in expected.items() if tuple(state[k].shape) != tuple(v.shape)]
        if bad:
            raise ValueError("shape mismatch: " + "; ".join(bad))
    return state


def _unet(r: _Reader, variant: Optional[str]) -> Dict[str, torch.Tensor]:
    """smp.Unet keys under ``r`` -> PeopleSegmentationUNet keys."""
    variant = variant or detect_variant_by_key_count(r.keys())
    _, depth, _ = VARIANTS[variant]
    out = {"encoder.stem_conv.weight": r.take("encoder.conv_stem.weight"),
           **_under("encoder.stem_bn", _bn(r, "encoder.bn1"))}
    for stage_i, (e, _, _, _, reps) in enumerate(_B0_STAGES):
        for j in range(round_repeats(reps, depth)):
            t = f"encoder.blocks.{stage_i}.{j}"
            if e == 1:  # DepthwiseSeparableConv: conv_dw,bn1 / se / conv_pw,bn2
                parts = [("dw_conv", {"weight": r.take(f"{t}.conv_dw.weight")}),
                         ("bn1", _bn(r, f"{t}.bn1")),
                         ("project_conv", {"weight": r.take(f"{t}.conv_pw.weight")}),
                         ("bn2", _bn(r, f"{t}.bn2"))]
            else:  # InvertedResidual: conv_pw,bn1 / conv_dw,bn2 / se / conv_pwl,bn3
                parts = [("expand_conv", {"weight": r.take(f"{t}.conv_pw.weight")}),
                         ("bn0", _bn(r, f"{t}.bn1")),
                         ("dw_conv", {"weight": r.take(f"{t}.conv_dw.weight")}),
                         ("bn1", _bn(r, f"{t}.bn2")),
                         ("project_conv", {"weight": r.take(f"{t}.conv_pwl.weight")}),
                         ("bn2", _bn(r, f"{t}.bn3"))]
            if f"{t}.se.conv_reduce.weight" in r:
                parts += [("se.reduce", _conv_p(r, f"{t}.se.conv_reduce")),
                          ("se.expand", _conv_p(r, f"{t}.se.conv_expand"))]
            out.update(_under(f"encoder.stage{stage_i}_block{j}", _merge(parts)))
    # smp UnetDecoder: blocks.{i}.conv{1,2} (Conv2dReLU = conv .0 + bn .1)
    i = 0
    while f"decoder.blocks.{i}.conv1.0.weight" in r:
        for ci in (1, 2):
            d = f"decoder.blocks.{i}.conv{ci}"
            out[f"decoder{i}.conv{ci - 1}.weight"] = r.take(f"{d}.0.weight")
            out.update(_under(f"decoder{i}.bn{ci - 1}", _bn(r, f"{d}.1")))
        i += 1
    out.update(_under("seg_head", _conv_p(r, "segmentation_head.0")))
    return out


def convert_people_seg_unet(state_dict: Mapping[str, Any], variant: Optional[str] = None,
                            model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """smp.Unet state_dict -> state_dict of
    ``PeopleSegmentationUNet(encoder_variant=variant)`` (the variant from the
    key count when not given). Serve it with ``upsample_mode="nearest"``."""
    r = _Reader(strip_prefixes(state_dict))
    return _finish(r, _unet(r, variant), model)


def convert_wrapper_output_conv(state_dict: Mapping[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """The 1ch -> 2ch output conv of the reference wrapper (output_conv,
    hierarchical_segmentation_unet.py:1961-1971) -> ``PeopleSegUNetWrapper``
    keys, or None when the state_dict has none."""
    key = next((k for k in state_dict if k.endswith("output_conv.weight")), None)
    if key is None:
        return None
    r = _Reader(state_dict)
    return _under("output_conv", _conv_p(r, key[:-len(".weight")]))


def convert_enhanced_unet(sd, prefix: str, depth: int = 3) -> Dict[str, torch.Tensor]:
    """EnhancedUNet (hierarchical_segmentation_unet.py:277-417) ->
    models.heads.EnhancedUNet keys."""
    r = _reader(sd)
    p = [("enc0_in", _conv_norm_act(r, f"{prefix}.encoders.0.0", f"{prefix}.encoders.0.1")),
         ("enc0_res0", _res_block(r, f"{prefix}.encoders.0.3")),
         ("enc0_res1", _res_block(r, f"{prefix}.encoders.0.4"))]
    for i in range(1, depth):  # encoders.i = Sequential(res, res, conv, norm, act)
        e = f"{prefix}.encoders.{i}"
        p += [(f"enc{i}_res0", _res_block(r, f"{e}.0")), (f"enc{i}_res1", _res_block(r, f"{e}.1")),
              (f"enc{i}_out", _conv_norm_act(r, f"{e}.2", f"{e}.3"))]
    # bottleneck = Sequential(res, res, conv, norm, act, conv1x1, sigmoid)
    b = f"{prefix}.bottleneck"
    p += [("bott_res0", _res_block(r, f"{b}.0")), ("bott_res1", _res_block(r, f"{b}.1")),
          ("bott_cna", _conv_norm_act(r, f"{b}.2", f"{b}.3")), ("bott_att", _conv_p(r, f"{b}.5")),
          ("bott_conv", _conv_p(r, f"{prefix}.bottleneck_conv"))]
    for d in range(depth - 1):  # decoders.d = Sequential(conv, norm, act, res, res)
        dd = f"{prefix}.decoders.{d}"
        p += [(f"up{d}", _deconv_p(r, f"{prefix}.upconvs.{d}")),
              (f"dec{d}_in", _conv_norm_act(r, f"{dd}.0", f"{dd}.1")),
              (f"dec{d}_res0", _res_block(r, f"{dd}.3")),
              (f"dec{d}_res1", _res_block(r, f"{dd}.4"))]
    # final = Sequential(conv, norm, act, conv1x1)
    p += [("final_cna", _conv_norm_act(r, f"{prefix}.final.0", f"{prefix}.final.1")),
          ("final_out", _conv_p(r, f"{prefix}.final.3"))]
    return _merge(p)


def convert_hierarchical_head_v2(sd, prefix: str, depth: int = 3,
                                 use_attention_module: bool = False) -> Dict[str, torch.Tensor]:
    """HierarchicalSegmentationHeadUNetV2 / ExtendedHierarchical... ->
    models.heads.HierarchicalHeadV2 keys (hierarchical_segmentation_unet.py:714-845,
    hierarchical_segmentation_refinement.py:434-560), the attention module's
    form of the target/non-target branch with ``use_attention_module``."""
    r = _reader(sd)
    t = f"{prefix}.target_vs_nontarget_branch"
    # shared_features = Sequential(conv, norm, act, drop, res, drop, res)
    s = f"{prefix}.shared_features"
    p = [("shared_in", _conv_norm_act(r, f"{s}.0", f"{s}.1")),
         ("shared_res0", _res_block(r, f"{s}.4")), ("shared_res1", _res_block(r, f"{s}.6")),
         ("bg_vs_fg_unet", convert_enhanced_unet(r, f"{prefix}.bg_vs_fg_unet", depth=depth)),
         # upsample_bg_fg = Sequential(deconv, norm, act, conv1x1)
         ("upsample_deconv", _deconv_p(r, f"{prefix}.upsample_bg_fg.0")),
         ("upsample_norm", _norm(r, f"{prefix}.upsample_bg_fg.1")),
         ("upsample_out", _conv_p(r, f"{prefix}.upsample_bg_fg.3")),
         # fg_gate = Sequential(conv, act, drop, conv, act, conv, sigmoid)
         ("gate0", _conv_p(r, f"{prefix}.fg_gate.0")), ("gate1", _conv_p(r, f"{prefix}.fg_gate.3")),
         ("gate2", _conv_p(r, f"{prefix}.fg_gate.5"))]
    if use_attention_module:
        # ModuleList(res, satt, drop, deconv, norm, act, catt, drop, res, conv)
        p += [("tnt_res0", _res_block(r, f"{t}.0")),
              ("tnt_satt", _under("conv", _conv_p(r, f"{t}.1.conv"))),
              ("tnt_deconv", _deconv_p(r, f"{t}.3")), ("tnt_norm", _norm(r, f"{t}.4")),
              ("tnt_catt", {**_under("fc1", _conv_p(r, f"{t}.6.fc1")),
                            **_under("fc2", _conv_p(r, f"{t}.6.fc2"))}),
              ("tnt_res1", _res_block(r, f"{t}.8")), ("tnt_out", _conv_p(r, f"{t}.9"))]
    else:
        # Sequential(res, drop, deconv, norm, act, drop, res, conv1x1)
        p += [("tnt_res0", _res_block(r, f"{t}.0")), ("tnt_deconv", _deconv_p(r, f"{t}.2")),
              ("tnt_norm", _norm(r, f"{t}.3")), ("tnt_res1", _res_block(r, f"{t}.6")),
              ("tnt_out", _conv_p(r, f"{t}.7"))]
    return _merge(p)


def convert_refined_head(sd, prefix: str, depth: int = 3,
                         use_attention_module: bool = False) -> Dict[str, torch.Tensor]:
    """RefinedHierarchicalSegmentationHead
    (hierarchical_segmentation_refinement.py:609-804) ->
    models.heads.RefinedHierarchicalHead keys, with whichever of the contour
    branch, the distance branch and the boundary refiner the state_dict
    has."""
    r = _reader(sd)
    p = [("base_head", convert_hierarchical_head_v2(
        r, f"{prefix}.base_head", depth=depth, use_attention_module=use_attention_module))]
    c = f"{prefix}.contour_branch.contour_branch"
    if f"{c}.0.weight" in r:
        p.append(("contour", _merge([("c0", _conv_norm_act(r, f"{c}.0", f"{c}.1")),
                                     ("c1", _conv_norm_act(r, f"{c}.3", f"{c}.4")),
                                     ("out", _conv_p(r, f"{c}.6"))])))
    d = f"{prefix}.distance_decoder.distance_head"
    if f"{d}.0.weight" in r:
        dist = _merge([("d0", _conv_norm_act(r, f"{d}.0", f"{d}.1")),
                       ("d_res", _res_block(r, f"{d}.3")), ("out", _conv_p(r, f"{d}.4"))])
        dist["threshold"] = r.take(f"{prefix}.distance_decoder.threshold")
        p.append(("distance", dist))
    b = f"{prefix}.boundary_refiner"
    if f"{b}.edge_conv.0.weight" in r:
        # edge_conv = Sequential(conv, norm, act, conv, norm, act, conv1x1)
        edge = _merge([("edge0", _conv_p(r, f"{b}.edge_conv.0")),
                       ("edge_norm0", _norm(r, f"{b}.edge_conv.1")),
                       ("edge1", _conv_p(r, f"{b}.edge_conv.3")),
                       ("edge_norm1", _norm(r, f"{b}.edge_conv.4")),
                       ("edge_out", _conv_p(r, f"{b}.edge_conv.6"))])
        edge["blend_weight"] = r.take(f"{b}.blend_weight")
        p.append(("boundary", edge))
    return _merge(p)


def convert_guided_head(sd, prefix: str,
                        use_attention_module: bool = False) -> Dict[str, torch.Tensor]:
    """PretrainedUNetGuidedSegmentationHead
    (hierarchical_segmentation_rgb.py:43-218) ->
    models.heads.PretrainedUNetGuidedHead keys; its attention module with
    ``use_attention_module``."""
    r = _reader(sd)
    fp, cls = f"{prefix}.feature_processor", f"{prefix}.final_classifier"
    p = [("input_adjust", _conv_p(r, f"{prefix}.input_adjust")),
         # feature_processor = Sequential(conv, norm, act, drop, res, drop, res)
         ("fp_in", _conv_norm_act(r, f"{fp}.0", f"{fp}.1")),
         ("fp_res0", _res_block(r, f"{fp}.4")), ("fp_res1", _res_block(r, f"{fp}.6")),
         # final_classifier = Sequential(conv, norm, act, conv1x1)
         ("cls0", _conv_norm_act(r, f"{cls}.0", f"{cls}.1")),
         ("cls_out", _conv_p(r, f"{cls}.3"))]
    if use_attention_module and f"{prefix}.attention_module.0.weight" in r:
        # attention_module = Sequential(conv1x1, act, conv1x1, sigmoid)
        p += [("att0", _conv_p(r, f"{prefix}.attention_module.0")),
              ("att1", _conv_p(r, f"{prefix}.attention_module.2"))]
    return _merge(p)


def convert_rgb_extractor(sd, prefix: str) -> Dict[str, torch.Tensor]:
    """The flagship's inline RGB patch extractor
    (hierarchical_segmentation_rgb.py:657-679, a Sequential of
    conv/norm/act/res x3 + 1x1 proj) -> models.assembly.RGBPatchFeatureExtractor
    keys. Sequential indices: 0 conv, 1 norm, (2 act), 3 res; 4-7; 8-11;
    12 conv, 13 norm, (14 act)."""
    r = _reader(sd)
    p = []
    for i, (ci, ri) in enumerate(((0, 3), (4, 7), (8, 11))):
        p += [(f"conv{i}", _conv_norm_act(r, f"{prefix}.{ci}", f"{prefix}.{ci + 1}")),
              (f"res{i}", _res_block(r, f"{prefix}.{ri}"))]
    p.append(("proj", _conv_norm_act(r, f"{prefix}.12", f"{prefix}.13")))
    return _merge(p)


def convert_flagship_checkpoint(state_dict: Mapping[str, Any], variant: Optional[str] = None,
                                depth: int = 3, use_attention_module: bool = False,
                                model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Full deployed-assembly checkpoint
    (HierarchicalRGBSegmentationModelWithFullImagePretrainedUNet,
    hierarchical_segmentation_rgb.py:564-774) -> state_dict of
    ``models.assembly.HierarchicalInstanceSegmenter``.

    Layout: pretrained_unet.model.model.<smp keys> (wrapper at
    hierarchical_segmentation_unet.py:1919-1993; pretrained_unet.model.<smp
    keys> is taken too), pretrained_unet.output_conv,
    rgb_feature_extractor.<seq>, feature_combiner and segmentation_head.<refined
    head>, or, without a feature_combiner, segmentation_head.<guided head>."""
    r = _Reader(state_dict)
    unet = r.sub("pretrained_unet.model.model.")
    if not unet.keys():  # already stripped single-wrap checkpoints
        unet = r.sub("pretrained_unet.model.")
    parts = [("pretrained_unet", _unet(unet, variant)),
             ("unet_wrapper.output_conv", _conv_p(r, "pretrained_unet.output_conv")),
             ("rgb_extractor", convert_rgb_extractor(r, "rgb_feature_extractor"))]
    if "feature_combiner.weight" in r:
        parts += [("feature_combiner", _conv_p(r, "feature_combiner")),
                  ("head", convert_refined_head(r, "segmentation_head", depth=depth,
                                                use_attention_module=use_attention_module))]
    else:
        parts.append(("head", convert_guided_head(r, "segmentation_head",
                                                  use_attention_module=use_attention_module)))
    state = _merge(parts)
    return _finish(r, state, model)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pth file on the CPU (``{'model_state_dict': ...}``,
    ``{'state_dict': ...}`` or a raw state_dict, like the reference's
    loader). It unpickles the file: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach() if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
            for k, v in ckpt.items()}


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    import json
    from pathlib import Path

    p = argparse.ArgumentParser(description="Convert a reference stage-1 checkpoint "
                                            "(smp.Unet + timm-efficientnet) to the port's "
                                            "PeopleSegmentationUNet state_dict.")
    p.add_argument("--checkpoint", required=True, help=".pth file")
    p.add_argument("--out", required=True, help="output state_dict (torch.save)")
    p.add_argument("--variant", default=None)
    args = p.parse_args(argv)
    from .models.unet import PeopleSegmentationUNet

    sd = load_torch_checkpoint(args.checkpoint)
    variant = args.variant or detect_variant_by_key_count(strip_prefixes(sd))
    # the model the file is for, so a parameter no key fills fails here, not at load
    model = PeopleSegmentationUNet(encoder_variant=variant, upsample_mode="nearest")
    state = convert_people_seg_unet(sd, variant, model=model)
    torch.save(state, args.out)
    # metadata sidecar mirroring the reference exporter's JSON sidecar
    # (export_hierarchical_instance_peopleseg_onnx.py:510-542); records the
    # decoder stencil converted checkpoints require
    Path(str(args.out) + ".json").write_text(json.dumps({
        "source": str(args.checkpoint),
        "variant": variant,
        "upsample_mode": "nearest",
        "note": "serve with PeopleSegmentationUNet(upsample_mode='nearest') "
                "/ stage1_upsample_mode='nearest' (smp decoder parity)",
    }, indent=2))
    n = sum(v.numel() for v in sd.values())
    print(f"converted {len(sd)} tensors ({n / 1e6:.1f}M params) -> {args.out}")


if __name__ == "__main__":
    main()
