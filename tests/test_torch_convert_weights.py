"""The port's ``convert_weights``: reference-layout checkpoints into the port,
and the port's stage 1 held against the timm/smp oracle (CPU, float32).

The oracle is a copy of the vendored timm/smp recipes of the JAX package's
tests (Conv2dSame stem, DepthwiseSeparableConv, InvertedResidual with SE,
smp's nearest-upsample decoder block, the 3x3 segmentation head), composed,
from timm's published efficientnet_b0 arch_def, into the complete B0
encoder + smp UnetDecoder that the reference freezes as
stage 1 and exported under smp.Unet's key layout. It needs no reference
tree. Its random weights, pushed through the port's
``convert_people_seg_unet`` exactly as a real checkpoint would be, must
reproduce its forward in the port: every padding convention, BN epsilon,
SE gate, residual rule, upsample stencil, tap order and converter key in one
graph, on the plain path and through the port's serving flags.

Stage 2 has no torch oracle here, so the flagship converter is held against
the JAX package's: a reference-layout state_dict made by inverting the JAX
converters on the JAX flagship's variables must map back to them through
the JAX converter, and the port's converter must give exactly what
``weights.from_jax_params`` gives for them.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu import convert_weights as jcw
from human_instance_segmentation_tpu.models.assembly import (
    HierarchicalInstanceSegmenter as JaxSegmenter)
from human_instance_segmentation_tpu.models.unet import PeopleSegmentationUNet as JaxUNet
from human_instance_segmentation_tpu_torch import convert_weights as cw
from human_instance_segmentation_tpu_torch.inference import create_flagship
from human_instance_segmentation_tpu_torch.models.efficientnet import (_B0_STAGES, VARIANTS,
                                                                       round_repeats)
from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet
from human_instance_segmentation_tpu_torch.ops import cuda_tail
from human_instance_segmentation_tpu_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parents[1]
TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32,
            base_channels=64)
ROIS = np.asarray([[0.0, 0.1, 0.2, 0.7, 0.9],
                   [1.0, 0.0, 0.0, 1.0, 1.0],
                   [0.0, 0.4, 0.3, 0.6, 0.8]], np.float32)
# The oracle's bound, 2000x tighter than the JAX package's test (atol 2e-3,
# rtol 1e-3): both sides here are float32 PyTorch on the same CPU, and the
# plain path runs the oracle's own ops, so they differ only where the fused
# MBConv's plain version folds BN into its convs. Measured max abs error: 0
# on the plain path and the pallas_tail form, 1.1e-8 and 1.5e-8 through
# encoder_fused_blocks=3 and 6, on logits of 0.05-0.07 (random weights). The
# encoder's BN eps set to 1e-5 instead of 1e-3 fails it.
ORACLE_ATOL, ORACLE_RTOL = 1e-6, 1e-5
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
# timm's published efficientnet_b0 arch_def (``_gen_efficientnet``), one
# string a stage: block type, repeats, kernel, stride, expansion, out channels,
# SE ratio. The oracle is built from this, not from the port's table.
_TIMM_B0_ARCH_DEF = (
    "ds_r1_k3_s1_e1_c16_se0.25",
    "ir_r2_k3_s2_e6_c24_se0.25",
    "ir_r2_k5_s2_e6_c40_se0.25",
    "ir_r3_k3_s2_e6_c80_se0.25",
    "ir_r3_k5_s1_e6_c112_se0.25",
    "ir_r4_k5_s2_e6_c192_se0.25",
    "ir_r1_k3_s1_e6_c320_se0.25",
)


def _timm_stages():
    """The arch_def as (block type, expansion, kernel, stride, out channels,
    repeats) a stage."""
    stages = []
    for stage in _TIMM_B0_ARCH_DEF:
        kind, r, k, s, e, c = re.fullmatch(
            r"(ds|ir)_r(\d+)_k(\d+)_s(\d+)_e(\d+)_c(\d+)_se0\.25", stage).groups()
        stages.append((kind, int(e), int(k), int(s), int(c), int(r)))
    return stages


def nchw(x):
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def nhwc(x):
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


# ---- the timm/smp oracle (copies of the JAX package's vendored recipes) ----


class _TimmConv2dSame(torch.nn.Module):
    """timm's TF-"SAME" conv (Conv2dSame): explicit asymmetric F.pad then a
    VALID conv, the padding the reference's timm-efficientnet encoders were
    trained under."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False):
        super().__init__()
        self.conv = torch.nn.Conv2d(cin, cout, k, stride=stride, groups=groups, bias=bias)
        self.k, self.stride = k, stride

    def forward(self, x):
        ih, iw = x.shape[-2:]

        def pad_amt(i):
            o = -(-i // self.stride)
            total = max((o - 1) * self.stride + self.k - i, 0)
            return total // 2, total - total // 2

        pt, pb = pad_amt(ih)
        pl, pr = pad_amt(iw)
        return self.conv(torch.nn.functional.pad(x, (pl, pr, pt, pb)))


class _TimmMBConv(torch.nn.Module):
    """timm InvertedResidual: 1x1 expand -> BN(eps 1e-3) -> SiLU ->
    depthwise SAME -> BN -> SiLU -> SE (squeeze = in_ch * 0.25, SiLU,
    sigmoid gate) -> 1x1 project -> BN -> residual when stride 1 and cin ==
    cout."""

    def __init__(self, cin, cout, expand, k, stride):
        super().__init__()
        mid = cin * expand
        self.expand = expand
        if expand != 1:
            self.conv_pw = _TimmConv2dSame(cin, mid, 1)
            self.bn1 = torch.nn.BatchNorm2d(mid, eps=1e-3)
        self.conv_dw = _TimmConv2dSame(mid, mid, k, stride=stride, groups=mid)
        self.bn2 = torch.nn.BatchNorm2d(mid, eps=1e-3)
        sq = max(1, int(cin * 0.25))
        self.se_reduce = torch.nn.Conv2d(mid, sq, 1, bias=True)
        self.se_expand = torch.nn.Conv2d(sq, mid, 1, bias=True)
        self.conv_pwl = _TimmConv2dSame(mid, cout, 1)
        self.bn3 = torch.nn.BatchNorm2d(cout, eps=1e-3)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = x
        if self.expand != 1:
            h = torch.nn.functional.silu(self.bn1(self.conv_pw(h)))
        h = torch.nn.functional.silu(self.bn2(self.conv_dw(h)))
        s = torch.nn.functional.silu(self.se_reduce(h.mean((2, 3), keepdim=True)))
        h = h * torch.sigmoid(self.se_expand(s))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class _TimmDSConv(torch.nn.Module):
    """timm DepthwiseSeparableConv (the expand == 1 stage-0 block): dw SAME
    -> BN(eps 1e-3) -> SiLU -> SE -> 1x1 project -> BN; residual when stride
    1 and cin == cout."""

    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv_dw = _TimmConv2dSame(cin, cin, k, stride=stride, groups=cin)
        self.bn1 = torch.nn.BatchNorm2d(cin, eps=1e-3)
        sq = max(1, int(cin * 0.25))
        self.se_reduce = torch.nn.Conv2d(cin, sq, 1, bias=True)
        self.se_expand = torch.nn.Conv2d(sq, cin, 1, bias=True)
        self.conv_pw = _TimmConv2dSame(cin, cout, 1)
        self.bn2 = torch.nn.BatchNorm2d(cout, eps=1e-3)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = torch.nn.functional.silu(self.bn1(self.conv_dw(x)))
        s = torch.nn.functional.silu(self.se_reduce(h.mean((2, 3), keepdim=True)))
        h = h * torch.sigmoid(self.se_expand(s))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class _SmpDecoderBlock(torch.nn.Module):
    """smp's UnetDecoder DecoderBlock: F.interpolate(scale_factor=2,
    mode="nearest") -> cat skip -> (Conv2d k3 pad 1 no bias, BN, ReLU) x 2."""

    def __init__(self, in_ch, skip_ch, out_ch, mode="nearest"):
        super().__init__()
        self.mode = mode
        self.conv0 = torch.nn.Conv2d(in_ch + skip_ch, out_ch, 3, padding=1, bias=False)
        self.bn0 = torch.nn.BatchNorm2d(out_ch)
        self.conv1 = torch.nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = torch.nn.BatchNorm2d(out_ch)

    def forward(self, x, skip=None):
        kw = {} if self.mode == "nearest" else {"align_corners": False}
        x = torch.nn.functional.interpolate(x, scale_factor=2, mode=self.mode, **kw)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        x = torch.relu(self.bn0(self.conv0(x)))
        return torch.relu(self.bn1(self.conv1(x)))


def _randomize_bn(bn, rng):
    with torch.no_grad():
        c = bn.running_mean.shape[0]
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1))
        bn.running_var.copy_(torch.from_numpy(rng.random(c).astype(np.float32) + 0.5))


class _TimmB0SmpUnet(torch.nn.Module):
    """Full stage-1 oracle: B0 encoder (16 blocks), smp decoder (5 blocks,
    nearest upsample), 3x3 segmentation head. Taps follow the smp encoder
    contract: stem@s2, stage1@s4, stage2@s8, stage4@s16, stage6@s32."""

    def __init__(self):
        super().__init__()
        self.conv_stem = _TimmConv2dSame(3, 32, 3, stride=2)
        self.bn1 = torch.nn.BatchNorm2d(32, eps=1e-3)
        self.blocks = torch.nn.ModuleList()
        cin = 32
        for (kind, e, k, s, c, r) in _timm_stages():
            stage = torch.nn.ModuleList()
            for j in range(r):
                stride = s if j == 0 else 1
                stage.append(_TimmDSConv(cin, c, k, stride) if kind == "ds"
                             else _TimmMBConv(cin, c, e, k, stride))
                cin = c
            self.blocks.append(stage)
        # smp UnetDecoder for encoder channels (32, 24, 40, 112, 320),
        # decoder_channels (256, 128, 64, 32, 16): head=320, skips reversed
        dec_ch = (256, 128, 64, 32, 16)
        skip_ch = (112, 40, 24, 32, 0)
        in_ch = (320,) + dec_ch[:-1]
        self.dec = torch.nn.ModuleList(_SmpDecoderBlock(i, sk, o, mode="nearest")
                                       for i, sk, o in zip(in_ch, skip_ch, dec_ch))
        self.head = torch.nn.Conv2d(16, 1, 3, padding=1, bias=True)

    def forward(self, x01):
        mean = torch.tensor(_MEAN).view(1, 3, 1, 1)
        std = torch.tensor(_STD).view(1, 3, 1, 1)
        h = torch.nn.functional.silu(self.bn1(self.conv_stem((x01 - mean) / std)))
        taps = [h]
        for stage_i, stage in enumerate(self.blocks):
            for blk in stage:
                h = blk(h)
            if stage_i in (1, 2, 4, 6):
                taps.append(h)
        skips = taps[:-1][::-1] + [None]  # s16, s8, s4, s2, (none)
        h = taps[-1]
        for blk, skip in zip(self.dec, skips):
            h = blk(h, skip)
        return self.head(h)

    def timm_smp_state_dict(self):
        """Export under smp.Unet's key layout, as a real checkpoint carries
        it (BatchNorm's num_batches_tracked included)."""
        sd = {}

        def put(key, tensor):
            sd[key] = tensor.detach().clone()

        def put_bn(prefix, bn):
            for n in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
                put(f"{prefix}.{n}", getattr(bn, n))

        put("encoder.conv_stem.weight", self.conv_stem.conv.weight)
        put_bn("encoder.bn1", self.bn1)
        for si, stage in enumerate(self.blocks):
            for j, blk in enumerate(stage):
                t = f"encoder.blocks.{si}.{j}"
                if isinstance(blk, _TimmDSConv):
                    put(f"{t}.conv_dw.weight", blk.conv_dw.conv.weight)
                    put_bn(f"{t}.bn1", blk.bn1)
                    put(f"{t}.conv_pw.weight", blk.conv_pw.conv.weight)
                    put_bn(f"{t}.bn2", blk.bn2)
                else:
                    put(f"{t}.conv_pw.weight", blk.conv_pw.conv.weight)
                    put_bn(f"{t}.bn1", blk.bn1)
                    put(f"{t}.conv_dw.weight", blk.conv_dw.conv.weight)
                    put_bn(f"{t}.bn2", blk.bn2)
                    put(f"{t}.conv_pwl.weight", blk.conv_pwl.conv.weight)
                    put_bn(f"{t}.bn3", blk.bn3)
                put(f"{t}.se.conv_reduce.weight", blk.se_reduce.weight)
                put(f"{t}.se.conv_reduce.bias", blk.se_reduce.bias)
                put(f"{t}.se.conv_expand.weight", blk.se_expand.weight)
                put(f"{t}.se.conv_expand.bias", blk.se_expand.bias)
        for i, blk in enumerate(self.dec):
            d = f"decoder.blocks.{i}"
            put(f"{d}.conv1.0.weight", blk.conv0.weight)
            put_bn(f"{d}.conv1.1", blk.bn0)
            put(f"{d}.conv2.0.weight", blk.conv1.weight)
            put_bn(f"{d}.conv2.1", blk.bn1)
        put("segmentation_head.0.weight", self.head.weight)
        put("segmentation_head.0.bias", self.head.bias)
        return sd


@pytest.fixture(scope="module")
def oracle():
    torch.manual_seed(7)
    rng = np.random.default_rng(7)
    m = _TimmB0SmpUnet().eval()
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            _randomize_bn(mod, rng)
    x01 = rng.random((1, 3, 64, 96), dtype=np.float64).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x01))
    return m.timm_smp_state_dict(), x01, want.numpy()


def _port_stage1(sd, **kw):
    assert cw.detect_variant_by_key_count(sd) == "b0"
    model = PeopleSegmentationUNet(encoder_variant="b0", upsample_mode="nearest", **kw)
    state = cw.convert_people_seg_unet(sd, model=model)
    model.load_state_dict(state, strict=True)
    return model.to("cpu").eval()


@pytest.mark.parametrize("stage", range(len(_TIMM_B0_ARCH_DEF)))
def test_b0_stage_table_is_timms(stage):
    """The port's B0 stage table is timm's published arch_def, stage by
    stage (the oracle is built from the arch_def, so a wrong expansion,
    kernel, stride, width or repeat count in the port shows here by name,
    and in the oracle test as a failed strict load or forward)."""
    kind, e, k, s, c, r = _timm_stages()[stage]
    want = {"expand_ratio": e, "kernel": k, "stride": s, "out_channels": c, "repeats": r}
    got = dict(zip(want, _B0_STAGES[stage]))
    assert got == want, f"stage {stage} ({_TIMM_B0_ARCH_DEF[stage]})"
    assert (kind == "ds") == (e == 1)
    assert round_repeats(r, VARIANTS["b0"][1]) == r


@pytest.mark.parametrize("form", ["plain", "encoder_fused_blocks=3", "encoder_fused_blocks=6"])
def test_stage1_matches_timm_smp_oracle(oracle, form):
    """The port's stage 1, loaded strictly from the oracle's converted
    timm/smp state_dict, reproduces the oracle's logits: plain, and with the
    first 3 or 6 encoder blocks on the fused MBConv's plain version."""
    sd, x01, want = oracle
    kw = {} if form == "plain" else {"encoder_fused_blocks": int(form.split("=")[1])}
    model = _port_stage1(sd, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x01)).numpy()
    assert got.shape == want.shape == (1, 1, 64, 96)
    np.testing.assert_allclose(got, want, atol=ORACLE_ATOL, rtol=ORACLE_RTOL, err_msg=form)


def test_pallas_tail_falls_back_on_the_nearest_stencil(oracle, monkeypatch):
    """A converted checkpoint serves with the nearest stencil, where the
    fused tail does not apply (it is the bilinear decoder's, as in the JAX
    package): ``pallas_tail=True`` runs the plain last stage, equal to the
    model without it bit for bit, and reaches no tail function."""
    sd, x01, want = oracle
    for name in ("tail", "tail_plain", "tail_q", "tail_q_plain"):
        monkeypatch.setattr(cuda_tail, name, lambda *a, **k: pytest.fail("a fused tail ran"))
    plain, tailed = _port_stage1(sd), _port_stage1(sd, pallas_tail=True)
    with torch.no_grad():
        form, got = tailed(torch.from_numpy(x01), raw=True)
        ref = plain(torch.from_numpy(x01))
    assert form == "plain"
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.numpy(), want, atol=ORACLE_ATOL, rtol=ORACLE_RTOL)


# ---- stage 2 and the flagship against the JAX converter ----------------------


def _perturbed(variables, seed):
    """Norm affines and biases off their identity values, so a mis-mapped
    or mis-shaped scale or shift shows."""
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        owner = str(getattr(path[-2], "key", path[-2]))
        if path[0].key == "params" and name in ("scale", "bias") and owner != "output_conv":
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, jax.tree.map(np.asarray, variables))


class _Inverse:
    """Reference-layout state_dict from JAX variables: each JAX converter
    run backwards (torch conv OIHW, ConvTranspose2d taps flipped back,
    LayerNorm2d affine as (1, C, 1, 1), BN with num_batches_tracked)."""

    def __init__(self):
        self.sd = {}

    def conv(self, key, p):
        self.sd[f"{key}.weight"] = np.transpose(p["kernel"], (3, 2, 0, 1))
        if "bias" in p:
            self.sd[f"{key}.bias"] = p["bias"]

    def deconv(self, key, p):
        self.sd[f"{key}.weight"] = np.ascontiguousarray(
            np.transpose(p["deconv"]["kernel"][::-1, ::-1], (2, 3, 0, 1)))
        self.sd[f"{key}.bias"] = p["deconv"]["bias"]

    def norm(self, key, p):
        self.sd[f"{key}.weight"] = p["scale"].reshape(1, -1, 1, 1)
        self.sd[f"{key}.bias"] = p["bias"].reshape(1, -1, 1, 1)

    def bn(self, key, p, s):
        self.sd[f"{key}.weight"], self.sd[f"{key}.bias"] = p["scale"], p["bias"]
        self.sd[f"{key}.running_mean"], self.sd[f"{key}.running_var"] = s["mean"], s["var"]
        self.sd[f"{key}.num_batches_tracked"] = np.asarray(100, np.int64)

    def cna(self, conv_key, norm_key, p):
        self.conv(conv_key, p["conv"])
        self.norm(norm_key, p["norm"])

    def res(self, key, p):
        for i in (1, 2):
            self.conv(f"{key}.conv{i}", p[f"conv{i}"])
            self.norm(f"{key}.norm{i}", p[f"norm{i}"])

    def unet(self, prefix, p, s, depth_mult):
        ep, es = p["encoder"], s["encoder"]
        self.conv(f"{prefix}encoder.conv_stem", ep["stem_conv"])
        self.bn(f"{prefix}encoder.bn1", ep["stem_bn"], es["stem_bn"])
        for si, (e, _, _, _, r) in enumerate(_B0_STAGES):
            for j in range(round_repeats(r, depth_mult)):
                t, bp, bs = (f"{prefix}encoder.blocks.{si}.{j}", ep[f"stage{si}_block{j}"],
                             es[f"stage{si}_block{j}"])
                if e == 1:
                    self.conv(f"{t}.conv_dw", bp["dw_conv"])
                    self.bn(f"{t}.bn1", bp["bn1"], bs["bn1"])
                    self.conv(f"{t}.conv_pw", bp["project_conv"])
                    self.bn(f"{t}.bn2", bp["bn2"], bs["bn2"])
                else:
                    self.conv(f"{t}.conv_pw", bp["expand_conv"])
                    self.bn(f"{t}.bn1", bp["bn0"], bs["bn0"])
                    self.conv(f"{t}.conv_dw", bp["dw_conv"])
                    self.bn(f"{t}.bn2", bp["bn1"], bs["bn1"])
                    self.conv(f"{t}.conv_pwl", bp["project_conv"])
                    self.bn(f"{t}.bn3", bp["bn2"], bs["bn2"])
                self.conv(f"{t}.se.conv_reduce", bp["se"]["reduce"])
                self.conv(f"{t}.se.conv_expand", bp["se"]["expand"])
        i = 0
        while f"decoder{i}" in p:
            for ci in (1, 2):
                d = f"{prefix}decoder.blocks.{i}.conv{ci}"
                self.conv(f"{d}.0", p[f"decoder{i}"][f"conv{ci - 1}"])
                self.bn(f"{d}.1", p[f"decoder{i}"][f"bn{ci - 1}"], s[f"decoder{i}"][f"bn{ci - 1}"])
            i += 1
        self.conv(f"{prefix}segmentation_head.0", p["seg_head"])

    def guided_head(self, prefix, h):
        fp, cls = f"{prefix}.feature_processor", f"{prefix}.final_classifier"
        self.conv(f"{prefix}.input_adjust", h["input_adjust"])
        self.cna(f"{fp}.0", f"{fp}.1", h["fp_in"])
        self.res(f"{fp}.4", h["fp_res0"])
        self.res(f"{fp}.6", h["fp_res1"])
        self.cna(f"{cls}.0", f"{cls}.1", h["cls0"])
        self.conv(f"{cls}.3", h["cls_out"])
        if "att0" in h:
            self.conv(f"{prefix}.attention_module.0", h["att0"])
            self.conv(f"{prefix}.attention_module.2", h["att1"])

    def enhanced_unet(self, prefix, p, depth):
        self.cna(f"{prefix}.encoders.0.0", f"{prefix}.encoders.0.1", p["enc0_in"])
        self.res(f"{prefix}.encoders.0.3", p["enc0_res0"])
        self.res(f"{prefix}.encoders.0.4", p["enc0_res1"])
        for i in range(1, depth):
            self.res(f"{prefix}.encoders.{i}.0", p[f"enc{i}_res0"])
            self.res(f"{prefix}.encoders.{i}.1", p[f"enc{i}_res1"])
            self.cna(f"{prefix}.encoders.{i}.2", f"{prefix}.encoders.{i}.3", p[f"enc{i}_out"])
        self.res(f"{prefix}.bottleneck.0", p["bott_res0"])
        self.res(f"{prefix}.bottleneck.1", p["bott_res1"])
        self.cna(f"{prefix}.bottleneck.2", f"{prefix}.bottleneck.3", p["bott_cna"])
        self.conv(f"{prefix}.bottleneck.5", p["bott_att"])
        self.conv(f"{prefix}.bottleneck_conv", p["bott_conv"])
        for d in range(depth - 1):
            self.deconv(f"{prefix}.upconvs.{d}", p[f"up{d}"])
            self.cna(f"{prefix}.decoders.{d}.0", f"{prefix}.decoders.{d}.1", p[f"dec{d}_in"])
            self.res(f"{prefix}.decoders.{d}.3", p[f"dec{d}_res0"])
            self.res(f"{prefix}.decoders.{d}.4", p[f"dec{d}_res1"])
        self.cna(f"{prefix}.final.0", f"{prefix}.final.1", p["final_cna"])
        self.conv(f"{prefix}.final.3", p["final_out"])

    def flagship(self, variables, depth_mult, depth=3):
        p, s = variables["params"], variables["batch_stats"]
        self.unet("pretrained_unet.model.model.", p["pretrained_unet"], s["pretrained_unet"],
                  depth_mult)
        self.conv("pretrained_unet.output_conv", p["unet_wrapper"]["output_conv"])
        rp = p["rgb_extractor"]
        for i, (ci, ri) in enumerate(((0, 3), (4, 7), (8, 11))):
            self.cna(f"rgb_feature_extractor.{ci}", f"rgb_feature_extractor.{ci + 1}",
                     rp[f"conv{i}"])
            self.res(f"rgb_feature_extractor.{ri}", rp[f"res{i}"])
        self.cna("rgb_feature_extractor.12", "rgb_feature_extractor.13", rp["proj"])
        h = p["head"]
        if "feature_combiner" not in p:
            self.guided_head("segmentation_head", h)
            return {k: np.array(v, order="C") for k, v in self.sd.items()}
        self.conv("feature_combiner", p["feature_combiner"])
        b = "segmentation_head.base_head"
        bh = h["base_head"]
        self.cna(f"{b}.shared_features.0", f"{b}.shared_features.1", bh["shared_in"])
        self.res(f"{b}.shared_features.4", bh["shared_res0"])
        self.res(f"{b}.shared_features.6", bh["shared_res1"])
        self.enhanced_unet(f"{b}.bg_vs_fg_unet", bh["bg_vs_fg_unet"], depth)
        self.deconv(f"{b}.upsample_bg_fg.0", bh["upsample_deconv"])
        self.norm(f"{b}.upsample_bg_fg.1", bh["upsample_norm"])
        self.conv(f"{b}.upsample_bg_fg.3", bh["upsample_out"])
        for g, i in (("gate0", 0), ("gate1", 3), ("gate2", 5)):
            self.conv(f"{b}.fg_gate.{i}", bh[g])
        t = f"{b}.target_vs_nontarget_branch"
        if "tnt_satt" in bh:  # ModuleList(res, satt, drop, deconv, norm, act, catt, drop, res, conv)
            self.res(f"{t}.0", bh["tnt_res0"])
            self.conv(f"{t}.1.conv", bh["tnt_satt"]["conv"])
            self.deconv(f"{t}.3", bh["tnt_deconv"])
            self.norm(f"{t}.4", bh["tnt_norm"])
            self.conv(f"{t}.6.fc1", bh["tnt_catt"]["fc1"])
            self.conv(f"{t}.6.fc2", bh["tnt_catt"]["fc2"])
            self.res(f"{t}.8", bh["tnt_res1"])
            self.conv(f"{t}.9", bh["tnt_out"])
        else:
            self.res(f"{t}.0", bh["tnt_res0"])
            self.deconv(f"{t}.2", bh["tnt_deconv"])
            self.norm(f"{t}.3", bh["tnt_norm"])
            self.res(f"{t}.6", bh["tnt_res1"])
            self.conv(f"{t}.7", bh["tnt_out"])
        c = "segmentation_head.contour_branch.contour_branch"
        self.cna(f"{c}.0", f"{c}.1", h["contour"]["c0"])
        self.cna(f"{c}.3", f"{c}.4", h["contour"]["c1"])
        self.conv(f"{c}.6", h["contour"]["out"])
        d = "segmentation_head.distance_decoder.distance_head"
        self.cna(f"{d}.0", f"{d}.1", h["distance"]["d0"])
        self.res(f"{d}.3", h["distance"]["d_res"])
        self.conv(f"{d}.4", h["distance"]["out"])
        self.sd["segmentation_head.distance_decoder.threshold"] = h["distance"]["threshold"]
        if "boundary" in h:
            e, bp = "segmentation_head.boundary_refiner", h["boundary"]
            for name, i in (("edge0", 0), ("edge1", 3), ("edge_out", 6)):
                self.conv(f"{e}.edge_conv.{i}", bp[name])
            self.norm(f"{e}.edge_conv.1", bp["edge_norm0"])
            self.norm(f"{e}.edge_conv.4", bp["edge_norm1"])
            self.sd[f"{e}.blend_weight"] = bp["blend_weight"]
        return {k: np.array(v, order="C") for k, v in self.sd.items()}


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship at the tiny size with its variables, and the
    reference-layout state_dict made from them."""
    jmodel = JaxSegmenter(encoder_variant="tiny", stage1_upsample_mode="nearest", **TINY)
    v = fast_init(jmodel, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 5)), train=False, seed=5)
    variables = _perturbed(v, seed=6)
    sd = _Inverse().flagship(variables, VARIANTS["tiny"][1])
    return jmodel, variables, sd


def _tiny_port():
    return create_flagship(variant="tiny", device="cpu", stage1_upsample_mode="nearest", seed=0,
                           **TINY)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_state_dict_inverts_the_jax_converter(flagship):
    """The reference-layout state_dict is right by the JAX converter's own
    reading: it maps back to the variables it was made from, leaf for leaf."""
    _, variables, sd = flagship
    back, want = _leaves(jcw.convert_flagship_checkpoint(sd, variant="tiny")), _leaves(variables)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_flagship_converter_matches_jax_bitwise(flagship):
    """The port's converter gives exactly ``from_jax_params`` of the JAX
    converter's output: key for key, shape, dtype and bits (a doubled
    ConvTranspose2d flip or a (1, C, 1, 1) LayerNorm2d affine fails here)."""
    _, _, sd = flagship
    port = _tiny_port()
    want = from_jax_params(jcw.convert_flagship_checkpoint(sd, variant="tiny"), port)
    got = cw.convert_flagship_checkpoint({k: torch.from_numpy(v) for k, v in sd.items()},
                                         variant="tiny", model=port)
    assert set(got) == set(want) == set(port.state_dict())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    # numpy values take the same path
    got_np = cw.convert_flagship_checkpoint(sd, variant="tiny")
    assert all(torch.equal(got_np[k], v) for k, v in want.items())


def test_converted_flagship_matches_jax_flagship(flagship):
    """The port's flagship on the converted state_dict against the JAX
    flagship on the JAX-converted variables, same images and ROIs, at
    tests/test_torch_flagship.py's tolerances."""
    jmodel, _, sd = flagship
    jvars = jcw.convert_flagship_checkpoint(sd, variant="tiny")
    port = _tiny_port()
    port.load_state_dict(cw.convert_flagship_checkpoint(sd, variant="tiny", model=port),
                         strict=True)
    images = np.random.default_rng(7).random((2, 64, 96, 3), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        jlogits, jaux = jmodel.apply(jvars, jnp.asarray(images), jnp.asarray(ROIS), train=False)
    with torch.no_grad():
        logits, aux = port(torch.from_numpy(images), torch.from_numpy(ROIS))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    assert set(aux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]), atol=1e-4, rtol=1e-4,
                                   err_msg=key)


# ---- the cases of tests/test_convert_weights.py that need no reference tree ----


def test_prefix_strip_and_variant_detect():
    sd = {"model.encoder.conv_stem.weight": 1, "unet.decoder.x": 2, "plain": 3}
    out = cw.strip_prefixes(sd)
    assert set(out) == {"encoder.conv_stem.weight", "decoder.x", "plain"}
    assert out == jcw.strip_prefixes(sd)
    for n, want in ((100, "b0"), (450, "b1"), (600, "b3"), (800, "b7")):
        keys = {f"encoder.k{i}": 0 for i in range(n)}
        assert cw.detect_variant_by_key_count(keys) == want == jcw.detect_variant_by_key_count(keys)


def test_wrapper_output_conv_conversion():
    sd = {"output_conv.weight": torch.tensor([[[[1.0]]], [[[-1.0]]]]),
          "output_conv.bias": torch.zeros(2)}
    state = cw.convert_wrapper_output_conv(sd)
    assert state["output_conv.weight"].shape == (2, 1, 1, 1)
    np.testing.assert_array_equal(state["output_conv.weight"].reshape(-1).numpy(), [1.0, -1.0])
    from human_instance_segmentation_tpu_torch.models.unet import PeopleSegUNetWrapper
    PeopleSegUNetWrapper().load_state_dict(state, strict=True)
    assert cw.convert_wrapper_output_conv({"other.weight": torch.zeros(1)}) is None


def test_convert_round_trip_structure():
    """A timm/smp-named state_dict made from the JAX stage 1's variables at
    the tiny variant loads strictly into the port's stage 1 with every
    conv kernel as ``from_jax_params`` maps it, and the two forwards agree."""
    dec = (16, 16, 8, 8, 8)
    jmodel = JaxUNet(encoder_variant="tiny", decoder_channels=dec, upsample_mode="nearest")
    x = np.random.default_rng(3).random((1, 32, 32, 3), dtype=np.float32)
    variables = _perturbed(fast_init(jmodel, jnp.zeros((1, 32, 32, 3)), train=False, seed=2), 4)
    inv = _Inverse()
    inv.unet("", variables["params"], variables["batch_stats"], VARIANTS["tiny"][1])
    sd = {k: torch.from_numpy(np.array(v, order="C")) for k, v in inv.sd.items()}
    port = PeopleSegmentationUNet(encoder_variant="tiny", decoder_channels=dec,
                                  upsample_mode="nearest")
    state = cw.convert_people_seg_unet(sd, variant="tiny", model=port)
    port.load_state_dict(state, strict=True)
    want = from_jax_params(variables, port)
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(nchw(x))).numpy()
    assert out.shape == (1, 1, 32, 32)
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-4, rtol=1e-4)


# ---- strictness -------------------------------------------------------------


@pytest.mark.parametrize("case", ["unconsumed", "missing", "guided_head", "attention_module",
                                  "attention_flag", "boundary_refiner", "unfilled", "bad_shape"])
def test_flagship_converter_raises(flagship, case):
    """A key no port parameter takes, a key the converter needs, and with
    ``model``: a port parameter left unfilled, a shape that differs. The
    guided head, the attention module and the boundary refiner convert now
    (``test_a3_heads_convert_like_jax``); a checkpoint that holds only part
    of one raises: no feature_combiner reads the head as a guided head whose
    keys are missing, an attention key without ``use_attention_module`` is
    taken by nothing, ``use_attention_module`` on a plain head misses the
    attention keys, a lone edge conv misses the rest of the refiner."""
    _, _, sd = flagship
    sd = dict(sd)
    kw, err, match = {}, KeyError, None
    if case == "unconsumed":
        sd["segmentation_head.extra_conv.weight"] = np.zeros((1, 1, 1, 1), np.float32)
        match = "extra_conv"
    elif case == "missing":
        del sd["rgb_feature_extractor.13.weight"]
        match = "rgb_feature_extractor.13.weight"
    elif case == "guided_head":
        del sd["feature_combiner.weight"], sd["feature_combiner.bias"]
        match = "segmentation_head.input_adjust.weight"
    elif case == "attention_module":
        sd["segmentation_head.base_head.target_vs_nontarget_branch.1.conv.weight"] = np.zeros(
            (1, 2, 7, 7), np.float32)
        match = r"target_vs_nontarget_branch\.1\.conv\.weight"
    elif case == "attention_flag":
        kw, match = {"use_attention_module": True}, r"target_vs_nontarget_branch\.1\.conv"
    elif case == "boundary_refiner":
        sd["segmentation_head.boundary_refiner.edge_conv.0.weight"] = np.zeros(
            (1, 1, 3, 3), np.float32)
        match = r"boundary_refiner\.edge_conv\.1\.weight"
    elif case == "unfilled":  # a checkpoint without the contour branch
        for k in [k for k in sd if ".contour_branch." in k]:
            del sd[k]
        kw, match = {"model": _tiny_port()}, "head.contour.c0.conv.weight"
    else:
        sd["segmentation_head.distance_decoder.threshold"] = np.zeros(2, np.float32)
        kw, err, match = {"model": _tiny_port()}, ValueError, "threshold"
    with pytest.raises(err, match=match):
        cw.convert_flagship_checkpoint(sd, variant="tiny", **kw)


A3_HEADS = {
    "attention_boundary": dict(use_attention_module=True, use_boundary_refinement=True),
    "guided": dict(use_guided_head=True),
    "guided_attention": dict(use_guided_head=True, use_attention_module=True),
}


@pytest.mark.parametrize("case", sorted(A3_HEADS))
def test_a3_heads_convert_like_jax(case):
    """``convert_hierarchical_head_v2``'s attention form, the boundary
    refiner of ``convert_refined_head`` and ``convert_guided_head``, through
    ``convert_flagship_checkpoint``: a reference-layout state_dict made from
    JAX variables converts to exactly ``from_jax_params`` of the JAX
    converter's output, which is the port model's full state_dict."""
    flags = A3_HEADS[case]
    jmodel = JaxSegmenter(encoder_variant="tiny", stage1_upsample_mode="nearest", **TINY,
                          **flags)
    v = fast_init(jmodel, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 5)), train=False, seed=5)
    sd = _Inverse().flagship(_perturbed(v, seed=6), VARIANTS["tiny"][1])
    att = flags.get("use_attention_module", False)
    port = create_flagship(variant="tiny", device="cpu", stage1_upsample_mode="nearest", seed=0,
                           **TINY, **flags)
    want = from_jax_params(jcw.convert_flagship_checkpoint(sd, variant="tiny",
                                                           use_attention_module=att), port)
    got = cw.convert_flagship_checkpoint(sd, variant="tiny", use_attention_module=att,
                                         model=port)
    assert set(got) == set(want) == set(port.state_dict())
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    port.load_state_dict(got, strict=True)


def test_stage1_converter_raises(oracle):
    sd, _, _ = oracle
    extra = dict(sd, **{"decoder.blocks.0.attention.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="attention"):
        cw.convert_people_seg_unet(extra)
    missing = dict(sd)
    del missing["encoder.blocks.3.1.bn2.running_var"]
    with pytest.raises(KeyError, match="encoder.blocks.3.1.bn2.running_var"):
        cw.convert_people_seg_unet(missing)


def test_cli_writes_a_loadable_state_dict(oracle, tmp_path):
    """``python -m ...convert_weights``: a wrapped ``.pth`` in, the port's
    state_dict (torch.save) and the JSON sidecar out."""
    sd, x01, want = oracle
    ckpt = tmp_path / "stage1.pth"
    torch.save({"model_state_dict": {f"model.{k}": v for k, v in sd.items()}, "epoch": 3}, ckpt)
    out = tmp_path / "stage1.pt"
    cw.main(["--checkpoint", str(ckpt), "--out", str(out)])
    model = PeopleSegmentationUNet(encoder_variant="b0", upsample_mode="nearest")
    model.load_state_dict(torch.load(out, map_location="cpu", weights_only=True), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x01)).numpy()
    np.testing.assert_allclose(got, want, atol=ORACLE_ATOL, rtol=ORACLE_RTOL)
    meta = json.loads(Path(str(out) + ".json").read_text())
    assert meta["upsample_mode"] == "nearest"
    assert meta["variant"] == "b0"  # detected from the key count, not given


def test_converter_does_not_load_jax():
    code = ("import sys\n"
            "import human_instance_segmentation_tpu_torch.convert_weights\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'human_instance_segmentation_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
