"""Operands the port's fused kernels keep, and the fact the int8 tail's
in-kernel border rests on (CPU, no JAX).

- ``cuda_head.prepare_bf16``: the bf16 fused unit's K-major weight pack,
  against an index formula, and the blocks keeping it (made once, rebuilt
  when a weight or a norm parameter changes in place).
- ``cuda_tail.tail_q_plain``: its outer six rows and columns are the float
  tail (``tail_plain``) of the whole dequantized map, which is what the CUDA
  kernel computes in its edge tiles.
- ``cuda_tail.pack_tail_weights_q``: the border's operands travel with the
  int8 ones, for a bf16 and a float32 output.
"""

import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu_torch.models import blocks
from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_tail


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("ci,co,k", [(384, 384, 3), (256, 384, 1), (8, 16, 3), (24, 8, 1)])
def test_bf16_pack_is_k_major_with_taps_outermost(rng, ci, co, k):
    """Row co, column tap * Ci + c holds w[tap // k, tap % k, c, co] in bf16;
    the row is zero-padded to a multiple of 64 values (128 bytes)."""
    w = torch.from_numpy(rng.standard_normal((k, k, ci, co)).astype(np.float32))
    ops = cuda_head.prepare_bf16(w.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0),
                                 torch.zeros(co), torch.ones(co), torch.zeros(co))
    kp = -(-k * k * ci // 64) * 64
    assert tuple(ops.packed.shape) == (co, kp) and ops.packed.dtype == torch.bfloat16
    assert ops.packed.is_contiguous()
    wb = w.to(torch.bfloat16)
    for tap in range(k * k):
        for c in (0, ci // 2, ci - 1):
            assert torch.equal(ops.packed[:, tap * ci + c], wb[tap // k, tap % k, c])
    assert not ops.packed[:, k * k * ci:].any()
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in ops[1:])


def test_prepared_operands_must_match_the_form(rng):
    c = 8
    x = torch.from_numpy(rng.standard_normal((1, 4, 3, c)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, c, c)).astype(np.float32))
    b, g, be = torch.zeros(c), torch.ones(c), torch.zeros(c)
    bf16_ops = cuda_head.prepare_bf16(w, b, g, be)
    s8_ops = cuda_head.prepare_s8(w, 0.02, b, g, be)
    with pytest.raises(TypeError):
        cuda_head.conv_ln_act(x, w, b, g, be, height=4, width=3, xscale=0.02, prepared=bf16_ops)
    with pytest.raises(TypeError):
        cuda_head.conv_ln_act(x, w, b, g, be, height=4, width=3, prepared=s8_ops)
    # on the CPU the bf16 operands are not read: the plain version's result
    want = cuda_head.conv_ln_act_plain(x, w, b, g, be)
    assert torch.equal(cuda_head.conv_ln_act(x, w, b, g, be, height=4, width=3,
                                             prepared=bf16_ops), want)


@pytest.mark.parametrize("block_kind", ["cna", "residual"])
@pytest.mark.parametrize("change", ["weight", "bias", "norm_weight", "norm_bias"])
def test_bf16_fused_unit_prepares_its_operands_once(rng, monkeypatch, block_kind, change):
    """A fusable bf16 block hands the fused unit operands its conv keeps:
    made once, rebuilt when the conv's weight or bias or the norm's weight or
    bias changes in place; the weight itself comes as a view."""
    c = 256
    if block_kind == "cna":
        block = blocks.ConvNormAct(c, c, kernel=3).eval().to(torch.bfloat16)
        conv, norm = block.conv, block.norm
    else:
        block = blocks.ResidualBlock(c).eval().to(torch.bfloat16)
        conv, norm = block.conv1, block.norm1
    blocks.set_head_fusion(block, True)
    x = torch.from_numpy(rng.standard_normal((1, c, 4, 3)).astype(np.float32)).to(torch.bfloat16)
    seen = []
    real = cuda_head.conv_ln_act

    def spy(*args, **kwargs):
        seen.append((kwargs["prepared"], args[1]))
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_head, "conv_ln_act", spy)
    calls = 1 if block_kind == "cna" else 2
    with torch.no_grad():
        first = block(x)
        block(x)
        assert len(seen) == 2 * calls
        assert isinstance(seen[0][0], cuda_head.FusedBF16Operands)
        assert seen[calls][0] is seen[0][0]  # kept
        assert not seen[0][1].is_contiguous()  # the weight as a view, not a copy
        target = {"weight": conv.weight, "bias": conv.bias, "norm_weight": norm.weight,
                  "norm_bias": norm.bias}[change]
        target.add_(0.25)
        out = block(x)
        assert seen[2 * calls][0] is not seen[0][0]  # rebuilt
        block(x)
        assert seen[3 * calls][0] is seen[2 * calls][0]
    assert not torch.equal(out, first)
    ops = seen[2 * calls][0]
    want = cuda_head.prepare_bf16(conv.weight.permute(2, 3, 1, 0), conv.bias, norm.weight,
                                  norm.bias)
    for got, ref in zip(ops, want):
        assert torch.equal(got, ref)


def test_bf16_fused_unit_keeps_nothing_for_inference_mode_weights(rng, monkeypatch):
    c = 256
    with torch.inference_mode():
        block = blocks.ConvNormAct(c, c, kernel=1).eval().to(torch.bfloat16)
        blocks.set_head_fusion(block, True)
        seen = []
        real = cuda_head.conv_ln_act
        monkeypatch.setattr(cuda_head, "conv_ln_act",
                            lambda *a, **kw: seen.append(kw["prepared"]) or real(*a, **kw))
        x = torch.from_numpy(rng.standard_normal((1, c, 4, 3)).astype(np.float32))
        block(x.to(torch.bfloat16)), block(x.to(torch.bfloat16))
    assert seen[0] is not seen[1] and block.conv._cache == {}


def _tail_ops(rng, ci, c, dtype):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    def bn():
        return tuple(t(v) for v in (rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
                                    rng.standard_normal(c) * 0.1, rng.uniform(0.5, 1.5, c)))

    return (t(rng.standard_normal((3, 3, ci, c)) / (9 * ci) ** 0.5), bn(),
            t(rng.standard_normal((3, 3, c, c)) / (9 * c) ** 0.5), bn(),
            t(rng.standard_normal((3, 3, c, 1)) / (9 * c) ** 0.5), t(rng.standard_normal(1)))


# float32: the strips and the whole map run the same float32 ops but their
# convs sum in their own orders (a few float32 ulps of logits of size ~1).
# bf16: the same, and a conv sum that lands on the other side of a bf16
# rounding boundary moves y0 or y1 by one bf16 ulp: the tail kernel's gate
# (chip_smoke.TOL_TAIL), two such flips near a pixel and one ulp of the logit.
TOL_BORDER = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2.0 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24, 32, 16), (1, 13, 19, 5, 12), (1, 9, 21, 12, 20)])
def test_tail_q_border_is_the_float_tail_of_the_whole_dequantized_map(rng, shape, dtype):
    """The outer six rows and columns of ``tail_q_plain`` (made from four
    edge strips) equal ``tail_plain`` of the whole dequantized input
    ``bf16(xq * s_x)`` (``xq * s_x`` in float32) at those pixels."""
    b, h, w, ci, c = shape
    ops = _tail_ops(rng, ci, c, dtype)
    x = torch.from_numpy(rng.standard_normal((b, h, w, ci)).astype(np.float32)).to(dtype)
    sx, sm, sh = float(x.float().abs().max()) / 127 * 0.8, 0.03, 0.04
    out = cuda_tail.tail_q_plain(x, *ops, sx, sm, sh)
    xq = torch.round(x.float() * np.float32(1.0 / sx)).clamp(-127, 127)
    whole = cuda_tail.tail_plain((xq * np.float32(sx)).to(dtype), *ops)
    edge = torch.ones(out.shape, dtype=torch.bool)
    edge[:, cuda_tail.BORDER:-cuda_tail.BORDER, cuda_tail.BORDER:-cuda_tail.BORDER] = False
    got, want = out[edge].float(), whole[edge].float()
    atol, rtol = TOL_BORDER[dtype]
    assert out.dtype == dtype
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tail_q_pack_carries_the_border_operands(rng, dtype):
    """The kept operands of the s8 tail hold the float border's: the bf16
    tail's packed weights for a bf16 output, the float32 tail's padded
    weights, BN scale and shift and head bias for a float32 one."""
    ci, c = 32, 16
    ops = _tail_ops(rng, ci, c, torch.float32)
    wq = cuda_tail.build_tail_weights_q(*ops, 0.01, 0.02, 0.03)
    packed = cuda_tail.pack_tail_weights_q(wq, ops, dtype)
    assert packed.border_dtype == dtype
    if dtype == torch.bfloat16:
        want = cuda_tail.pack_tail_weights(*ops)
    else:
        want = cuda_tail._f32_operands(*ops)
        s0, t0 = cuda_tail.fold_bn(ops[1])
        assert torch.equal(packed.border[1][:, :c], torch.stack([s0, t0]))
        assert torch.equal(packed.border[0][:, :ci, :c], ops[0].reshape(9, ci, c))
    assert len(packed.border) == len(want)
    for got, ref in zip(packed.border, want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    with pytest.raises(TypeError):
        cuda_tail.pack_tail_weights_q(wq, ops, torch.float16)


def test_unet_keeps_the_tail_q_operands_with_their_border(monkeypatch):
    """The UNet packs the s8 tail's operands, border included, once per
    weights, scales and dtype."""
    from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet

    unet = PeopleSegmentationUNet("tiny", pallas_tail=True).eval()
    unet.tail_scales = (0.02, 0.03, 0.04)
    last = unet._last
    operands = (last.conv0.weight.permute(2, 3, 1, 0),
                (last.bn0.weight, last.bn0.bias, last.bn0.running_mean, last.bn0.running_var),
                last.conv1.weight.permute(2, 3, 1, 0),
                (last.bn1.weight, last.bn1.bias, last.bn1.running_mean, last.bn1.running_var),
                unet.seg_head.weight.permute(2, 3, 1, 0), unet.seg_head.bias)
    builds = []
    real = cuda_tail.pack_tail_weights_q
    monkeypatch.setattr(cuda_tail, "pack_tail_weights_q",
                        lambda *a, **k: builds.append(a) or real(*a, **k))
    first = unet._tail_operands(operands, torch.bfloat16, "int8")
    assert unet._tail_operands(operands, torch.bfloat16, "int8") is first and len(builds) == 1
    assert first.border_dtype == torch.bfloat16 and first.border is not None
    with torch.no_grad():
        last.conv1.weight.mul_(0.5)
    again = unet._tail_operands(operands, torch.bfloat16, "int8")
    assert again is not first and len(builds) == 2
    f32 = unet._tail_operands(operands, torch.float32, "int8")
    assert f32.border_dtype == torch.float32 and len(builds) == 3
