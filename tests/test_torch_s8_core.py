"""The host side of the s8 conv core: packed weights, prepared operands and
the strided, bias-fused QConv forward, on the CPU.

Everything here is integer-exact or a single rounded float op per step, so
every comparison is bitwise (tolerance 0). The kernels themselves run only on
a GPU; ``chip_smoke.py`` holds them against the plain versions used here.
"""

import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu_torch.models import blocks
from human_instance_segmentation_tpu_torch.ops import cuda_head, quant


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ci,co", [(258, 2), (432, 1), (2, 258), (1, 432), (64, 64), (16, 16)])
def test_kmajor_pack_round_trips(rng, ci, co, k):
    """Row co of the pack holds tap after tap that tap's Ci codes, zero codes
    up to a multiple of 16 and to the end of the 128-byte row; unpacking gives
    the HWIO codes back."""
    wq = _codes(rng, (k, k, ci, co))
    packed = quant.pack_weight_kmajor(wq)
    cp = -(-ci // 16) * 16
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (co, quant.packed_k(ci, k)) and packed.shape[1] % 128 == 0
    assert packed.shape[1] - k * k * cp < 128
    assert torch.equal(quant.unpack_weight_kmajor(packed, k, ci), wq)
    rows = packed[:, :k * k * cp].reshape(co, k * k, cp)
    assert torch.equal(rows[:, :, :ci], wq.permute(3, 0, 1, 2).reshape(co, k * k, ci))
    assert int(rows[:, :, ci:].abs().sum()) == 0 and int(packed[:, k * k * cp:].abs().sum()) == 0


def test_matmul_pack_is_b_transposed(rng):
    b = _codes(rng, (300, 24))
    packed = quant.pack_matmul_b(b)
    assert packed.shape == (24, quant.packed_k(300, 1))
    assert torch.equal(packed[:, :300], b.t()) and int(packed[:, 300:].abs().sum()) == 0


def _qconv(rng, ci=24, co=8, k=3, bias=True, dtype=torch.float32):
    conv = quant.QConv(ci, co, k, padding=k // 2, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            (rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)).astype(np.float32)))
        if bias:
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(co).astype(np.float32)))
    conv = conv.to(dtype)
    quant.set_int8_serving(conv, True, {"": 0.05})
    return conv


@pytest.mark.parametrize("change", ["weight", "bias", "scale", "dtype"])
def test_qconv_prepared_operands_follow_their_inputs(rng, change):
    """The prepared operands are kept while nothing they depend on changes,
    and rebuilt when the weight or the bias changes in place, when the static
    scale changes and when the activations' dtype changes."""
    conv = _qconv(rng)
    first = conv.prepared(torch.float32)
    assert conv.prepared(torch.float32) is first
    assert first.packed.shape == (8, quant.packed_k(24, 3))
    assert torch.equal(first.scale, torch.full((1,), 0.05) * first.sw)
    assert torch.equal(first.bias32, conv.bias.detach())
    dtype = torch.float32
    with torch.no_grad():
        if change == "weight":
            conv.weight.mul_(-2.0)
        elif change == "bias":
            conv.bias.add_(1.0)
        elif change == "scale":
            conv.static_scale = 0.07
        else:
            dtype = torch.bfloat16
    again = conv.prepared(dtype)
    assert again is not first and conv.prepared(dtype) is again
    hwio = conv.weight.detach().to(dtype).permute(2, 3, 1, 0).contiguous()
    fresh = quant.s8_operands(quant.s8_weights(hwio), conv.static_scale, conv.bias, dtype)
    for got, want in zip(again, fresh):
        assert torch.equal(got, want)
    if change in ("bias", "scale"):  # the weight codes do not depend on them
        assert again.packed is first.packed


def test_qconv_keeps_nothing_for_inference_mode_weights(rng):
    src = _qconv(rng)
    with torch.inference_mode():
        made = quant.QConv(24, 8, 3, padding=1)
        made.load_state_dict(src.state_dict())
        quant.set_int8_serving(made, True, {"": 0.05})
        a, b = made.prepared(torch.float32), made.prepared(torch.float32)
        assert a is not b and made._cache == {}
        for got, want in zip(a, src.prepared(torch.float32)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("scale", ["static", "dynamic"])
def test_qconv_forward_is_layout_blind_and_adds_bias_in_the_old_order(rng, dtype, bias, scale):
    """Contiguous-NCHW and channels-last inputs (and a strided view) give
    identical bits, equal to ``qconv2d_plain`` on an NHWC copy followed by a
    separate bias add in the output dtype; the result lies in channels-last
    memory."""
    conv = _qconv(rng, bias=bias, dtype=dtype)
    if scale == "dynamic":
        conv.static_scale = None
    x = torch.from_numpy(rng.standard_normal((2, 24, 6, 5)).astype(np.float32)).to(dtype)
    xh = x.permute(0, 2, 3, 1).contiguous()
    want = quant.qconv2d_plain(xh, conv.weight.detach().permute(2, 3, 1, 0).contiguous(), 1, 1,
                               conv.static_scale)
    if bias:
        want = want + conv.bias.detach().to(want.dtype)
    wide = torch.zeros((2, 40, 6, 5), dtype=dtype)
    wide[:, 8:32] = x
    with torch.no_grad():
        outs = [conv(x), conv(x.contiguous(memory_format=torch.channels_last)), conv(wide[:, 8:32])]
    for y in outs:
        assert y.dtype == dtype and y.shape == (2, 8, 6, 5)
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(y.permute(0, 2, 3, 1), want)


def test_qconv_int8_input_takes_the_weight_dtype(rng):
    conv = _qconv(rng, dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((1, 24, 4, 4)).astype(np.float32))
    xq = quant.quantize_symmetric(x, 0.05)
    with torch.no_grad():
        y = conv(xq)
    want = quant.qconv2d_plain(xq.permute(0, 2, 3, 1), conv.weight.detach().permute(2, 3, 1, 0),
                               1, 1, 0.05) + conv.bias.detach()
    assert y.dtype == torch.bfloat16 and torch.equal(y.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv2d_with_prepared_operands_equals_without(rng, dtype):
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 20)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((3, 3, 20, 6)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    ops = quant.s8_operands(quant.s8_weights(w), 0.04, b, dtype)
    for fn in (quant.qconv2d, quant.qconv2d_plain):
        assert torch.equal(fn(x, None, 1, 1, prepared=ops), fn(x, w, 1, 1, 0.04, bias=b))
    assert torch.equal(quant.qconv2d(x, w, 1, 1, 0.04, bias=b),
                       quant.qconv2d(x, w, 1, 1, 0.04) + b.to(dtype))
    assert torch.equal(quant.qconv2d_nchw(x.permute(0, 3, 1, 2), ops, 1, 1).permute(0, 2, 3, 1),
                       quant.qconv2d(x, w, 1, 1, 0.04, bias=b))
    with pytest.raises(ValueError, match="out_dtype"):  # an int8 input names its output dtype
        quant.qconv2d_plain(quant.quantize_symmetric(x, 0.04), None, 1, 1, prepared=ops)


def _fused_operands(rng, n=2, h=4, w=3, c=16, k=3):
    t = {"x": rng.standard_normal((n, h, w, c)), "w": rng.standard_normal((k, k, c, c)) / (3 * c),
         "b": rng.standard_normal(c) * 0.1, "g": 1 + rng.standard_normal(c) * 0.2,
         "beta": rng.standard_normal(c) * 0.1, "res": rng.standard_normal((n, h, w, c))}
    return {name: torch.from_numpy(v.astype(np.float32)) for name, v in t.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_conv_ln_act_plain_with_prepared_operands_equals_without(rng, dtype, residual):
    t = _fused_operands(rng)
    x, w, res = t["x"].to(dtype), t["w"].to(dtype), t["res"].to(dtype) if residual else None
    xs = float(t["x"].abs().max() / 127.0)
    ops = cuda_head.prepare_s8(w, xs, t["b"], t["g"], t["beta"])
    assert ops.packed.shape == (16, quant.packed_k(16, 3))
    assert torch.equal(quant.unpack_weight_kmajor(ops.packed, 3, 16), ops.wq)
    want = cuda_head.conv_ln_act_plain(x, w, t["b"], t["g"], t["beta"], res, xscale=xs)
    got = cuda_head.conv_ln_act_plain(x, w, t["b"], t["g"], t["beta"], res, xscale=xs,
                                      prepared=ops)
    assert torch.equal(got, want)
    # the wrapper passes them through, and reads w only for its shape
    view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    via = cuda_head.conv_ln_act(x, view, t["b"], t["g"], t["beta"], res, height=4, width=3,
                                xscale=xs, prepared=ops)
    assert torch.equal(via, want)


@pytest.mark.parametrize("change", ["weight", "norm", "scale", "dtype"])
def test_fused_unit_prepared_operands_follow_their_inputs(rng, monkeypatch, change):
    """A fusable block hands the fused unit operands its conv keeps: made
    once, rebuilt when the conv's weight or the norm's parameters change in
    place, when the calibrated scale changes and when the dtype changes."""
    c = 256
    block = blocks.ConvNormAct(c, c, kernel=1).eval()
    blocks.set_head_fusion(block, True)
    quant.set_int8_serving(block, True, {"conv": 0.03})
    x = torch.from_numpy(rng.standard_normal((1, c, 4, 3)).astype(np.float32))
    seen = []
    real = cuda_head.conv_ln_act

    def spy(*args, **kwargs):
        seen.append(kwargs["prepared"])
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_head, "conv_ln_act", spy)
    with torch.no_grad():
        first = block(x)
        block(x)
        assert seen[0] is not None and seen[1] is seen[0]
        if change == "weight":
            block.conv.weight.mul_(0.5)
        elif change == "norm":
            block.norm.weight.add_(0.25)
        elif change == "scale":
            quant.set_int8_serving(block, True, {"conv": 0.04})
        else:
            block, x = block.to(torch.bfloat16), x.to(torch.bfloat16)
        out = block(x)
        assert seen[2] is not seen[0]
        block(x)
        assert seen[3] is seen[2]
    assert not torch.equal(out.float(), first)
    hwio = block.conv.weight.detach().permute(2, 3, 1, 0).contiguous()
    want = cuda_head.conv_ln_act_plain(
        x.permute(0, 2, 3, 1).contiguous(), hwio, block.conv.bias.detach(),
        block.norm.weight.detach(), block.norm.bias.detach(), kernel=1,
        xscale=block.conv.static_scale)
    assert torch.equal(out.permute(0, 2, 3, 1), want)


def test_fused_unit_keeps_nothing_for_inference_mode_weights(rng, monkeypatch):
    c = 256
    with torch.inference_mode():
        block = blocks.ConvNormAct(c, c, kernel=1).eval()
        blocks.set_head_fusion(block, True)
        quant.set_int8_serving(block, True, {"conv": 0.03})
        seen = []
        real = cuda_head.conv_ln_act
        monkeypatch.setattr(cuda_head, "conv_ln_act",
                            lambda *a, **kw: seen.append(kw["prepared"]) or real(*a, **kw))
        x = torch.from_numpy(rng.standard_normal((1, c, 4, 3)).astype(np.float32))
        block(x), block(x)
    assert seen[0] is not seen[1] and block.conv._cache == {}


@pytest.mark.parametrize("ci,co,k,x_dtype,aligned,want", [
    (32, 16, 3, torch.bfloat16, True, False),   # narrow output: one launch, no buffer
    (128, 1, 1, torch.float32, True, False),
    (64, 64, 3, torch.bfloat16, True, True),    # wgmma: a float input is quantized once
    (64, 64, 3, torch.int8, True, False),       # an aligned int8 input is read where it lies
    (64, 64, 3, torch.int8, False, True),
    (258, 256, 1, torch.int8, True, True),      # ragged channels are padded to 16
])
def test_staging_is_needed_only_by_float_or_ragged_input_of_the_wide_kernel(
        monkeypatch, ci, co, k, x_dtype, aligned, want):
    """The Python side of the staging decision; the library's own answer (one
    call per (Ci, Co, k), here a stand-in with the kernel's rule) says which
    shapes the one-launch kernel takes."""

    class Lib:
        @staticmethod
        def s8_conv_needs_staging(x, sn, sc, sh, sw, in_dtype, ci, co, k):
            return int(co > 32)

    monkeypatch.setattr(quant, "_NARROW", {})
    x = torch.zeros((2, 4, 4, ci + (0 if aligned else 3)), dtype=x_dtype)[..., :ci]
    x = x.permute(0, 3, 1, 2)
    assert quant._needs_staging(Lib, x, x.stride(), ci, co, k) is want
