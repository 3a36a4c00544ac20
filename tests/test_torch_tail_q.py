"""The port's int8 fused stage-1 tail (ops/cuda_tail.py::tail_q) and its
wiring vs the JAX package, on the same numpy inputs, weights and scales
(CPU).

The JAX Pallas kernel (ops/pallas_tail_q.py::tail_with_borders_q) runs in
interpret mode at the sizes of tests/test_pallas_tail_q.py; the port's input
is ``depth_to_space`` of the JAX input, done in numpy. On the CPU the port's
wrapper takes the kernel's plain version; the CUDA kernel is held against it
(equal in the interior) on a GPU by ``chip_smoke.py``.

Tolerances. Both sides compute the same integer sums and the same float32
steps; they differ where a composed conv0 weight (float64 here, a float32
einsum there) lands on the other side of a rounding boundary, which moves a
code by one and a few logits by a fraction of a quantization step. The aim
was max |diff| <= 1% of max |ref| and mean <= 1e-3 of it, far inside the 6%
that either has against the float oracle; reached: max below 1e-5 of max
|ref| at these seeds (no weight code differs), so the gate is 1e-3 and 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.models.unet import PeopleSegmentationUNet as JaxUNet
from human_instance_segmentation_tpu.ops.pallas_tail import TR, tail_reference
from human_instance_segmentation_tpu.ops.pallas_tail_q import (
    build_tail_weights_q as jax_build_q, tail_with_borders_q)
from human_instance_segmentation_tpu.ops.s2d import compose_up_conv_kernel
from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet
from human_instance_segmentation_tpu_torch.ops import _build, cuda_tail, quant
from human_instance_segmentation_tpu_torch.weights import load_jax_params
from test_torch_tail import _jax_ops, _torch_ops, _weights

MAX_REL, MEAN_REL = 1e-3, 1e-4


def _depth_to_space(x, r=2):
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, r, r, c // (r * r))
    return np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5)).reshape(b, h * r, w * r, -1)


def _scales(x, ops):
    """abs-max / 127 of the input, of conv1's input and of the head's, from
    the port's float chain (as tests/test_pallas_tail_q.py:27 takes them)."""
    import torch.nn.functional as F

    from human_instance_segmentation_tpu_torch.ops.sampling import upsample_2x_bilinear

    k0, bn0, k1, bn1, _, _ = _torch_ops(ops)
    s0, t0 = cuda_tail.fold_bn(bn0)
    s1, t1 = cuda_tail.fold_bn(bn1)
    y = upsample_2x_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), axes=(2, 3))
    y0 = F.relu(cuda_tail._conv(y, k0) * s0[:, None, None] + t0[:, None, None])
    y1 = F.relu(cuda_tail._conv(y0, k1) * s1[:, None, None] + t1[:, None, None])
    return tuple(max(float(np.abs(np.asarray(v)).max()), 1e-6) / 127.0 for v in (x, y0, y1))


@pytest.mark.parametrize("ci,c,hc,wc,batch", [(8, 8, 2 * TR, 16, 2), (4, 8, 2 * TR, 16, 1)])
def test_tail_q_matches_pallas_and_oracle(rng, ci, c, hc, wc, batch):
    """The sizes of tests/test_pallas_tail_q.py:44 and :60."""
    x_s2d = rng.standard_normal((batch, hc, wc, 4 * ci)).astype(np.float32)
    x = _depth_to_space(x_s2d)
    ops = _weights(rng, ci, c)
    sx, sm, sh = _scales(x, ops)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(tail_with_borders_q(jnp.asarray(x_s2d), *_jax_ops(ops), sx, sm, sh,
                                             interpret=True))
        oracle = np.asarray(tail_reference(jnp.asarray(x), *_jax_ops(ops)))
    before = cuda_tail.tail_q.launches
    out = cuda_tail.tail_q(torch.from_numpy(x), *_torch_ops(ops), sx, sm, sh)
    plain = cuda_tail.tail_q_plain(torch.from_numpy(x), *_torch_ops(ops), sx, sm, sh)
    assert cuda_tail.tail_q.launches == before and torch.equal(out, plain)
    assert tuple(out.shape) == (batch, 4 * hc, 4 * wc) and out.dtype == torch.float32
    top = np.abs(ref).max()
    diff = np.abs(out.numpy() - ref)
    print(f"tail_q vs Pallas: max {diff.max() / top:.2e}, mean {diff.mean() / top:.2e} of max "
          "|ref|")
    assert diff.max() <= MAX_REL * top and diff.mean() <= MEAN_REL * top
    # like the JAX kernel, int8-approximate against the float oracle
    err = np.abs(out.numpy() - oracle) / max(np.abs(oracle).max(), 1e-6)
    assert err[:, 6:-6, 6:-6].max() < 0.06 and err.mean() < 0.01


def test_tail_q_weight_codes_and_scales_match_jax(rng):
    """``build_tail_weights_q``'s codes and scales equal the JAX function's
    after rearrangement: the JAX patch matrices hold every composed stencil
    several times; each copy must equal the port's code. Composing in
    float64 may move a weight across a rounding boundary: at most 4 of the
    codes may differ, by one."""
    ci, c = 8, 8
    ops = _weights(rng, ci, c)
    sx, sm, sh = 0.01, 0.02, 0.03
    K22q, B0, G0, K1Pq, B1, G1, KHq, BH, GH, inv = (
        np.asarray(v) for v in jax_build_q(*_jax_ops(ops), sx, sm, sh))
    wq = cuda_tail.build_tail_weights_q(*_torch_ops(ops), sx, sm, sh)
    w0 = wq.w0q.numpy().astype(np.int32).reshape(3, 3, ci, 4 * c)
    # K22[t, s, (a, b, i), (g, h, o)] = K[2(t-1)+a+g+1, 2(s-1)+b+h+1, i, o]
    k22 = K22q.astype(np.int32).reshape(2, 2, 2, 2, ci, 2, 2, 4 * c)
    off, seen = 0, 0
    for t in range(2):
        for a in range(2):
            for g in range(2):
                d = 2 * (t - 1) + a + g
                for s in range(2):
                    for b in range(2):
                        for h in range(2):
                            e = 2 * (s - 1) + b + h
                            blk = k22[t, s, a, b, :, g, h]
                            if -1 <= d <= 1 and -1 <= e <= 1:
                                delta = np.abs(blk - w0[d + 1, e + 1])
                                assert delta.max() <= 1
                                off = max(off, int((delta != 0).sum()))
                                seen += 1
                            else:
                                assert not blk.any()
    assert seen == 36 and off <= 4
    np.testing.assert_allclose(G0.reshape(2, 2, 4 * c), np.broadcast_to(
        wq.g0.numpy().reshape(4 * c), (2, 2, 4 * c)), rtol=1e-6)
    # conv1: K1P[(du, dv, ay, ax, i), (A, B, o)] = k1[2du+ay-2-A+1, 2dv+ax-2-B+1, i, o]
    k1p = K1Pq.astype(np.int32).reshape(4, 4, 2, 2, c, 4, 4, c)
    w1 = wq.w1q.numpy().astype(np.int32)
    for du in range(4):
        for ay in range(2):
            for A in range(4):
                dy = 2 * du + ay - 2 - A
                if -1 <= dy <= 1:
                    assert np.array_equal(k1p[du, 1, ay, 0, :, A, 0], w1[dy + 1, 1])
    np.testing.assert_allclose(G1.reshape(16, c), np.broadcast_to(wq.g1.numpy(), (16, c)),
                               rtol=1e-6)
    # head: KH[di+1, dj+1, (A, B, i), (Ao, Bo)] = kh[4di+A-Ao+1, 4dj+B-Bo+1, i]
    khq = KHq.astype(np.int32).reshape(3, 3, 4, 4, c, 4, 4)
    assert np.array_equal(khq[1, 1, 1, 2, :, 1, 2], wq.whq.numpy().astype(np.int32)[1, 1, :, 0])
    assert np.array_equal(khq[0, 1, 3, 2, :, 0, 2], wq.whq.numpy().astype(np.int32)[0, 1, :, 0])
    np.testing.assert_allclose(GH, np.full((1, 16), wq.gh.item()), rtol=1e-6)
    np.testing.assert_allclose(B0[0, :c], wq.b0.numpy(), atol=1e-6)
    np.testing.assert_allclose(B1[0, :c], wq.b1.numpy(), atol=1e-6)
    np.testing.assert_allclose(inv, [[1 / wq.s_mid, 1 / wq.s_head]], rtol=1e-6)
    # the composition itself, against the JAX one
    comp = cuda_tail.compose_up_conv(torch.from_numpy(ops[0]).double()).reshape(3, 3, ci, 4 * c)
    np.testing.assert_allclose(comp.numpy(), np.asarray(compose_up_conv_kernel(
        jnp.asarray(ops[0]))), atol=1e-6)


def test_tail_q_accepts_prequantized_input(rng):
    ci, c = 4, 8
    x = rng.standard_normal((1, 4 * TR, 32, ci)).astype(np.float32)
    ops_np = _weights(rng, ci, c)
    ops = _torch_ops(ops_np)
    sx, sm, sh = _scales(x, ops_np)
    # quantized exactly as the wrapper does it, then fed as int8
    xq = torch.round(torch.from_numpy(x) * np.float32(1.0 / sx)).clamp(-127, 127).to(torch.int8)
    a = cuda_tail.tail_q(torch.from_numpy(x), *ops, sx, sm, sh)
    b = cuda_tail.tail_q(xq, *ops, sx, sm, sh, out_dtype=torch.float32)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)
    assert cuda_tail.tail_q(xq, *ops, sx, sm, sh).dtype == torch.bfloat16  # int8 in: bf16 out


@pytest.mark.parametrize("shape", [(1, 2 * TR, 24, 8, 8), (2, 13, 19, 5, 12), (1, 3, 4, 6, 4)])
def test_tail_q_border_is_the_float_tail_of_the_dequantized_input(rng, shape):
    """The outer six rows and columns equal ``tail_plain`` on ``xq * s_x``
    (computed here on the whole map, in the wrapper on four edge strips);
    the interior is int8 and does differ."""
    b, h, w, ci, c = shape
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    ops = _torch_ops(_weights(rng, ci, c))
    sx, sm, sh = 0.02, 0.03, 0.04
    out = cuda_tail.tail_q(torch.from_numpy(x), *ops, sx, sm, sh)
    xq = torch.round(torch.from_numpy(x) * np.float32(1.0 / sx)).clamp(-127, 127)
    flt = cuda_tail.tail_plain(xq * np.float32(sx), *ops)
    edge = torch.ones_like(out, dtype=torch.bool)
    edge[:, 6:-6, 6:-6] = False
    np.testing.assert_allclose(out[edge].numpy(), flt[edge].numpy(), atol=2e-5, rtol=1e-5)
    if (~edge).any():
        assert float((out - flt)[~edge].abs().max()) > 1e-3


def test_tail_q_rejects_and_has_no_fallback(rng):
    ops = _torch_ops(_weights(rng, 8, 8))
    with pytest.raises(TypeError):
        cuda_tail.tail_q(torch.zeros(1, 4, 4, 8, dtype=torch.float64), *ops, 0.1, 0.1, 0.1)
    with pytest.raises(TypeError):
        cuda_tail.tail_q(torch.zeros(1, 4, 4, 8), *ops, 0.1, 0.1, 0.1, out_dtype=torch.int8)
    with pytest.raises(ValueError):
        cuda_tail.tail_q(torch.zeros(1, 4, 4, 6), *ops, 0.1, 0.1, 0.1)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cuda_tail.tail_q(torch.zeros(1, 4, 4, 8, device="meta"), *ops, 0.1, 0.1, 0.1)


def test_tail_q_kernel_operands_layout(rng):
    """``pack_tail_weights_q``: the contraction runs over 16-byte halves, half
    h = tap * (padded channels / 16) + channel group, two to a 32-byte step,
    zero beyond; the float border's bf16 operands are the bf16 tail's."""
    ci, c = 5, 12
    ops = _torch_ops(_weights(rng, ci, c))
    wq = cuda_tail.build_tail_weights_q(*ops, 0.01, 0.02, 0.03)
    packed = cuda_tail.pack_tail_weights_q(wq, ops)
    w0, w1, wh, fp = packed[:4]
    assert tuple(w0.shape) == (5, 64, 32) and tuple(w1.shape) == (5, 16, 32)
    assert tuple(wh.shape) == (5, 8, 32) and tuple(fp.shape) == (7 * 16 + 4,)

    def halves(t):  # [step][n][32] -> [half][channel][n]
        s, n, _ = t.shape
        return t.reshape(s, n, 2, 16).permute(0, 2, 3, 1).reshape(2 * s, 16, n)

    h0, h1, hh = halves(w0), halves(w1), halves(wh)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        assert torch.equal(h0[tap, :ci].reshape(ci, 4, 16)[..., :c], wq.w0q[dy, dx])
        assert not h0[tap, ci:].any() and not h0[tap, :, :].reshape(16, 4, 16)[..., c:].any()
        assert torch.equal(h1[tap, :c, :c], wq.w1q[dy, dx]) and not h1[tap, c:].any()
        assert torch.equal(hh[tap, :c, 0], wq.whq[dy, dx, :, 0]) and not hh[tap, :, 1:].any()
    assert not h0[9].any() and not h1[9].any() and not hh[9].any()
    assert torch.equal(fp[:4 * 16].reshape(4, 16)[:, :c], wq.g0) and not fp[c:16].any()
    assert fp[-2].item() == np.float32(1 / 0.02) and fp[-1].item() == np.float32(1 / 0.03)
    assert packed.border_dtype == torch.bfloat16
    for got, want in zip(packed.border, cuda_tail.pack_tail_weights(*ops)):
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def unet_q():
    """A small UNet with the fused tail, JAX-initialised weights, its float
    logits, and its calibration."""
    jmodel = JaxUNet(encoder_variant="tiny")
    images = np.random.default_rng(5).random((1, 64, 96, 3), dtype=np.float32)
    variables = jax.tree.map(np.asarray, fast_init(jmodel, jnp.zeros((1, 64, 96, 3)),
                                                   train=False, seed=2))
    fast = load_jax_params(PeopleSegmentationUNet("tiny", pallas_tail=True).eval(), variables)
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        ref = fast(x, raw=True)[1]
        with quant.calibration(fast) as calib:
            form, _ = fast(x, raw=True)
    assert form == "plain"  # a calibration pass runs the stage unfused
    return fast, x, ref, quant.collect_scales(calib)


def test_unet_calibration_records_the_tail_scales(unet_q):
    """The three points under the JAX key names (models/unet.py:389-391 of
    the JAX package, with an empty module path)."""
    fast, x, _, scales = unet_q
    assert {"decoder4#x", "decoder4#mid", "#head", "decoder4/conv0",
            "decoder4/conv1"} <= set(scales)
    assert fast.calib_tags is None
    # #mid is conv1's input, which the QConv records too
    assert scales["decoder4#mid"] == pytest.approx(scales["decoder4/conv1"], rel=1e-6)
    # a model without the fused tail records none of them
    base = PeopleSegmentationUNet("tiny").eval()
    with torch.no_grad(), quant.calibration(base) as calib:
        base(x)
    assert not [k for k in quant.collect_scales(calib) if "#" in k]
    merged = quant.merge_scales(scales, {"#head": 1.0})
    assert merged["#head"] == 1.0 and merged["decoder4#x"] == scales["decoder4#x"]


def test_unet_int8_routes_through_tail_q(unet_q, monkeypatch):
    fast, x, ref, scales = unet_q
    calls = []
    real_q, real_f, real_p = cuda_tail.tail_q, cuda_tail.tail, cuda_tail.tail_q_plain
    monkeypatch.setattr(cuda_tail, "tail_q", lambda *a, **k: calls.append("q") or real_q(*a, **k))
    monkeypatch.setattr(cuda_tail, "tail", lambda *a, **k: calls.append("f") or real_f(*a, **k))
    monkeypatch.setattr(cuda_tail, "tail_q_plain",
                        lambda *a, **k: calls.append("p") or real_p(*a, **k))
    top = float(ref.abs().max())
    try:
        quant.set_int8_serving(fast, True, scales)
        assert fast.tail_scales == (scales["decoder4#x"], scales["decoder4#mid"], scales["#head"])
        with torch.no_grad():
            form, y = fast(x, raw=True)
        assert form == "dense" and calls[0] == "q" and tuple(y.shape) == (1, 64, 96)
        err = float((y - ref).abs().max()) / top
        print(f"int8 UNet with the s8 tail vs float logits: {100 * err:.2f}% of max |ref|")
        assert err < 0.08  # tests/test_pallas_tail_q.py:114-116
        del calls[:]
        with torch.no_grad(), _build.plain():  # the plain version, through the entry point
            assert torch.equal(fast(x, raw=True)[1], y) and calls == ["q", "p"]
        for missing in ("decoder4#x", "decoder4#mid", "#head"):
            del calls[:]
            quant.set_int8_serving(fast, True, {k: v for k, v in scales.items() if k != missing})
            with torch.no_grad():
                form, y_f = fast(x, raw=True)
            assert form == "dense" and calls == ["f"] and fast.tail_scales is None
            assert float((y_f - ref).abs().max()) / top < 0.08
        # a denied last stage keeps the float tail
        del calls[:]
        quant.set_int8_serving(fast, True, scales, deny=("decoder4/",))
        with torch.no_grad():
            fast(x, raw=True)
        assert calls == ["f"]
    finally:
        quant.set_int8_serving(fast, False)
    assert fast.tail_scales is None


def test_unet_tail_q_against_the_pallas_kernel_with_the_ports_scales(unet_q):
    """The JAX model with ``pallas_tail`` compiles for minutes on a CPU, so
    the stage is held against the JAX kernel function on the port's own
    decoder3 output and scales."""
    fast, x, _, scales = unet_q
    got = {}
    real = cuda_tail.tail_q
    cuda_tail.tail_q = lambda *a, **k: got.setdefault("y", (a, real(*a, **k)))[1]
    try:
        quant.set_int8_serving(fast, True, scales)
        with torch.no_grad():
            fast(x, raw=True)
    finally:
        cuda_tail.tail_q = real
        quant.set_int8_serving(fast, False)
    (h, k0, bn0, k1, bn1, kh, bh, sx, sm, sh), y = got["y"]
    xs = h.detach().numpy()  # (1, 32, 48, 32) NHWC view
    b, hh, ww, ci = xs.shape
    x_s2d = xs.reshape(b, hh // 2, 2, ww // 2, 2, ci).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, hh // 2, ww // 2, 4 * ci)
    j = lambda t: jnp.asarray(t.detach().numpy())
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(tail_with_borders_q(
            jnp.asarray(x_s2d), j(k0), tuple(j(v) for v in bn0), j(k1), tuple(j(v) for v in bn1),
            j(kh), j(bh), sx, sm, sh, interpret=True))
    top = np.abs(ref).max()
    diff = np.abs(y.numpy() - ref)
    assert diff.max() <= MAX_REL * top and diff.mean() <= MEAN_REL * top
