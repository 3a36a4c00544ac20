"""The port's fused stage-1 tail (ops/cuda_tail.py) and its wiring
(``PeopleSegmentationUNet(pallas_tail=True)``, the flagship's dense branch)
vs the JAX package, on the same numpy inputs and carried weights (CPU).

The JAX Pallas tail runs in interpret mode at the shapes of
tests/test_pallas_tail.py. The JAX *model* with ``pallas_tail=True`` compiles
for minutes on a CPU, so the wiring is held against the JAX package's plain
path, which computes the same function. On the CPU the port's wrapper takes
the kernel's plain version; the CUDA kernel is held against it on a GPU by
``chip_smoke.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.inference import InferenceEngine as JaxEngine
from human_instance_segmentation_tpu.models.assembly import (
    HierarchicalInstanceSegmenter as JaxSegmenter)
from human_instance_segmentation_tpu.models.unet import PeopleSegmentationUNet as JaxUNet
from human_instance_segmentation_tpu.ops.pallas_tail import TR, tail_reference, tail_with_borders
from human_instance_segmentation_tpu.ops.s2d import space_to_depth
from human_instance_segmentation_tpu_torch.inference import InferenceEngine, create_flagship
from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet
from human_instance_segmentation_tpu_torch.ops import _build, cuda_tail, quant
from human_instance_segmentation_tpu_torch.ops.sampling import upsample_2x_bilinear
from human_instance_segmentation_tpu_torch.weights import load_jax_params

ATOL, RTOL = 2e-5, 1e-5  # tests/test_pallas_tail.py:42
TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32,
            base_channels=64)
ROIS = np.asarray([[0.0, 0.1, 0.2, 0.7, 0.9],
                   [1.0, 0.0, 0.0, 1.0, 1.0],
                   [0.0, 0.4, 0.3, 0.6, 0.8]], np.float32)


def _weights(rng, ci, c):
    """The operands of tests/test_pallas_tail.py, as numpy."""
    f = np.float32
    k0 = (rng.standard_normal((3, 3, ci, c)) * 0.2).astype(f)
    k1 = (rng.standard_normal((3, 3, c, c)) * 0.2).astype(f)
    kh = (rng.standard_normal((3, 3, c, 1)) * 0.2).astype(f)
    bh = rng.standard_normal((1,)).astype(f)

    def bn():
        return tuple(v.astype(f) for v in (
            rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
            rng.standard_normal(c) * 0.1, rng.uniform(0.5, 1.5, c)))

    return k0, bn(), k1, bn(), kh, bh


def _torch_ops(ops, dtype=torch.float32):
    return tuple(tuple(torch.from_numpy(v).to(dtype) for v in o) if isinstance(o, tuple)
                 else torch.from_numpy(o).to(dtype) for o in ops)


def _jax_ops(ops):
    return tuple(tuple(jnp.asarray(v) for v in o) if isinstance(o, tuple) else jnp.asarray(o)
                 for o in ops)


@pytest.mark.parametrize("wrapper", ["plain", "dispatch", "dispatch_nchw_memory"])
@pytest.mark.parametrize("hc,wc", [(2 * TR, 24), (3 * TR, 16)])
def test_tail_matches_pallas_and_reference(rng, hc, wc, wrapper):
    ci, c = 8, 8
    x = rng.standard_normal((2, 2 * hc, 2 * wc, ci)).astype(np.float32)
    ops = _weights(rng, ci, c)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(tail_reference(jnp.asarray(x), *_jax_ops(ops)))
        pallas = np.asarray(tail_with_borders(space_to_depth(jnp.asarray(x), 2), *_jax_ops(ops),
                                              interpret=True))
    xt = torch.from_numpy(x)
    if wrapper == "dispatch_nchw_memory":  # as the UNet hands it over: no copy
        xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = cuda_tail.tail.launches
    fn = cuda_tail.tail_plain if wrapper == "plain" else cuda_tail.tail
    out = fn(xt, *_torch_ops(ops))
    assert cuda_tail.tail.launches == before  # CPU tensors take the plain version
    assert tuple(out.shape) == (2, 4 * hc, 4 * wc) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 13, 19, 5, 12), (1, 9, 21, 12, 20), (1, 2, 3, 32, 16)])
def test_tail_ragged_shapes_match_reference(rng, shape):
    """Odd sizes and channel counts off every tile width: no TPU tiling
    condition survives in the port."""
    b, h, w, ci, c = shape
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    ops = _weights(rng, ci, c)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(tail_reference(jnp.asarray(x), *_jax_ops(ops)))
    out = cuda_tail.tail(torch.from_numpy(x), *_torch_ops(ops))
    assert tuple(out.shape) == (b, 2 * h, 2 * w)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_tail_bf16_rounding_rule(rng):
    """bfloat16: each conv multiplies bf16 operands with float32 sums, BN is a
    float32 multiply and add, and three activations are rounded to bf16 (the
    upsampled input, conv0's and conv1's outputs after BN and ReLU); the
    logit is rounded once. The bf16 result is, bit for bit, a float32
    computation that rounds at those points; rounding only the logit gives
    another result."""
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    k0, bn0, k1, bn1, kh, bh = _torch_ops(_weights(rng, 8, 8), torch.bfloat16)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    out = cuda_tail.tail(x16, k0, bn0, k1, bn1, kh, bh)
    assert out.dtype == torch.bfloat16

    def rnd(t):
        return t.to(torch.bfloat16).float()

    def conv(y, k):
        return torch.nn.functional.conv2d(y, k.float().permute(3, 2, 0, 1), padding=1)

    def bn_relu(y, bn):
        scale, bias, mean, var = (v.float() for v in bn)
        s = scale * torch.rsqrt(var + 1e-5)
        return torch.relu(y * s[:, None, None] + (bias - mean * s)[:, None, None])

    u = rnd(upsample_2x_bilinear(x16.float().permute(0, 3, 1, 2), axes=(2, 3)))
    y0 = rnd(bn_relu(conv(u, k0), bn0))
    y1 = rnd(bn_relu(conv(y0, k1), bn1))
    want = (conv(y1, kh)[:, 0] + bh.float()).to(torch.bfloat16)
    assert torch.equal(out, want)
    widened = tuple(tuple(v.float() for v in o) if isinstance(o, tuple) else o.float()
                    for o in (k0, bn0, k1, bn1, kh, bh))
    assert not torch.equal(out, cuda_tail.tail_plain(x16.float(), *widened).to(torch.bfloat16))


@pytest.mark.parametrize("hc,wc,ci,c", [(2 * TR, 24, 8, 8), (3 * TR, 16, 32, 16)])
def test_tail_bf16_matches_pallas_in_bf16(rng, hc, wc, ci, c):
    """The bf16 plain tail against the JAX package's ``tail_with_borders`` in
    bfloat16 (Pallas interpreted, XLA border strips): within 4 bf16 ulps of
    the largest logit (the ulp of its binade). Both round the logit once and
    y0 and y1 at the same stages, but from sums of other operands: JAX
    rounds the weights after composing the upsample into conv0 and folding
    BN in, and computes its border strips with bf16 XLA ops; the port rounds
    the upsampled input and keeps BN in float32. Over these seeded inputs
    the two lie 1-2.6 ulps apart (measured), and the port is the nearer of
    the two to the float32 tail."""
    x = rng.standard_normal((2, 2 * hc, 2 * wc, ci)).astype(np.float32)
    ops = _weights(rng, ci, c)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jops = jax.tree.map(lambda v: v.astype(jnp.bfloat16), _jax_ops(ops))
    pallas = np.asarray(tail_with_borders(space_to_depth(xb, 2), *jops, interpret=True)
                        .astype(jnp.float32))
    with jax.default_matmul_precision("highest"):
        f32 = np.asarray(tail_reference(jnp.asarray(x), *_jax_ops(ops)))
    out = cuda_tail.tail(torch.from_numpy(x).to(torch.bfloat16),
                         *_torch_ops(ops, torch.bfloat16))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == pallas.shape
    out = out.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(pallas).max())) - 7)
    assert np.abs(out - pallas).max() <= 4 * ulp
    assert np.abs(out - f32).max() <= np.abs(pallas - f32).max()


@pytest.mark.parametrize("ci,c", [(5, 12), (32, 16), (40, 20)])
def test_tail_bf16_kernel_operands_layout(rng, ci, c):
    """``pack_tail_weights`` lays the bf16 kernel's operands out as
    ``csrc/tail.cu`` reads them: K step (dy * 3 + dx) * groups + cg, row n,
    the bf16 weights of channels 16 cg ... for output n, the two halves of 8
    swapped in rows with n & 4 (the kernel's bank swizzle), zero past the
    real channels; fp holds BN0's and BN1's scale and shift per padded
    channel, then the head's bias."""
    k0, bn0, k1, bn1, kh, bh = _torch_ops(_weights(rng, ci, c))
    w0, w1, wh, fp = cuda_tail.pack_tail_weights(k0, bn0, k1, bn1, kh, bh)
    g0, g1 = -(-ci // 16), -(-c // 16)
    cp = 16 * g1
    assert w0.shape == (9 * g0, cp, 16) and w1.shape == (9 * g1, cp, 16)
    assert wh.shape == (9 * g1, 8, 16) and fp.shape == (4 * cp + 4,)
    assert {w0.dtype, w1.dtype, wh.dtype, fp.dtype} == {torch.bfloat16, torch.float32}
    for packed, k, groups, rows in ((w0, k0, g0, cp), (w1, k1, g1, cp), (wh, kh, g1, 8)):
        assert packed.is_contiguous()
        unswizzled = packed.clone()
        for n in range(rows):
            if n & 4:
                unswizzled[:, n] = torch.cat([packed[:, n, 8:], packed[:, n, :8]], dim=1)
        # [tap][cg][n][channel in group] -> HWIO
        back = unswizzled.reshape(3, 3, groups, rows, 16).permute(0, 1, 2, 4, 3)
        back = back.reshape(3, 3, 16 * groups, rows)
        assert torch.equal(back[:, :, :k.shape[2], :k.shape[3]], k.to(torch.bfloat16))
        assert not back[:, :, k.shape[2]:].any() and not back[:, :, :, k.shape[3]:].any()
    for i, v in enumerate((*cuda_tail.fold_bn(bn0), *cuda_tail.fold_bn(bn1))):
        assert torch.equal(fp[i * cp:i * cp + c], v) and not fp[i * cp + c:(i + 1) * cp].any()
    assert fp[4 * cp] == bh[0] and not fp[4 * cp + 1:].any()


@pytest.mark.parametrize("bad", ["rank", "k0", "k1", "head", "bn"])
def test_tail_rejects(rng, bad):
    x = torch.zeros(1, 4, 4, 8)
    k0, bn0, k1, bn1, kh, bh = _torch_ops(_weights(rng, 8, 8))
    if bad == "rank":
        x = x[0]
    elif bad == "k0":
        k0 = k0[:, :, :4]
    elif bad == "k1":
        k1 = k1[..., :4]
    elif bad == "head":
        kh = kh.expand(3, 3, 8, 2)
    else:
        bn1 = bn1[:3]
    with pytest.raises(ValueError):
        cuda_tail.tail(x, k0, bn0, k1, bn1, kh, bh)


def test_tail_has_no_fallback_off_the_cpu(rng):
    ops = _torch_ops(_weights(rng, 8, 8))
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cuda_tail.tail(torch.zeros(1, 4, 4, 8, device="meta"), *ops)


@pytest.fixture(scope="module")
def unet_pair():
    """The JAX plain UNet's variables carried into the port's UNet, with
    and without the fused tail."""
    jmodel = JaxUNet(encoder_variant="tiny")
    images = np.random.default_rng(5).random((2, 64, 96, 3), dtype=np.float32)
    variables = fast_init(jmodel, jnp.zeros((1, 64, 96, 3)), train=False, seed=2)
    variables = jax.tree.map(np.asarray, variables)
    base = PeopleSegmentationUNet("tiny").eval()
    fast = PeopleSegmentationUNet("tiny", pallas_tail=True).eval()
    load_jax_params(base, variables)
    load_jax_params(fast, variables)  # the same parameter names: no new leaf
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, jnp.asarray(images)))
    return base, fast, images, ref


def test_unet_tail_matches_plain_and_jax(unet_pair, monkeypatch):
    base, fast, images, ref = unet_pair
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    calls = []
    real = cuda_tail.tail
    monkeypatch.setattr(cuda_tail, "tail", lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        y_base = base(x)
        form, y_fast = fast(x, raw=True)
        y_chan = fast(x)
        form_base, y_raw = base(x, raw=True)
    assert calls == [torch.Size([2, 32, 48, 32])] * 2  # decoder3's output, viewed NHWC
    assert form == "dense" and tuple(y_fast.shape) == (2, 64, 96)
    assert form_base == "plain" and torch.equal(y_raw, y_base)
    assert torch.equal(y_chan[:, 0], y_fast) and tuple(y_chan.shape) == (2, 1, 64, 96)
    np.testing.assert_allclose(y_fast.numpy(), y_base[:, 0].numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y_fast.numpy(), ref[..., 0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("why", ["training", "nearest", "two_classes", "plain_version"])
def test_unet_tail_gate(unet_pair, monkeypatch, why):
    """The gate keeps what is semantic of the JAX one: eval mode, bilinear
    upsample, one class. Inside ``plain()`` the tail computes its plain
    version on any device (the comparison path on a GPU)."""
    base, fast, images, _ = unet_pair
    x = torch.from_numpy(images[:1]).permute(0, 3, 1, 2)
    calls = {"tail": 0, "plain": 0}
    real, real_plain = cuda_tail.tail, cuda_tail.tail_plain

    def spy(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(cuda_tail, "tail", spy("tail", real))
    monkeypatch.setattr(cuda_tail, "tail_plain", spy("plain", real_plain))
    if why == "training":
        model = PeopleSegmentationUNet("tiny", pallas_tail=True).train()
    elif why == "nearest":
        model = PeopleSegmentationUNet("tiny", pallas_tail=True, upsample_mode="nearest").eval()
    elif why == "two_classes":
        model = PeopleSegmentationUNet("tiny", pallas_tail=True, classes=2).eval()
    else:
        model = PeopleSegmentationUNet("tiny", pallas_tail=True).eval()
        model.load_state_dict(fast.state_dict())
    with torch.no_grad(), _build.plain() if why == "plain_version" else contextlib.nullcontext():
        form, y = model(x, raw=True)
    if why == "plain_version":
        assert form == "dense" and calls == {"tail": 1, "plain": 1}
        with torch.no_grad():
            assert torch.equal(y, fast(x, raw=True)[1])
    else:
        assert form == "plain" and calls == {"tail": 0, "plain": 0}


@pytest.fixture(scope="module")
def flagship_pair():
    jmodel = JaxSegmenter(encoder_variant="tiny", **TINY)
    variables = fast_init(jmodel, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 5)), train=False,
                          seed=3)
    rng = np.random.default_rng(4)
    # a trained-looking wrapper ([0.8, -0.6]), so the probe behind
    # person_prob is tested. Its bias stays 0: the dense branch crops the
    # one-channel map before the wrapper, so a bias would reach the crop's
    # out-of-image samples, which the plain branch zero-pads (in the JAX
    # package's dense branch too).
    wrapper = variables["params"]["unet_wrapper"]["output_conv"]
    wrapper["kernel"] = np.asarray(wrapper["kernel"]) * 0.7 + 0.1
    variables = jax.tree.map(np.asarray, variables)
    port = create_flagship(variant="tiny", device="cpu", seed=0, pallas_tail=True, **TINY)
    load_jax_params(port, variables)
    images = rng.random((2, 64, 96, 3), dtype=np.float32)
    return jmodel, variables, port, images


def test_flagship_dense_branch_matches_jax_plain_path(flagship_pair):
    jmodel, variables, port, images = flagship_pair
    with jax.default_matmul_precision("highest"):
        jinst, jbinary = JaxEngine(jmodel, variables, dilation_pixels=1)(images, ROIS)
        _, jaux = jax.jit(lambda v, x, r: jmodel.apply(v, x, r, train=False))(
            variables, jnp.asarray(images), jnp.asarray(ROIS))
    before = cuda_tail.tail.launches
    inst, binary = InferenceEngine(port, device="cpu", dilation_pixels=1)(images, ROIS)
    assert cuda_tail.tail.launches == before
    with torch.no_grad():
        _, aux = port(torch.from_numpy(images), torch.from_numpy(ROIS))
    assert set(aux) == set(jaux) | {"person_prob_dense"}
    assert tuple(aux["person_prob_dense"].shape) == (2, 64, 96)
    np.testing.assert_allclose(binary, np.asarray(jbinary), atol=1e-5)
    np.testing.assert_allclose(aux["person_prob_dense"].numpy()[..., None], np.asarray(jbinary),
                               atol=1e-5)
    for key in ("full_image_logits", "roi_bg_fg", "roi_patches"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]), atol=1e-4, rtol=1e-4,
                                   err_msg=key)
    assert inst.shape == (3, 32, 24, 1)
    assert float((inst == np.asarray(jinst)).mean()) >= 0.999


def test_person_prob_is_the_wrapper_softmax(flagship_pair, rng):
    """sigmoid((w0 - w1) x + (b0 - b1)) from the two-point probe equals
    softmax(wrapper(x))[channel 0] for any wrapper, bias included."""
    _, _, port, _ = flagship_pair
    model = create_flagship(variant="tiny", device="cpu", seed=0, pallas_tail=True, **TINY)
    with torch.no_grad():
        model.unet_wrapper.output_conv.weight.copy_(torch.tensor([0.9, -0.4]).reshape(2, 1, 1, 1))
        model.unet_wrapper.output_conv.bias.copy_(torch.tensor([0.3, -0.2]))
        x = torch.from_numpy(rng.standard_normal((2, 5, 7)).astype(np.float32) * 3)
        want = torch.softmax(model.unet_wrapper(x[:, None]), dim=1)[:, 0]
        np.testing.assert_allclose(model.person_prob(x).numpy(), want.numpy(), atol=1e-6)


def test_flagship_dense_branch_matches_its_plain_branch(flagship_pair, monkeypatch):
    _, _, port, images = flagship_pair
    plain = create_flagship(variant="tiny", device="cpu", seed=0, **TINY)
    plain.load_state_dict(port.state_dict())
    inst, binary = InferenceEngine(port, device="cpu",
                                   dilation_pixels=1, fused_head=True)(images, ROIS)
    inst_p, binary_p = InferenceEngine(plain, device="cpu",
                                       dilation_pixels=1, fused_head=True)(images, ROIS)
    np.testing.assert_allclose(binary, binary_p, atol=1e-5)
    assert float((inst == inst_p).mean()) >= 0.999
    # kernels=False serves the tail inside plain(), and leaves the caller's context alone
    routes = []
    real = cuda_tail.tail
    monkeypatch.setattr(cuda_tail, "tail",
                        lambda *a, **k: routes.append(_build._PLAIN.get()) or real(*a, **k))
    engine = InferenceEngine(port, device="cpu", dilation_pixels=1, kernels=False)
    engine(images, ROIS)
    assert routes == [True] and not _build._PLAIN.get()


def test_calibration_pass_takes_the_unfused_stage(flagship_pair):
    """As in the JAX package, a calibration pass runs the last stage
    unfused, so its convs' input ranges are recorded."""
    _, _, port, images = flagship_pair
    with torch.no_grad(), quant.calibration(port) as calib:
        _, aux = port(torch.from_numpy(images), torch.from_numpy(ROIS))
    scales = quant.collect_scales(calib)
    assert {"pretrained_unet/decoder4/conv0", "pretrained_unet/decoder4/conv1"} <= set(scales)
    assert "person_prob_dense" not in aux
    with torch.no_grad():
        assert "person_prob_dense" in port(torch.from_numpy(images), torch.from_numpy(ROIS))[1]


def test_int8_with_pallas_tail_raises(flagship_pair):
    """int8 serving of a ``pallas_tail`` model no longer raises: the engine
    calibrates the tail's three scales and ends stage 1 in the s8 fused tail
    (``tail_q``; its plain version here on the CPU), which stays close to the
    float tail's binary mask; the model does the same when the serving
    switches are set by hand, and takes the float tail while a scale is
    missing."""
    _, _, port, images = flagship_pair
    calls = []
    real_q, real_f = cuda_tail.tail_q, cuda_tail.tail
    _, binary_f = InferenceEngine(port, device="cpu", dilation_pixels=1)(images, ROIS)
    engine = InferenceEngine(port, device="cpu", dilation_pixels=1, quantize="int8")
    cuda_tail.tail_q = lambda *a, **k: (calls.append("q"), real_q(*a, **k))[1]
    cuda_tail.tail = lambda *a, **k: (calls.append("float"), real_f(*a, **k))[1]
    try:
        inst, binary = engine(images, ROIS)
        assert calls[0] == "q" and "person_prob_dense" not in engine.scales
        assert {"pretrained_unet/decoder4#x", "pretrained_unet/decoder4#mid",
                "pretrained_unet#head"} <= set(engine.scales)
        assert inst.shape == (3, 32, 24, 1) and binary.shape == (2, 64, 96, 1)
        assert np.abs(binary - binary_f).max() < 0.05
        # the model, with the switches set by hand
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        quant.set_int8_serving(port, True, engine.scales)
        with torch.no_grad():
            form, y_q = port.pretrained_unet(x, raw=True)
        assert form == "dense" and port.pretrained_unet.tail_scales is not None
        del calls[:]
        missing = {k: v for k, v in engine.scales.items() if k != "pretrained_unet#head"}
        quant.set_int8_serving(port, True, missing)
        with torch.no_grad():
            form, y_f = port.pretrained_unet(x, raw=True)
        assert form == "dense" and calls == ["float"]
        quant.set_int8_serving(port, False)
        with torch.no_grad():
            ref = port.pretrained_unet(x, raw=True)[1]
        assert port.pretrained_unet.tail_scales is None
        scale = float(ref.abs().max())
        assert float((y_f - ref).abs().max()) < 0.08 * scale  # the stages before it run s8
        assert float((y_q - ref).abs().max()) < 0.08 * scale  # tests/test_pallas_tail_q.py:116
    finally:
        cuda_tail.tail_q, cuda_tail.tail = real_q, real_f
        quant.set_int8_serving(port, False)
    # and int8 without the fused tail still serves
    plain = create_flagship(variant="tiny", device="cpu", seed=0, **TINY)
    InferenceEngine(plain, device="cpu", quantize="int8")
