"""The port's fused MBConv (ops/cuda_mbconv.py) and its wiring
(``MBConv(fused=True)``, ``EfficientNetEncoder(fused_blocks=N)``) vs the JAX
package, on the same numpy inputs and carried weights (CPU, float32).

The JAX Pallas kernel runs in interpret mode, as tests/test_pallas_mbconv.py
runs it, at that file's five cases. On the CPU the port's wrapper takes the
kernel's plain version; the CUDA kernel is held against it on a GPU by
``chip_smoke.py``. Tolerance: atol 2e-5, the JAX package's own gate for its
kernel against its plain block (tests/test_pallas_mbconv.py:48); both sides
sum in float32 in different orders.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.models.efficientnet import (
    EfficientNetEncoder as JaxEncoder, MBConv as JaxMBConv)
from human_instance_segmentation_tpu.ops.pallas_mbconv import fold_bn as jax_fold_bn
from human_instance_segmentation_tpu.ops.pallas_mbconv import fused_mbconv_chw
from human_instance_segmentation_tpu_torch.inference import InferenceEngine, create_flagship
from human_instance_segmentation_tpu_torch.models.efficientnet import EfficientNetEncoder, MBConv
from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet
from human_instance_segmentation_tpu_torch.ops import cuda_mbconv
from human_instance_segmentation_tpu_torch.weights import load_jax_params

ATOL = 2e-5
# tests/test_pallas_mbconv.py:19-25; shape is the NHWC input
CASES = [
    dict(out_channels=16, expand_ratio=1, kernel=3, stride=1, shape=(2, 48, 32, 16)),
    dict(out_channels=24, expand_ratio=6, kernel=3, stride=2, shape=(2, 48, 32, 16)),
    dict(out_channels=24, expand_ratio=6, kernel=3, stride=1, shape=(2, 16, 16, 24)),
    dict(out_channels=40, expand_ratio=6, kernel=5, stride=2, shape=(2, 48, 64, 24)),
    dict(out_channels=40, expand_ratio=6, kernel=5, stride=1, shape=(2, 48, 64, 40)),
]
IDS = [f"k{c['kernel']}s{c['stride']}e{c['expand_ratio']}" for c in CASES]


def _jax_block(case, seed=0):
    """The JAX plain block's variables with randomized BN statistics (so the
    fold is exercised), as numpy, and the NHWC input."""
    case = dict(case)
    shape = case.pop("shape")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    plain = JaxMBConv(**case, fused=False)
    v = plain.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    fl = flax.traverse_util.flatten_dict(v)
    for k in fl:
        if k[-1] == "mean":
            fl[k] = jnp.asarray(rng.standard_normal(fl[k].shape) * 0.1, jnp.float32)
        if k[-1] == "var":
            fl[k] = jnp.asarray(np.abs(rng.standard_normal(fl[k].shape)) + 0.5, jnp.float32)
        if k[-1] in ("scale", "bias") and k[-2].startswith("bn"):
            fl[k] = jnp.asarray(1 + rng.standard_normal(fl[k].shape) * 0.1, jnp.float32)
    v = flax.traverse_util.unflatten_dict(fl)
    return case, x, v


def _port_block(case, x, variables, fused):
    block = MBConv(x.shape[-1], case["out_channels"], case["expand_ratio"], case["kernel"],
                   case["stride"], fused=fused).eval()
    load_jax_params(block, jax.tree.map(np.asarray, variables))
    return block


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mbconv_fused_and_plain_match_jax(case):
    case, x, v = _jax_block(case)
    with jax.default_matmul_precision("highest"):
        j_plain = np.asarray(JaxMBConv(**case, fused=False).apply(v, jnp.asarray(x), train=False))
        j_fused = np.asarray(JaxMBConv(**case, fused=True).apply(v, jnp.asarray(x), train=False))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    before = cuda_mbconv.mbconv_sums.launches, cuda_mbconv.mbconv_apply.launches
    with torch.no_grad():
        t_plain = _port_block(case, x, v, False)(xt).permute(0, 2, 3, 1).numpy()
        t_fused = _port_block(case, x, v, True)(xt).permute(0, 2, 3, 1).numpy()
    # CPU tensors take the plain versions
    assert before == (cuda_mbconv.mbconv_sums.launches, cuda_mbconv.mbconv_apply.launches)
    assert t_fused.shape == j_fused.shape == j_plain.shape
    np.testing.assert_allclose(t_plain, j_plain, atol=ATOL)
    np.testing.assert_allclose(t_fused, j_fused, atol=ATOL)
    np.testing.assert_allclose(t_fused, t_plain, atol=ATOL)


def _folded(case, x, v):
    """The folded operands as the JAX block's ``_fused`` makes them
    (models/efficientnet.py:260-289), numpy float32."""
    p, s = v["params"], v["batch_stats"]
    f = np.float32

    def bn(name):
        g, b = jax_fold_bn(p[name]["scale"], p[name]["bias"], s[name]["mean"], s[name]["var"])
        return np.asarray(g, f), np.asarray(b, f)

    we = be = None
    if case["expand_ratio"] != 1:
        g0, b0 = bn("bn0")
        we, be = np.asarray(p["expand_conv"]["kernel"], f)[0, 0] * g0[None], b0
    g1, b1 = bn("bn1")
    g2, b2 = bn("bn2")
    se = p["se"]
    return [we, be, np.asarray(p["dw_conv"]["kernel"], f)[:, :, 0] * g1[None, None], b1,
            np.asarray(se["reduce"]["kernel"], f)[0, 0], np.asarray(se["reduce"]["bias"], f),
            np.asarray(se["expand"]["kernel"], f)[0, 0], np.asarray(se["expand"]["bias"], f),
            np.asarray(p["project_conv"]["kernel"], f)[0, 0] * g2[None], b2]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_mbconv_plain_matches_the_pallas_kernel(case):
    """``fused_mbconv_plain`` against ``fused_mbconv_chw(interpret=True)``
    directly, on the same folded operands, and the two passes on their own."""
    case, x, v = _jax_block(case, seed=3)
    ops = _folded(case, x, v)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    k, s = case["kernel"], case["stride"]
    residual = s == 1 and x.shape[-1] == case["out_channels"]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(fused_mbconv_chw(
            jnp.asarray(xc), *[None if o is None else jnp.asarray(o) for o in ops], kernel=k,
            stride=s, residual=residual, interpret=True))
    tops = [None if o is None else torch.from_numpy(np.ascontiguousarray(o)) for o in ops]
    xt = torch.from_numpy(xc)
    out = cuda_mbconv.fused_mbconv_plain(xt, *tops, kernel=k, stride=s, residual=residual)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # the dispatching wrapper and its two passes give the same on the CPU
    assert torch.equal(cuda_mbconv.fused_mbconv(xt, *tops, kernel=k, stride=s, residual=residual),
                       out)
    we, be, wdw, bdw, wr, br, ws, bs, wp, bp = tops
    sums = cuda_mbconv.mbconv_sums(xt, we, be, wdw, bdw, k, s)
    count = (x.shape[1] // s) * (x.shape[2] // s)
    se = cuda_mbconv.squeeze_excite(sums, count, wr, br, ws, bs, torch.float32)
    assert tuple(sums.shape) == (2, wdw.shape[2]) and bool(((se > 0) & (se < 1)).all())
    assert torch.equal(cuda_mbconv.mbconv_apply(xt, se, we, be, wdw, bdw, wp, bp, k, s, residual),
                       out)


def test_fused_mbconv_stride2_is_the_same_conv(rng):
    """Keeping positions [1::2, 1::2] of the stride-1 map is the TF-SAME
    stride-2 depthwise conv for even extents (k3 pads (0, 1), k5 (1, 2))."""
    for k in (3, 5):
        x = torch.from_numpy(rng.standard_normal((1, 6, 8, 12)).astype(np.float32))
        wdw = torch.from_numpy(rng.standard_normal((k, k, 6)).astype(np.float32))
        bdw = torch.zeros(6)
        full = cuda_mbconv._expand_dw_plain(x, None, None, wdw, bdw, k, 1)
        kept = cuda_mbconv._expand_dw_plain(x, None, None, wdw, bdw, k, 2)
        np.testing.assert_allclose(kept.numpy(), full[:, :, 1::2, 1::2].numpy(), atol=1e-6)


def test_fused_mbconv_bf16_rounding_rule(rng):
    """In bfloat16 the operands are widened and the sums are float32; the
    result lies within bf16 rounding of the float32 result of the same
    (bf16-valued) operands."""
    case, x, v = _jax_block(CASES[2], seed=4)
    ops = _folded(case, x, v)
    t16 = [None if o is None else torch.from_numpy(np.ascontiguousarray(o)).to(torch.bfloat16)
           for o in ops]
    x16 = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)
    out = cuda_mbconv.fused_mbconv(x16, *t16, kernel=3, stride=1, residual=True)
    ref = cuda_mbconv.fused_mbconv_plain(x16.float(), *[None if o is None else o.float()
                                                         for o in t16],
                                         kernel=3, stride=1, residual=True)
    assert out.dtype == torch.bfloat16
    diff = (out.float() - ref).abs()
    assert bool((diff <= 3e-2 + 2.0 ** -6 * ref.abs()).all()), float(diff.max())


@pytest.mark.parametrize("bad", ["rank", "kernel", "odd", "we", "residual", "no_expand"])
def test_fused_mbconv_rejects(rng, bad):
    x = torch.zeros(1, 4, 6, 8)
    we, be = torch.zeros(4, 8), torch.zeros(8)
    wdw, bdw = torch.zeros(3, 3, 8), torch.zeros(8)
    wr, br, ws, bs = torch.zeros(8, 1), torch.zeros(1), torch.zeros(1, 8), torch.zeros(8)
    wp, bp = torch.zeros(8, 4), torch.zeros(4)
    kw = dict(kernel=3, stride=1, residual=False)
    if bad == "rank":
        x = x[0]
    elif bad == "kernel":
        kw["kernel"] = 7
    elif bad == "odd":
        x, kw["stride"] = torch.zeros(1, 4, 5, 8), 2
    elif bad == "we":
        we = torch.zeros(3, 8)
    elif bad == "residual":
        wp, bp, kw["residual"] = torch.zeros(8, 5), torch.zeros(5), True
    else:
        we = be = None  # Cm 8 != Ci 4
    with pytest.raises(ValueError):
        cuda_mbconv.fused_mbconv(x, we, be, wdw, bdw, wr, br, ws, bs, wp, bp, **kw)


def test_fused_mbconv_has_no_fallback_off_the_cpu():
    x = torch.zeros(1, 4, 6, 8, device="meta")
    wdw, bdw = torch.zeros(3, 3, 4, device="meta"), torch.zeros(4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cuda_mbconv.mbconv_sums(x, None, None, wdw, bdw)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cuda_mbconv.mbconv_apply(x, torch.zeros(1, 4, device="meta"), None, None, wdw, bdw,
                                 torch.zeros(4, 4, device="meta"), torch.zeros(4, device="meta"))


def test_fused_is_ignored_in_training_mode(monkeypatch):
    """Training mode ignores the flag (batch statistics), as in the JAX
    block; the folded operands are made once and made anew after a weight
    changes."""
    calls = []
    real = cuda_mbconv.fused_mbconv
    monkeypatch.setattr(cuda_mbconv, "fused_mbconv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    block = MBConv(24, 24, 6, 3, 1, fused=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 24, 16, 16))
                         .astype(np.float32))
    block.train()
    assert tuple(block(x).shape) == (2, 24, 16, 16) and not calls
    block.eval()
    with torch.no_grad():
        y = block(x)
        ops = block._folded(torch.float32)
        assert calls == [1] and block._folded(torch.float32) is ops
        block.project_conv.weight.mul_(2.0)
        assert block._folded(torch.float32) is not ops
        assert not torch.allclose(block(x), y)
        block.use_kernel = False  # the plain version, named explicitly
        assert len(calls) == 2 and torch.isfinite(block(x)).all() and len(calls) == 2


@pytest.fixture(scope="module")
def encoder_pair():
    """The JAX B0 encoder's variables carried into the port's, 64x96."""
    jmodel = JaxEncoder(variant="b0")
    x = np.random.default_rng(7).standard_normal((1, 64, 96, 3)).astype(np.float32)
    variables = fast_init(jmodel, jnp.zeros((1, 64, 96, 3)), train=False, seed=3)
    variables = jax.tree.map(np.asarray, variables)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    return variables, x, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("n", [3, 6])
def test_encoder_fused_blocks_match_unfused_and_jax(encoder_pair, n):
    variables, x, ref = encoder_pair
    base = load_jax_params(EfficientNetEncoder("b0").eval(), variables)
    fused = load_jax_params(EfficientNetEncoder("b0", fused_blocks=n).eval(), variables)
    blocks = [m for m in fused.modules() if isinstance(m, MBConv)]
    assert [m.fused for m in blocks] == [i < n for i in range(len(blocks))]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        want, got = base(xt), fused(xt)
    assert len(got) == len(want) == len(ref) == 5
    for g, w, r in zip(got, want, ref):
        scale = max(float(np.abs(r).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL * scale)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, atol=1e-4 * scale)


def test_unet_hands_encoder_fused_blocks_down():
    unet = PeopleSegmentationUNet("tiny", encoder_fused_blocks=2)
    blocks = [m for m in unet.encoder.modules() if isinstance(m, MBConv)]
    assert [m.fused for m in blocks] == [True, True] + [False] * (len(blocks) - 2)
    unet.encoder.set_fused_kernels(False)
    assert not any(m.use_kernel for m in blocks)
    x = torch.from_numpy(np.random.default_rng(2).random((1, 3, 32, 32)).astype(np.float32))
    plain = PeopleSegmentationUNet("tiny")
    plain.load_state_dict(unet.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(unet.eval()(x).numpy(), plain.eval()(x).numpy(), atol=ATOL)
    # training mode runs every block unfused
    assert unet.train()(x).shape == plain.train()(x).shape


def test_fused_mbconv_takes_any_memory_format(rng):
    """x is read through its strides: a channels-last tensor (what the served
    encoder hands over) gives the same result as a contiguous one."""
    case, x, v = _jax_block(CASES[1], seed=5)
    tops = [None if o is None else torch.from_numpy(np.ascontiguousarray(o))
            for o in _folded(case, x, v)]
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    want = cuda_mbconv.fused_mbconv(xt, *tops, kernel=3, stride=2)
    view = torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC memory, NCHW view
    assert view.is_contiguous(memory_format=torch.channels_last) and not view.is_contiguous()
    np.testing.assert_allclose(cuda_mbconv.fused_mbconv(view, *tops, kernel=3, stride=2).numpy(),
                               want.numpy(), atol=1e-6)


def test_flagship_serves_encoder_fused_blocks():
    """``create_flagship(encoder_fused_blocks=N)`` reaches the encoder, the
    engine's ``kernels=False`` reaches the blocks' plain version, and the
    flag changes the route, not the result."""
    tiny = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32,
                base_channels=64)
    rng = np.random.default_rng(3)
    images = rng.random((2, 64, 96, 3), dtype=np.float32)
    rois = np.asarray([[0.0, 0.1, 0.2, 0.7, 0.9], [1.0, 0.0, 0.0, 1.0, 1.0]], np.float32)
    fused = create_flagship(variant="tiny", device="cpu", seed=0, encoder_fused_blocks=3, **tiny)
    plain = create_flagship(variant="tiny", device="cpu", seed=0, **tiny)
    blocks = [m for m in fused.pretrained_unet.encoder.modules() if isinstance(m, MBConv)]
    assert sum(m.fused for m in blocks) == 3
    assert fused.state_dict().keys() == plain.state_dict().keys()
    engine = InferenceEngine(fused, device="cpu", dilation_pixels=1, kernels=False)
    inst, binary = engine(images, rois)
    served = [m for m in engine.model.pretrained_unet.encoder.modules() if isinstance(m, MBConv)]
    assert not any(m.use_kernel for m in served) and all(m.use_kernel for m in blocks)
    engine_k = InferenceEngine(fused, device="cpu", dilation_pixels=1)
    inst_k, binary_k = engine_k(images, rois)
    assert all(m.use_kernel for m in engine_k.model.pretrained_unet.encoder.modules()
               if isinstance(m, MBConv))
    inst_p, binary_p = InferenceEngine(plain, device="cpu", dilation_pixels=1)(images, rois)
    np.testing.assert_allclose(binary, binary_p, atol=1e-5)
    np.testing.assert_array_equal(binary, binary_k)
    assert float((inst == inst_p).mean()) >= 0.999 and np.array_equal(inst, inst_k)
