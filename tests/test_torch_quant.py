"""The port's int8 quantization (ops/quant.py, ops/s2d.quantize_static) vs
the JAX package's ``ops/quant.py`` on the same numpy inputs (CPU).

Quantization and ``qconv2d`` are held bit for bit: same rounding (half to
even), same division or multiplication by the scale, an exact integer conv
and the same float32 epilogue. The CUDA kernel runs only on a GPU;
``chip_smoke.py`` holds it against :func:`qconv2d_plain` there with max abs
error 0.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu.ops import quant as jquant
from human_instance_segmentation_tpu.ops import s2d as js2d
from human_instance_segmentation_tpu_torch.ops import quant, s2d

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _with_ties(rng, shape, scale):
    """Normal values, a quarter of them moved onto exact half-steps of the
    scale (where half-to-even and half-away-from-zero differ) and a few far
    past the clip."""
    x = (rng.standard_normal(shape) * 40 * scale).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 4, replace=False)
    flat[idx] = (np.floor(flat[idx] / scale) + 0.5) * np.float32(scale)
    flat[:3] = [500 * scale, -500 * scale, 0.0]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.0625, 0.013, 1.7])
def test_quantize_symmetric_and_static_bitwise(rng, dtype, scale):
    jx, tx = _pair(_with_ties(rng, (3, 5, 7, 6), scale), dtype)
    np.testing.assert_array_equal(
        quant.quantize_symmetric(tx, scale).numpy(),
        np.asarray(jquant.quantize_symmetric(jx, jnp.float32(scale))))
    np.testing.assert_array_equal(s2d.quantize_static(tx, scale).numpy(),
                                  np.asarray(js2d.quantize_static(jx, scale)))


def test_quantize_weight_matches_jax(rng):
    w = rng.standard_normal((3, 3, 10, 7)).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    wq, sw = quant.quantize_weight(torch.from_numpy(w))
    jsw = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(w)), axis=(0, 1, 2)), 1e-8) / 127.0
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(wq.numpy(),
                                  np.asarray(jquant.quantize_symmetric(jnp.asarray(w), jsw)))


# (Ci, Co, k): the ragged widths of the slice, scaled down: the combiner's
# 258 -> 256 (here -> 16), the 2-channel logit heads, a 1-channel head, the
# decoder's skip concatenations (34 = 32 + 2) and a 16-channel 3x3.
SHAPES = [(258, 16, 1), (48, 2, 1), (64, 1, 1), (34, 16, 3), (16, 16, 3), (20, 5, 3)]


@pytest.mark.parametrize("ci,co,k", SHAPES)
@pytest.mark.parametrize("mode", ["static", "dynamic", "int8_input"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qconv2d_bitwise(rng, ci, co, k, mode, dtype):
    x = rng.standard_normal((2, 6, 5, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)
    sx = float(np.abs(x).max() / 127.0 * 0.8)  # some values clip
    pad = k // 2
    jw, tw = _pair(w, dtype)
    if mode == "int8_input":
        xq = np.array(js2d.quantize_static(jnp.asarray(x), sx))
        jx, tx = jnp.asarray(xq), torch.from_numpy(xq)
    else:
        jx, tx = _pair(x, dtype)
    static = None if mode == "dynamic" else sx
    with jax.default_matmul_precision("highest"):
        ref = jquant.qconv2d(jx, jw, (1, 1), ((pad, pad), (pad, pad)), static_scale=static)
    before = quant.qconv2d.launches
    out = quant.qconv2d(tx, tw, 1, pad, static_scale=static)
    assert quant.qconv2d.launches == before  # CPU tensors take the plain version
    assert out.dtype == DTYPES[dtype][1] and out.shape == ref.shape
    np.testing.assert_array_equal(_np(out), _jnp(ref))
    np.testing.assert_array_equal(_np(quant.qconv2d_plain(tx, tw, 1, pad, static)), _jnp(ref))


def test_int8_input_needs_scale(rng):
    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        quant.qconv2d(xq, torch.ones((1, 1, 8, 4)), 1, 0)


def test_s8_matmul_plain_exact(rng):
    ones = torch.ones((256, 256), dtype=torch.int8)
    assert bool((quant.s8_matmul(ones, ones) == 256).all())
    a = rng.integers(-127, 128, (64, 3000), dtype=np.int8)
    b = rng.integers(-127, 128, (3000, 48), dtype=np.int8)
    got = quant.s8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(TypeError):
        quant.s8_matmul(ones.float(), ones)


@pytest.mark.parametrize("k", [1, 3])
def test_s8_conv_plain_is_exact_where_float32_is_not(rng, k):
    """Products summed over 9 * 384 taps exceed 2^24: float32 rounds them,
    the float64 accumulation does not."""
    xq = np.full((1, 4, 4, 384), 127, np.int8)
    wq = np.full((k, k, 384, 2), 127, np.int8)
    wq[..., 1] = -127
    got = quant.s8_conv_plain(torch.from_numpy(xq), torch.from_numpy(wq), padding=k // 2)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.abs().max()) == k * k * 384 * 127 * 127


@pytest.mark.parametrize("dtype,ci,row", [("int8", 32, 32), ("int8", 258, 272),
                                          ("float32", 48, 48), ("bfloat16", 2, 16)])
def test_staging_buffer_size(dtype, ci, row):
    """The kernel quantizes (or copies) its input once into N*H*W rows of
    Ci rounded up to 16 int8 codes, so every row is 16-byte aligned."""
    td = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ws = quant.staging_buffer(torch.zeros((2, 3, 5, ci), dtype=td))
    assert ws.dtype == torch.int8 and ws.numel() == 2 * 3 * 5 * row


@pytest.mark.parametrize("mode", ["float", "int8_input"])
def test_plain_int8_outputs_are_contiguous_nhwc(rng, mode):
    """The plain s8 conv returns the kernel's layout (contiguous NHWC), so
    the plain path feeds the same memory layout to every later op."""
    x = rng.standard_normal((2, 6, 5, 24)).astype(np.float32)
    w = rng.standard_normal((3, 3, 24, 8)).astype(np.float32)
    tx = torch.from_numpy(x)
    if mode == "int8_input":
        tx = quant.quantize_symmetric(tx, 0.05)
    out = quant.qconv2d_plain(tx, torch.from_numpy(w), 1, 1, 0.05)
    assert out.shape == (2, 6, 5, 8) and out.is_contiguous()
    acc = quant.s8_conv_plain(quant.quantize_symmetric(torch.from_numpy(x), 0.05),
                              quant.quantize_weight(torch.from_numpy(w))[0], padding=1)
    assert acc.dtype == torch.int32 and acc.is_contiguous()


def _qconv_pair(rng, ci, co, k, bias=True):
    tconv = quant.QConv(ci, co, k, padding=k // 2, bias=bias)
    jconv = jquant.QConv(co, (k, k), padding=k // 2, use_bias=bias)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(
            (rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)).astype(np.float32)))
        if bias:
            tconv.bias.copy_(torch.from_numpy(rng.standard_normal(co).astype(np.float32)))
    params = {"kernel": jnp.asarray(tconv.weight.detach().numpy().transpose(2, 3, 1, 0))}
    if bias:
        params["bias"] = jnp.asarray(tconv.bias.detach().numpy())
    return tconv, jconv, {"params": params}


def _run_t(conv, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def test_qconv_disabled_equals_conv2d(rng):
    tconv, _, _ = _qconv_pair(rng, 7, 5, 3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, 11)).astype(np.float32))
    plain = torch.nn.Conv2d(7, 5, 3, padding=1)
    plain.load_state_dict(tconv.state_dict())
    with torch.no_grad():
        np.testing.assert_array_equal(tconv(x).numpy(), plain(x).numpy())
        quant.set_int8_serving(tconv, True, deny=("",))  # denied: still exact
        np.testing.assert_array_equal(tconv(x).numpy(), plain(x).numpy())
    assert set(tconv.state_dict()) == {"weight", "bias"}


@pytest.mark.parametrize("ci,co,k,static", [(32, 16, 3, True), (32, 16, 3, False),
                                            (64, 2, 1, True), (96, 8, 1, False)])
def test_qconv_module_matches_jax(rng, ci, co, k, static):
    tconv, jconv, variables = _qconv_pair(rng, ci, co, k)
    x = rng.standard_normal((2, 8, 6, ci)).astype(np.float32)
    scales = {"": float(np.abs(x).max() / 127.0)} if static else None
    with jax.default_matmul_precision("highest"), jquant.int8_serving(True, scales):
        ref = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    quant.set_int8_serving(tconv, True, scales)
    assert tconv.runs_int8
    np.testing.assert_array_equal(_run_t(tconv, x), ref)
    with jax.default_matmul_precision("highest"):
        exact = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    assert np.abs(ref - exact).max() > 0  # the int8 path really ran


def test_qconv_keeps_quantized_weight_until_it_changes(rng):
    """QConv quantizes its weight once (JAX does so once per trace) and
    again after the weight changes or is asked for in another dtype."""
    tconv, _, _ = _qconv_pair(rng, 32, 16, 3)
    quant.set_int8_serving(tconv, True, {"": 0.05})
    x = rng.standard_normal((1, 6, 5, 32)).astype(np.float32)

    def fresh(dtype=torch.float32):
        hwio = tconv.weight.detach().to(dtype).permute(2, 3, 1, 0).contiguous()
        return quant.quantize_weight(hwio)

    def expected():
        y = quant.qconv2d_plain(torch.from_numpy(x), tconv.weight.detach().permute(2, 3, 1, 0),
                                1, 1, 0.05)
        return (y + tconv.bias.detach()).numpy()

    first = tconv.quantized_weight(torch.float32)
    assert tconv.quantized_weight(torch.float32) is first
    np.testing.assert_array_equal(_run_t(tconv, x), expected())
    tconv.load_state_dict({k: v * -2.0 for k, v in tconv.state_dict().items()})
    again = tconv.quantized_weight(torch.float32)
    assert again is not first
    for got, want in zip(again, fresh()):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(_run_t(tconv, x), expected())
    for got, want in zip(tconv.quantized_weight(torch.bfloat16), fresh(torch.bfloat16)):
        assert torch.equal(got, want)
    with torch.inference_mode():  # weights with no version counter are not kept
        made = quant.QConv(32, 16, 3, padding=1)
        made.load_state_dict(tconv.state_dict())
        quant.set_int8_serving(made, True, {"": 0.05})
        out = made(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), expected())


def test_qconv_small_contraction_skipped(rng):
    tconv, jconv, variables = _qconv_pair(rng, 2, 4, 1)  # 1 * 1 * 2 < 48
    quant.set_int8_serving(tconv, True)
    assert not tconv.eligible and not tconv.runs_int8
    x = rng.standard_normal((1, 8, 8, 2)).astype(np.float32)
    with jquant.int8_serving(True):
        ref = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_run_t(tconv, x), ref, rtol=1e-6, atol=1e-6)
    plain = torch.nn.Conv2d(2, 4, 1)
    plain.load_state_dict(tconv.state_dict())
    np.testing.assert_array_equal(_run_t(tconv, x), _run_t(plain, x))  # exactly nn.Conv2d
    # 3x3 over 5 channels (45) is below the threshold too; 3x3 over 6 is not
    assert not quant.QConv(5, 4, 3).eligible and quant.QConv(6, 4, 3).eligible


class _JaxWrap(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        a = jquant.QConv(16, (3, 3), padding=1, name="encoder_conv")(x)
        b = jquant.QConv(16, (3, 3), padding=1, name="head_conv")(x)
        return a, b


class _TorchWrap(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder_conv = quant.QConv(32, 16, 3, padding=1)
        self.head_conv = quant.QConv(32, 16, 3, padding=1)

    def forward(self, x):
        return self.encoder_conv(x), self.head_conv(x)


def test_denylist_and_calibration_keys(rng):
    """Denied paths stay exact; calibration records every eligible QConv,
    denied or not, under the JAX module path, and the scales agree."""
    x = rng.standard_normal((1, 8, 8, 32)).astype(np.float32)
    jm = _JaxWrap()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _TorchWrap()
    for name in ("encoder_conv", "head_conv"):
        conv = getattr(tm, name)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(
                np.asarray(v["params"][name]["kernel"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(np.asarray(v["params"][name]["bias"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        exact = [t.numpy() for t in tm(xt)]
        quant.set_int8_serving(tm, True, deny=("encoder_",))
        assert tm.encoder_conv.denied and not tm.head_conv.denied
        a, b = tm(xt)
    np.testing.assert_array_equal(a.numpy(), exact[0])
    assert float((b - torch.from_numpy(exact[1])).abs().max()) > 0
    with jax.default_matmul_precision("highest"), jquant.int8_serving(True, deny=("encoder_",)):
        ja, jb = jm.apply(v, jnp.asarray(x))
    np.testing.assert_array_equal(b.permute(0, 2, 3, 1).numpy(), np.asarray(jb))

    with jquant.calibration():
        _, cv = jm.apply(v, jnp.asarray(x), mutable=["calib"])
    jscales = jquant.collect_scales(jax.tree.map(float, cv["calib"]))
    quant.set_int8_serving(tm, False)
    with torch.no_grad(), quant.calibration(tm) as calib:
        tm(xt)
    scales = quant.collect_scales(calib)
    assert set(scales) == set(jscales) == {"encoder_conv", "head_conv"}
    for key in scales:
        assert scales[key] == pytest.approx(jscales[key], rel=1e-6)
    assert all(m.calib_amax is None for m in (tm.encoder_conv, tm.head_conv))


def test_collect_and_merge_scales():
    tree = {"a": {"conv": {"amax": (1.0, 3.0)}},
            "b": {"amax_mid": 0.5, "amax": 0.0},
            "c": {"d": {"amax": 254.0}}}
    for margin in (1.0, 1.1):
        assert quant.collect_scales(tree, margin) == jquant.collect_scales(tree, margin)
    got = quant.collect_scales(tree)
    assert got["a/conv"] == 3.0 / 127.0 and got["b"] == 1e-6 / 127.0
    assert got["b#mid"] == 0.5 / 127.0 and got["c/d"] == 2.0
    a, b = {"x": 0.1, "y": 0.5}, {"x": 0.3, "z": 0.2}
    assert quant.merge_scales(a, b) == jquant.merge_scales(a, b) == {"x": 0.3, "y": 0.5, "z": 0.2}


def test_cuda_paths_refuse_other_devices():
    x = torch.zeros((1, 4, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        quant.qconv2d(x, torch.zeros((1, 1, 8, 4), device="meta"), 1, 0, 0.1)
    with pytest.raises(RuntimeError, match="no kernel"):
        quant.s8_matmul(torch.zeros((4, 8), dtype=torch.int8, device="meta"),
                        torch.zeros((8, 4), dtype=torch.int8, device="meta"))
