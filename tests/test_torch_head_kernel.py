"""The port's conv + LayerNorm2d + ReLU unit (ops/cuda_head.py) and its
block wiring vs the JAX package's Pallas ``conv_ln_act`` (interpreted on
the CPU) and blocks, plus the kernel build's refusal to fall back.

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against :func:`conv_ln_act_plain` there.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu.models import blocks as jblocks
from human_instance_segmentation_tpu.ops import pallas_head
from human_instance_segmentation_tpu.ops import quant as jquant
from human_instance_segmentation_tpu.ops.pallas_head import head_fusion
from human_instance_segmentation_tpu_torch.models import blocks
from human_instance_segmentation_tpu_torch.ops import _build, cuda_head, quant
from human_instance_segmentation_tpu_torch.weights import load_jax_params

ATOL = 1e-5


def _operands(rng, n=2, h=4, w=3, ci=8, co=8, k=3):
    return dict(
        x=rng.standard_normal((n, h, w, ci)).astype(np.float32),
        w=(rng.standard_normal((k, k, ci, co)) * 0.2).astype(np.float32),
        b=(rng.standard_normal(co) * 0.1).astype(np.float32),
        g=(1 + rng.standard_normal(co) * 0.2).astype(np.float32),
        beta=(rng.standard_normal(co) * 0.1).astype(np.float32),
        res=rng.standard_normal((n, h, w, co)).astype(np.float32),
    )


@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("wrapper", ["plain", "dispatch"])
def test_conv_ln_act_matches_pallas(rng, kernel, residual, wrapper):
    o = _operands(rng, k=kernel)
    res = o["res"] if residual else None
    with jax.default_matmul_precision("highest"):
        ref = pallas_head.conv_ln_act(
            *(jnp.asarray(o[k]) for k in ("x", "w", "b", "g", "beta")),
            None if res is None else jnp.asarray(res), height=4, width=3, kernel=kernel)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    args = (t["x"], t["w"], t["b"], t["g"], t["beta"], t["res"] if residual else None)
    before = cuda_head.conv_ln_act.launches
    if wrapper == "plain":
        out = cuda_head.conv_ln_act_plain(*args, kernel=kernel)
    else:
        out = cuda_head.conv_ln_act(*args, height=4, width=3, kernel=kernel)
    assert cuda_head.conv_ln_act.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("wrapper", ["plain", "dispatch"])
def test_conv_ln_act_int8_matches_pallas(rng, kernel, residual, wrapper):
    """The int8 form (xscale) vs the interpreted Pallas kernel in float32:
    same quantized operands, an exact integer conv, the same dequant; the
    LayerNorm sums differ only in order."""
    o = _operands(rng, k=kernel)
    res = o["res"] if residual else None
    xs = float(np.abs(o["x"]).max() / 127.0 * 0.9)
    with jax.default_matmul_precision("highest"):
        ref = pallas_head.conv_ln_act(
            *(jnp.asarray(o[k]) for k in ("x", "w", "b", "g", "beta")),
            None if res is None else jnp.asarray(res), height=4, width=3, kernel=kernel,
            xscale=xs)
        exact = pallas_head.conv_ln_act(
            *(jnp.asarray(o[k]) for k in ("x", "w", "b", "g", "beta")),
            None if res is None else jnp.asarray(res), height=4, width=3, kernel=kernel)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    args = (t["x"], t["w"], t["b"], t["g"], t["beta"], t["res"] if residual else None)
    before = cuda_head.conv_ln_act_s8.launches
    if wrapper == "plain":
        out = cuda_head.conv_ln_act_plain(*args, kernel=kernel, xscale=xs)
    else:
        out = cuda_head.conv_ln_act(*args, height=4, width=3, kernel=kernel, xscale=xs)
    assert cuda_head.conv_ln_act_s8.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert np.abs(np.asarray(ref) - np.asarray(exact)).max() > 1e-4  # int8 really ran


@pytest.mark.parametrize("residual", [False, True])
def test_conv_ln_act_plain_is_order_independent(rng, residual):
    """The LayerNorm statistics are float64 sums rounded once, so the order
    of the ROI's pixels does not change a bit of the result (the CUDA kernel
    sums in another order and must agree bit for bit). With k=1 each pixel's
    conv is its own, so permuting pixels permutes the output exactly."""
    o = _operands(rng, n=2, h=16, w=12, ci=32, co=48, k=1)
    xs = float(np.abs(o["x"]).max() / 127.0)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    perm = torch.from_numpy(rng.permutation(16 * 12))

    def shuffle(a):
        return a.reshape(2, 16 * 12, -1)[:, perm].reshape(2, 1, 16 * 12, -1).contiguous()

    res = t["res"] if residual else None
    out = cuda_head.conv_ln_act_plain(t["x"], t["w"], t["b"], t["g"], t["beta"], res, kernel=1,
                                      xscale=xs)
    moved = cuda_head.conv_ln_act_plain(shuffle(t["x"]), t["w"], t["b"], t["g"], t["beta"],
                                        None if res is None else shuffle(res), kernel=1,
                                        xscale=xs)
    assert out.is_contiguous()
    assert torch.equal(moved, shuffle(out))


@pytest.mark.parametrize("block", ["cna3", "cna1", "res"])
@pytest.mark.parametrize("scaled", ["calibrated", "uncalibrated"])
def test_block_int8_gate_and_parity(rng, monkeypatch, block, scaled):
    """Under int8 serving a fusable block takes the fused unit's int8 form
    when its convs have calibrated scales, and the unfused QConv path
    (dynamic scales) when they do not, as in the JAX blocks; both match."""
    c = 256
    x = rng.standard_normal((2, 4, 3, c)).astype(np.float32)
    if block == "res":
        jmod, tmod, convs = jblocks.ResidualBlock(c), blocks.ResidualBlock(c), ("conv1", "conv2")
    else:
        k = 3 if block == "cna3" else 1
        jmod, tmod = jblocks.ConvNormAct(c, kernel=k), blocks.ConvNormAct(c, c, kernel=k)
        convs = ("conv",)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        variables)
    scales = ({name: float(np.abs(x).max() / 127.0 * (1 + i)) for i, name in enumerate(convs)}
              if scaled == "calibrated" else None)
    with jax.default_matmul_precision("highest"), head_fusion(), \
            jquant.int8_serving(True, scales):
        ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    load_jax_params(tmod, variables)
    tmod.eval()
    calls = []
    real = cuda_head.conv_ln_act

    def spy(*args, **kwargs):
        calls.append(kwargs.get("xscale"))
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_head, "conv_ln_act", spy)
    blocks.set_head_fusion(tmod, True)
    quant.set_int8_serving(tmod, True, scales)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    if scales:
        assert calls == [scales[n] for n in convs]
    else:
        assert not calls
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["xscale", "kernel", "height", "w_shape", "residual_shape"])
def test_conv_ln_act_rejects(rng, bad):
    t = {k: torch.from_numpy(v) for k, v in _operands(rng).items()}
    kw = dict(height=4, width=3)
    args = [t["x"], t["w"], t["b"], t["g"], t["beta"], None]
    err = ValueError
    if bad == "xscale":  # the int8 form needs a positive finite scale
        kw["xscale"] = 0.0
    elif bad == "kernel":
        kw["kernel"] = 5
    elif bad == "height":
        kw["height"] = 5
    elif bad == "w_shape":
        args[1] = t["w"][:, :, :4]
    else:
        args[5] = t["res"][:, :2]
    with pytest.raises(err):
        cuda_head.conv_ln_act(*args, **kw)


def test_gate_constants_match_jax():
    assert cuda_head._MIN_FUSED_CH == pallas_head._MIN_FUSED_CH
    assert cuda_head._MAX_FUSED_PIXELS == pallas_head._MAX_FUSED_PIXELS
    for shape in [(16, 12, 384, 384), (16, 12, 192, 384), (64, 48, 256, 256), (4, 3, 256, 256),
                  (32, 16, 256, 256), (32, 17, 256, 256)]:
        assert cuda_head.fusable_shape(*shape) == pallas_head.fusable_shape(*shape)


@pytest.mark.parametrize("block", ["cna3", "cna1", "res"])
@pytest.mark.parametrize("hw_ch", [(4, 3, 256), (4, 3, 128), (24, 24, 256)])
def test_block_gate_and_parity(rng, monkeypatch, block, hw_ch):
    """The port's blocks take the fused unit exactly where the JAX gate
    does, and match the JAX blocks (fused there) either way."""
    h, w, c = hw_ch
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    if block == "res":
        jmod, tmod = jblocks.ResidualBlock(c), blocks.ResidualBlock(c)
    else:
        k = 3 if block == "cna3" else 1
        jmod, tmod = jblocks.ConvNormAct(c, kernel=k), blocks.ConvNormAct(c, c, kernel=k)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        variables)
    with jax.default_matmul_precision("highest"), head_fusion():
        ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    load_jax_params(tmod, variables)
    tmod.eval()

    calls = []
    real = cuda_head.conv_ln_act

    def spy(*args, **kwargs):
        calls.append(kwargs.get("kernel", 3))
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_head, "conv_ln_act", spy)
    blocks.set_head_fusion(tmod, True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    expect_fused = pallas_head.fusable_shape(h, w, c, c)
    assert bool(calls) == expect_fused
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    calls.clear()
    blocks.set_head_fusion(tmod, False)
    with torch.no_grad():
        unfused = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert not calls
    np.testing.assert_allclose(unfused, ref, atol=1e-4, rtol=1e-4)

    calls.clear()
    blocks.set_head_fusion(tmod, True)
    tmod.train()  # training never takes the fused unit
    with torch.no_grad():
        tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not calls


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_library_name_tracks_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    assert {p.name for p in _build._sources()} == {"k.cu"}
    real = {p.name for p in (_build.PACKAGE_DIR / "csrc").glob("*.cu")}
    assert real == {"bilateral.cu", "conv_ln_act.cu", "layernorm_act.cu", "mbconv.cu",
                    "postprocess.cu", "qconv.cu", "roi_align.cu", "s8_narrow.cu", "s8_wide.cu",
                    "s8_wide_1wg.cu", "tail.cu", "tail_q.cu"}
    header = tmp_path / "k.cuh"  # a changed header builds anew too
    header.write_text("// one\n")
    with_header = _build.library_path()
    header.write_text("// two\n")
    assert _build.library_path() != with_header


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_launcher_signature_matches_source(name):
    """Each ctypes signature lists the C launcher's parameters in order
    (pointers and the stream as void*, int, long long, float, double): a
    mismatch would pass garbage without any error."""
    src = "\n".join(p.read_text() for p in (_build.PACKAGE_DIR / "csrc").glob("*.cu"))
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, name
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double,
             "long long": ctypes.c_longlong}
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if p.endswith("*") else ctype[p] for p in params]
    assert _build.SIGNATURES[name] == want
