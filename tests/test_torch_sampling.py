"""PyTorch port vs the JAX package: sampling, norms, morphology and the
dilation boost, on the same seeded numpy inputs (CPU, float32).

JAX runs under ``jax.default_matmul_precision("highest")``: CPU XLA
defaults to bf16-class matmuls, which would look like port faults. The
Pallas gather kernel runs interpreted, as its own tests run it.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu.models.postprocess import (
    mask_dilation_logit_boost as jax_boost)
from human_instance_segmentation_tpu.ops import morphology as jmorph
from human_instance_segmentation_tpu.ops import sampling as jsampling
from human_instance_segmentation_tpu.ops.norms import LayerNorm2d as JaxLayerNorm2d
from human_instance_segmentation_tpu.ops.pallas_roi_align import roi_align_pallas
from human_instance_segmentation_tpu.ops.s2d import upsample_2x_nearest as jax_nearest
from human_instance_segmentation_tpu_torch.models.postprocess import mask_dilation_logit_boost
from human_instance_segmentation_tpu_torch.ops import cuda_roi_align, morphology, sampling
from human_instance_segmentation_tpu_torch.ops.norms import BatchNorm2d, LayerNorm2d
from human_instance_segmentation_tpu_torch.ops.s2d import upsample_2x_nearest

ATOL = 1e-5

ROIS = np.asarray([
    [0.0, 0.1, 0.2, 0.7, 0.9],
    [1.0, 0.0, 0.0, 1.0, 1.0],    # box edge at exactly 1.0
    [0.0, 0.4, 0.4, 0.5, 0.6],
    [1.0, 0.3, 0.3, 0.3, 0.3],    # degenerate box
    [0.0, -0.2, 0.5, 0.4, 1.3],   # hangs outside the image
    [-1.0, 0.0, 0.0, 0.0, 0.0],   # sentinel (padding)
], np.float32)


@pytest.fixture()
def highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("channels", [1, 3, 16])
@pytest.mark.parametrize("out_hw", [(8, 6), (1, 5)])
def test_roi_align_matches_jax(rng, highest, aligned, channels, out_hw):
    feats = rng.random((2, 24, 32, channels)).astype(np.float32)
    oh, ow = out_hw
    scale = (24.0, 32.0)
    ref = np.asarray(jsampling.roi_align(jnp.asarray(feats), jnp.asarray(ROIS), oh, ow,
                                         spatial_scale=scale, aligned=aligned))
    out = sampling.roi_align(torch.from_numpy(feats), torch.from_numpy(ROIS), oh, ow,
                             spatial_scale=scale, aligned=aligned).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    if channels <= 8:  # the Pallas kernel's Mosaic limit
        pal = np.asarray(roi_align_pallas(jnp.asarray(feats), jnp.asarray(ROIS), oh, ow,
                                          spatial_scale=scale, aligned=aligned, interpret=True))
        np.testing.assert_allclose(out, pal, atol=ATOL)


def test_roi_align_edge_and_sentinel_semantics():
    feats = torch.ones((2, 8, 8, 1))
    rois = torch.tensor([[1.0, 0.5, 0.5, 1.0, 1.0], [-1.0, 0.0, 0.0, 1.0, 1.0]])
    out = sampling.roi_align(feats, rois, 4, 4, spatial_scale=(8.0, 8.0), aligned=True)
    # x2 = y2 = 1.0 samples index 8 == extent: zeros on the last row/column
    assert out[0, -1].abs().max() == 0 and out[0, :, -1].abs().max() == 0
    assert out[0, :-1, :-1].min() == 1.0
    # the sentinel reads image 0 (batch index clipped), the caller masks it
    assert out[1, :-1, :-1].min() == 1.0


@pytest.mark.parametrize("aligned", [True, False])
def test_gather_wrapper_takes_plain_on_cpu(rng, aligned):
    feats = torch.from_numpy(rng.random((2, 24, 32, 3)).astype(np.float32))
    rois = torch.from_numpy(ROIS)
    before = cuda_roi_align.roi_align.launches
    out = cuda_roi_align.roi_align(feats, rois, 8, 6, spatial_scale=(24.0, 32.0), aligned=aligned)
    ref = cuda_roi_align.roi_align_plain(feats, rois, 8, 6, spatial_scale=(24.0, 32.0),
                                         aligned=aligned)
    assert torch.equal(out, ref)
    assert cuda_roi_align.roi_align.launches == before  # no kernel launched on the CPU


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2)])
def test_upsample_2x_bilinear(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jsampling.upsample_2x_bilinear(jnp.asarray(x)))
    out = sampling.upsample_2x_bilinear(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    # the NCHW form used inside the modules
    nchw = sampling.upsample_2x_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), axes=(2, 3))
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("method", ["half_pixel", "align_corners"])
@pytest.mark.parametrize("out_hw", [(8, 11), (3, 2), (10, 14)])
def test_resize_bilinear(rng, highest, method, out_hw):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jsampling.resize_bilinear(jnp.asarray(x), *out_hw, method=method))
    out = sampling.resize_bilinear(torch.from_numpy(x), *out_hw, method=method).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_upsample_2x_nearest(rng):
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    ref = np.asarray(jax_nearest(jnp.asarray(x)))
    np.testing.assert_array_equal(upsample_2x_nearest(torch.from_numpy(x)).numpy(), ref)


def test_layernorm2d(rng):
    x = (rng.standard_normal((2, 6, 5, 8)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    ref = JaxLayerNorm2d().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    ln = LayerNorm2d(8)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        out = ln(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm_eval(rng, eps):
    c = 6
    x = rng.standard_normal((2, 4, 5, c)).astype(np.float32)
    v = {"params": {"scale": (1 + 0.3 * rng.standard_normal(c)).astype(np.float32),
                    "bias": (0.2 * rng.standard_normal(c)).astype(np.float32)},
         "batch_stats": {"mean": (0.5 * rng.standard_normal(c)).astype(np.float32),
                         "var": (rng.random(c) + 0.5).astype(np.float32)}}
    ref = fnn.BatchNorm(use_running_average=True, epsilon=eps).apply(v, jnp.asarray(x))
    bn = BatchNorm2d(c, eps).eval()  # running statistics (train mode uses the batch's)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
        out = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("pixels", [0, 1, 2])
def test_dilate_and_boost(rng, pixels):
    x = rng.random((2, 9, 7, 1)).astype(np.float32)
    ref = np.asarray(jmorph.dilate(jnp.asarray(x), pixels))
    np.testing.assert_array_equal(morphology.dilate(torch.from_numpy(x), pixels).numpy(), ref)
    logits = rng.standard_normal((3, 9, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_boost(jnp.asarray(logits), pixels))
    out = mask_dilation_logit_boost(torch.from_numpy(logits), pixels).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_max_pool_strided(rng):
    x = rng.standard_normal((1, 8, 6, 2)).astype(np.float32)
    ref = np.asarray(jmorph.max_pool2d(jnp.asarray(x), 3, 2, 1))
    np.testing.assert_array_equal(morphology.max_pool2d(torch.from_numpy(x), 3, 2, 1).numpy(), ref)


@pytest.mark.parametrize("layout", ["contiguous", "permuted"])
@pytest.mark.parametrize("second_channels", [1, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_pair_takes_plain_on_cpu(rng, highest, aligned, second_channels, layout):
    """The two-map entry point on the CPU: two plain calls (contiguous
    outputs), equal to the JAX package's ``ops/sampling.roi_align`` for each
    map, and no kernel launched. The second map is also an NCHW tensor viewed
    as NHWC, as the model hands the logit map over."""
    first = rng.random((2, 24, 32, 3)).astype(np.float32)
    second = rng.random((2, second_channels, 24, 32)).astype(np.float32).transpose(0, 2, 3, 1)
    second_t = torch.from_numpy(second) if layout == "permuted" else torch.from_numpy(
        np.ascontiguousarray(second))
    rois = torch.from_numpy(ROIS)
    kw = dict(spatial_scale=(24.0, 32.0), aligned=aligned)
    before = cuda_roi_align.roi_align.launches
    got = cuda_roi_align.roi_align_pair(torch.from_numpy(first), second_t, rois, 8, 6, **kw)
    assert cuda_roi_align.roi_align.launches == before
    for out, feats, feats_np in zip(got, (torch.from_numpy(first), second_t), (first, second)):
        assert out.is_contiguous() and out.dtype == torch.float32
        assert torch.equal(out, sampling.roi_align(feats, rois, 8, 6, **kw))
        ref = np.asarray(jsampling.roi_align(jnp.asarray(feats_np), jnp.asarray(ROIS), 8, 6, **kw))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_pair_rejects():
    rois = torch.from_numpy(ROIS)
    a = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError, match="share"):
        cuda_roi_align.roi_align_pair(a, torch.zeros(2, 8, 9, 2), rois, 4, 4)
    with pytest.raises(ValueError, match="share"):
        cuda_roi_align.roi_align_pair(a, a.to(torch.bfloat16), rois, 4, 4)
    with pytest.raises(ValueError, match=r"\(N, 5\)"):
        cuda_roi_align.roi_align_pair(a, a, rois[:, :4], 4, 4)
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        cuda_roi_align.roi_align_pair(a, a[0], rois, 4, 4)
    # a map that is neither on the CPU nor on a CUDA device never reaches
    # the plain version
    for first, second in ((a.to("meta"), a.to("meta")), (a, a.to("meta"))):
        with pytest.raises(RuntimeError, match="no kernel for device"):
            cuda_roi_align.roi_align_pair(first, second, rois, 4, 4)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cuda_roi_align.roi_align(a.to("meta"), rois, 4, 4)
