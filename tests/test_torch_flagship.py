"""The port's whole served slice vs the JAX package's fused-head serving
graph at a small size, on the same weights and inputs (CPU, float32).

Tiny config: variant "tiny", image 64x96, roi 16x12, mask 32x24,
mid_channels 32, base_channels 64. The EnhancedUNet bottleneck is then
4x3x256, so the fused conv+LayerNorm2d gate fires in both packages without
patching: in the bottleneck (five k=3 calls) and in ``rgb_extractor``
(``res2``, k=3, two calls; ``proj``, k=1). JAX runs its Pallas kernel
interpreted; the port runs the kernel's plain version on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.inference import InferenceEngine as JaxEngine
from human_instance_segmentation_tpu.inference import pad_rois as jax_pad_rois
from human_instance_segmentation_tpu.inference import roi_bucket as jax_roi_bucket
from human_instance_segmentation_tpu.models.assembly import (
    HierarchicalInstanceSegmenter as JaxSegmenter)
from human_instance_segmentation_tpu.ops.pallas_head import head_fusion
from human_instance_segmentation_tpu_torch.inference import (InferenceEngine, create_flagship,
                                                             pad_rois, roi_bucket)
from human_instance_segmentation_tpu_torch.ops import cuda_head
from human_instance_segmentation_tpu_torch.weights import load_jax_params

REPO = Path(__file__).resolve().parents[1]
TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32,
            base_channels=64)
ROIS = np.asarray([[0.0, 0.1, 0.2, 0.7, 0.9],
                   [1.0, 0.0, 0.0, 1.0, 1.0],
                   [0.0, 0.4, 0.3, 0.6, 0.8]], np.float32)


def _variables(model, seed):
    """fast_init plus non-trivial norm affines, so a mis-mapped scale or
    shift shows up."""
    v = fast_init(model, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 5)), train=False, seed=seed)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        owner = str(getattr(path[-2], "key", path[-2]))
        if path[0].key == "params" and name in ("scale", "bias") and owner != "output_conv":
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, v)


@pytest.fixture(scope="module", params=["bilinear", "nearest"])
def pair(request):
    mode = request.param
    jmodel = JaxSegmenter(encoder_variant="tiny", stage1_upsample_mode=mode, **TINY)
    variables = _variables(jmodel, seed=3)
    port = create_flagship(variant="tiny", device="cpu", stage1_upsample_mode=mode, seed=0, **TINY)
    load_jax_params(port, variables)
    images = np.random.default_rng(7).random((2, 64, 96, 3), dtype=np.float32)
    return jmodel, variables, port, images


def test_slice_matches_jax_fused_head(pair, monkeypatch):
    jmodel, variables, port, images = pair
    bucket = roi_bucket(len(ROIS))
    rois_p = pad_rois(ROIS, bucket)  # one sentinel roi
    with jax.default_matmul_precision("highest"):
        with head_fusion():
            jlogits, jaux = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(rois_p),
                                         train=False)
        jinst, jbinary = JaxEngine(jmodel, variables, dilation_pixels=1, fused_head=True)(
            images, ROIS)

    calls = []
    real = cuda_head.conv_ln_act

    def spy(*args, **kwargs):
        calls.append(kwargs.get("kernel", 3))
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_head, "conv_ln_act", spy)
    engine = InferenceEngine(port, device="cpu", dilation_pixels=1, fused_head=True)
    inst, binary = engine(images, ROIS)
    assert sorted(calls) == [1] + [3] * 7  # res2 x2 + proj + bottleneck x5
    calls.clear()
    with torch.no_grad():  # the engine's own copy, with its serving switches
        logits, aux = engine.model(torch.from_numpy(images), torch.from_numpy(rois_p))

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    assert set(aux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]), atol=1e-4, rtol=1e-4,
                                   err_msg=key)
    assert inst.shape == (3, 32, 24, 1) and binary.shape == (2, 64, 96, 1)
    np.testing.assert_allclose(binary, np.asarray(jbinary), atol=1e-5)
    assert float((inst == np.asarray(jinst)).mean()) >= 0.999


def test_predict_nchw_and_buckets(pair):
    _, _, port, images = pair
    engine = InferenceEngine(port, device="cpu", dilation_pixels=1)
    inst, binary = engine(images, ROIS)
    inst_c, binary_c = engine.predict_nchw(np.transpose(images, (0, 3, 1, 2)), ROIS)
    np.testing.assert_array_equal(inst_c, np.transpose(inst, (0, 3, 1, 2)))
    np.testing.assert_array_equal(binary_c, np.transpose(binary, (0, 3, 1, 2)))
    # the padded (sentinel) roi's mask is zeroed, the real ones pass through
    inst_p, _, logits_p = engine.forward(torch.from_numpy(images),
                                         torch.from_numpy(pad_rois(ROIS, 4)))
    assert inst_p[3].abs().max() == 0 and (logits_p[3].argmax(-1) == 1).any()
    np.testing.assert_array_equal(inst_p[:3].numpy(), inst)
    for n in (0, 1, 3, 5, 64, 65, 130):
        assert roi_bucket(max(n, 1)) == jax_roi_bucket(max(n, 1))
    np.testing.assert_array_equal(pad_rois(ROIS, 8), jax_pad_rois(ROIS, 8))


def test_import_does_not_load_jax():
    """Every module of the port, found by walking the package (so modules a
    later change adds are covered too), imports in a fresh interpreter
    without loading jax, flax or the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import human_instance_segmentation_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "want = {'data', 'data.loader', 'data.native', 'visualize', 'training.metrics',\n"
            "        'training.profiling', 'training.loop', 'config', 'convert_weights',\n"
            "        'inference'}\n"
            "missing = {w for w in want if p.__name__ + '.' + w not in names}\n"
            "assert not missing, missing\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'human_instance_segmentation_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_flagship(variant="tiny", device="cuda", **TINY)
    port = create_flagship(variant="tiny", device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(port, device="cuda")


def test_entry_points_default_to_the_gpu():
    """``create_flagship()`` without a device builds on the GPU, so on a host
    without CUDA it raises instead of quietly running on the CPU; an engine
    without a device serves on its model's device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_flagship(variant="tiny", **TINY)
    port = create_flagship(variant="tiny", device="cpu", **TINY)
    assert InferenceEngine(port).device.type == "cpu"


def test_engine_leaves_the_callers_model_alone():
    """Two engines over one model, bfloat16 (int8, fused head) first and
    float32 second: the caller's parameters keep their dtype and values, its
    mode and serving switches stay as they were, and the float32 engine
    serves exactly what a float32 engine over a fresh copy of the same
    weights serves (it used to serve the bf16-rounded weights)."""
    port = create_flagship(variant="tiny", device="cpu", seed=0, pallas_tail=True,
                           encoder_fused_blocks=2, **TINY).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    images = np.random.default_rng(9).random((2, 64, 96, 3), dtype=np.float32)
    bf16 = InferenceEngine(port, device="cpu", dilation_pixels=1, dtype=torch.bfloat16,
                           fused_head=True, quantize="int8", kernels=False)
    bf16.forward(torch.from_numpy(images), torch.from_numpy(pad_rois(ROIS, 4)))  # dynamic scales
    assert next(bf16.model.parameters()).dtype == torch.bfloat16 and bf16.model is not port
    assert any(getattr(m, "serving", False) for m in bf16.model.modules())
    inst, binary = InferenceEngine(port, device="cpu", dilation_pixels=1)(images, ROIS)

    after = port.state_dict()
    assert port.training and after.keys() == before.keys()
    for key, value in before.items():
        assert after[key].dtype == value.dtype and torch.equal(after[key], value), key
    assert not any(getattr(m, "serving", False) or getattr(m, "fused_head", False)
                   or getattr(m, "use_kernel", True) is False for m in port.modules())
    assert port.pretrained_unet.tail_use_kernel and port.pretrained_unet.tail_scales is None

    fresh = create_flagship(variant="tiny", device="cpu", seed=1, pallas_tail=True,
                            encoder_fused_blocks=2, **TINY)
    fresh.load_state_dict(before)
    inst_f, binary_f = InferenceEngine(fresh, device="cpu", dilation_pixels=1)(images, ROIS)
    np.testing.assert_array_equal(binary, binary_f)
    np.testing.assert_array_equal(inst, inst_f)


def test_warmup_changes_no_output_and_no_calibration():
    """``InferenceEngine.warmup`` serves zero batches at each bucket: a
    float32 engine's outputs on a real request are the same after it, and
    an int8 engine is neither calibrated by it (its scales stay None, its
    first real request calibrates on that request) nor changed by it once
    calibrated (the same scales, the same outputs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: intra-op threads only contend with other workers
    try:
        _check_warmup()
    finally:
        torch.set_num_threads(threads)


def _check_warmup():
    port = create_flagship(variant="tiny", device="cpu", seed=0, pallas_tail=True, **TINY)
    images = np.random.default_rng(11).random((2, 64, 96, 3), dtype=np.float32)
    f32 = InferenceEngine(port, device="cpu", dilation_pixels=1)
    before = f32(images, ROIS)
    f32.warmup(batch=2, buckets=(1, 4))
    after = f32(images, ROIS)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)

    def int8_engine():
        return InferenceEngine(port, device="cpu", dilation_pixels=1, fused_head=True,
                               quantize="int8", kernels=False)

    warmed, cold = int8_engine(), int8_engine()
    warmed.warmup(buckets=(1, 4))
    assert warmed.scales is None
    got, want = warmed(images, ROIS), cold(images, ROIS)  # each calibrates on the request
    assert warmed.scales == cold.scales and warmed.scales
    scales = dict(warmed.scales)
    warmed.warmup(buckets=(2,))
    assert warmed.scales == scales
    for a, b, c in zip(got, want, warmed(images, ROIS)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("pallas_tail", [False, True])
def test_crops_take_one_pair_call(monkeypatch, pallas_tail):
    """With ``pallas_roi_align`` the served forward takes both crops (the RGB
    image and the logit map: two channels, or one from the fused tail) in one
    ``roi_align_pair`` call, whose CPU path gives what the plain crops give;
    without the flag, and in training, the plain crops run and the pair is
    not called."""
    from human_instance_segmentation_tpu_torch.ops import cuda_roi_align

    calls = []
    real = cuda_roi_align.roi_align_pair

    def spy(first, second, *args, **kwargs):
        calls.append((first.shape[-1], second.shape[-1]))
        return real(first, second, *args, **kwargs)

    monkeypatch.setattr(cuda_roi_align, "roi_align_pair", spy)
    images = torch.from_numpy(np.random.default_rng(5).random((2, 64, 96, 3), dtype=np.float32))
    rois = torch.from_numpy(pad_rois(ROIS, 4))
    outs = {}
    for flag in (True, False):
        model = create_flagship(variant="tiny", device="cpu", seed=0, pallas_tail=pallas_tail,
                                pallas_roi_align=flag, **TINY)
        with torch.no_grad():
            outs[flag] = model(images, rois)
        assert calls == ([(3, 1 if pallas_tail else 2)] if flag else [])
        calls.clear()
        with torch.no_grad():
            model.train()(images, rois)
        assert not calls
    (logits, aux), (logits_p, aux_p) = outs[True], outs[False]
    assert torch.equal(logits, logits_p)
    for key in ("roi_patches", "roi_bg_fg"):
        assert aux[key].is_contiguous() and torch.equal(aux[key], aux_p[key]), key
