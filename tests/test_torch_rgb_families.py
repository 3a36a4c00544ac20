"""The pure-RGB and ROI-pretrained hierarchical families and the flagship
with the refinement flags and the guided head, against the JAX package
(CPU, float32, JAX under ``jax.default_matmul_precision("highest")`` and
``jax.jit``, inputs from a numpy seed, the same weights through
``weights.from_jax_params``); an unfrozen stage 1; the two families served
through ``InferenceEngine`` and trained by the ``--tiny`` loop.

Tolerances: forwards within rtol 1e-4 / atol 1e-5, except with GroupNorm
(see the comment in ``test_family_forward_matches_jax``). The train step
with running statistics is ``test_torch_batch_stats.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.models import assembly as jasm
from human_instance_segmentation_tpu_torch.inference import InferenceEngine
from human_instance_segmentation_tpu_torch.models import assembly as pasm
from human_instance_segmentation_tpu_torch.training.loop import run_training
from human_instance_segmentation_tpu_torch.weights import load_jax_params

RTOL, ATOL = 1e-4, 1e-5
IMG = (64, 64)
ROI_PRETRAINED = "rgb_hierarchical_unet_v2_pretrained_peopleseg_r64x48m64x48"
FLAGSHIP_TINY = dict(encoder_variant="tiny", roi_size=(16, 12), mask_size=(32, 24),
                     image_size=IMG, feature_dim=32, mid_channels=32, base_channels=16, depth=2,
                     unet_decoder_channels=(32, 24, 16, 16, 8))
ROI_TINY = dict(encoder_variant="tiny", roi_size=(16, 12), mask_size=(16, 12), image_size=IMG,
                feature_dim=32, unet_decoder_channels=(32, 24, 16, 16, 8))
RGB_TINY = dict(roi_size=(8, 8), mask_size=(16, 16), image_size=IMG, feature_dim=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((2, *IMG, 3), np.float32)
    rois = np.asarray([[0, 0.1, 0.1, 0.8, 0.9], [1, 0.2, 0.0, 0.7, 0.6],
                       [1, 0.3, 0.3, 0.95, 0.9]], np.float32)
    return images, rois


def _variables(jmodel, seed=1):
    v = fast_init(jmodel, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False, seed=seed)
    rng = np.random.default_rng(seed + 10)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        owner = str(getattr(path[-2], "key", path[-2]))
        if path[0].key == "params" and name in ("scale", "bias") and owner != "output_conv":
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(perturb, v))


FAMILIES = {
    "purergb_attention": (jasm.PureRGBHierarchicalModel, pasm.PureRGBHierarchicalModel,
                          dict(RGB_TINY, use_attention_module=True)),
    "roi_pretrained": (jasm.ROIPretrainedHierarchicalModel, pasm.ROIPretrainedHierarchicalModel,
                       ROI_TINY),
}
for _name, _flags in {
    # attention module, boundary refinement and progressive decoder at once
    "refined": dict(use_attention_module=True, use_boundary_refinement=True,
                    use_progressive_upsampling=True),
    "subpixel": dict(use_subpixel_conv=True),
    "guided_attention": dict(use_contour_detection=False, use_distance_transform=False,
                             use_attention_module=True),
    "refined_groupnorm_swish": dict(use_attention_module=True, use_boundary_refinement=True,
                                    norm="groupnorm", norm_groups=4, activation="swish",
                                    activation_beta=1.5),
}.items():
    FAMILIES[f"flagship_{_name}"] = (jasm.HierarchicalInstanceSegmenter,
                                     pasm.HierarchicalInstanceSegmenter,
                                     dict(FLAGSHIP_TINY, **_flags))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_matches_jax(family):
    """Eval forward: logits and every aux map of the JAX model."""
    jcls, pcls, kw = FAMILIES[family]
    jm = jcls(**kw)
    pm = pcls(**kw, **({"pallas_roi_align": False} if "flagship" in family else {}))
    v = _variables(jm)
    load_jax_params(pm, v)
    images, rois = _inputs()
    with jax.default_matmul_precision("highest"):
        want, want_aux = jax.tree.map(np.asarray, jax.jit(jm.apply)(v, jnp.asarray(images),
                                                                    jnp.asarray(rois)))
    with torch.no_grad():
        got, aux = pm.eval()(torch.from_numpy(images), torch.from_numpy(rois))
    # GroupNorm's fast variance, E[x^2] - E[x]^2 in float32, turns the two
    # packages' last-bit differences in the sums into relative errors of
    # about 1e-4 in a group's statistics; through the head's two dozen
    # group norms they reach 2e-5 on logits of magnitude 0.1
    rtol, atol = (1e-3, 5e-5) if kw.get("norm") == "groupnorm" else (RTOL, ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    assert set(aux) == set(want_aux)
    for k, w in want_aux.items():
        np.testing.assert_allclose(aux[k].numpy(), w, rtol=rtol, atol=atol, err_msg=k)


def _roi_model():
    pm = pasm.ROIPretrainedHierarchicalModel(**ROI_TINY)
    load_jax_params(pm, _variables(jasm.ROIPretrainedHierarchicalModel(**ROI_TINY), seed=2))
    return pm


def test_unfrozen_stage1_trains_and_frozen_stays():
    """``freeze_pretrained=False``: ``train()`` reaches stage 1 and a
    gradient reaches its parameters; ``True`` keeps it in eval mode."""
    for frozen in (False, True):
        pm = pasm.ROIPretrainedHierarchicalModel(**ROI_TINY, freeze_pretrained=frozen)
        pm.train()
        assert pm.pretrained_unet.training == (not frozen)
        images, rois = _inputs()
        logits, _ = pm(torch.from_numpy(images), torch.from_numpy(rois))
        logits.sum().backward()
        g = pm.pretrained_unet.encoder.stem_conv.weight.grad
        assert (g is None) == frozen


@pytest.mark.parametrize("family", ["purergb", "roi_pretrained"])
def test_engine_serves_the_rgb_families(family):
    """``InferenceEngine`` serves both families (instance masks, no binary
    mask: neither has a full-image stage 1), with the fused head on (its
    plain version on the CPU) equal to the unfused forward."""
    if family == "purergb":
        pm = pasm.PureRGBHierarchicalModel(**dict(RGB_TINY, feature_dim=16))
    else:
        pm = _roi_model()
    images, rois = _inputs()
    plain = InferenceEngine(pm, dilation_pixels=1)
    fused = InferenceEngine(pm, dilation_pixels=1, fused_head=True)
    inst, binary = plain(images, rois)
    inst_f, binary_f = fused(images, rois)
    assert binary is None and binary_f is None
    assert inst.shape == (3, *pm.mask_size, 1)
    np.testing.assert_array_equal(inst, inst_f)


@pytest.mark.parametrize("name,family", [
    ("rgb_hierarchical_unet_v2_attention_r64m64_refined_batchnorm", "PureRGBHierarchicalModel"),
    (ROI_PRETRAINED, "ROIPretrainedHierarchicalModel"),
])
def test_tiny_loop_trains_the_rgb_families(name, family, tmp_path):
    """``run_training(--tiny)`` on a pure-RGB config with BatchNorm heads and
    on the ROI-pretrained config (stage 1 unfrozen): the JAX loop's tiny
    shapes at the families' own widths, two finite steps, no skip, and the
    running statistics moved."""
    metrics, state = run_training(name, steps=2, synthetic=True, tiny=True, device="cpu",
                                  output_dir=str(tmp_path), return_state=True)
    assert type(state.model).__name__ == family
    assert state.model.roi_size == (16, 12) and state.skipped == 0 and state.step == 2
    assert np.isfinite(metrics["total_loss"])
    bn = next(m for m in state.model.modules() if hasattr(m, "running_var"))
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
