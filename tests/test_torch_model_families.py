"""The other model families of the port against the JAX package (CPU,
float32, JAX under ``jax.default_matmul_precision("highest")`` and
``jax.jit``, inputs from a numpy seed, the weights carried across by
``weights.from_jax_params(..., model)`` and a strict load): heads V1, V3
and V4 and ``ShallowUNet``; the multi-scale pyramid, its fusions and
models, the variable-ROI model; the baseline; the multi-scale RGB model and
one train step of it; the cascade, class-specific and auxiliary heads with
their losses; ``model_from_config``'s three branches and the loop's refusal
of the baseline (ROADMAP C15); the converter's transposed convs, attention
kernels and ``fusion_weights``.

Sizes are the JAX tests' (``tests/test_model_families.py``): head features
(2, 14, 14, 24) at mid 32 and mask 28 x 28, 64 x 64 images. Tolerances:
forwards, losses and gradients within rtol 1e-4 / atol 1e-5 (the train
step's gradients in float64, see ``ms_ref``); the parameters after one
AdamW step within 3 x lr (Adam's first step divides a gradient by its own
magnitude, so a parameter whose gradient is near 0 moves by up to lr
either way).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu import config as jcfg
from human_instance_segmentation_tpu.models import assembly as jasm
from human_instance_segmentation_tpu.models import baseline as jbase
from human_instance_segmentation_tpu.models import extras as jext
from human_instance_segmentation_tpu.models import heads as jheads
from human_instance_segmentation_tpu.models import multiscale as jms
from human_instance_segmentation_tpu.ops import norms as jnorms
from human_instance_segmentation_tpu.training import optim as joptim
from human_instance_segmentation_tpu.training import steps as jsteps
from human_instance_segmentation_tpu.training.state import TrainState as JTrainState
from human_instance_segmentation_tpu_torch import config as pcfg
from human_instance_segmentation_tpu_torch.inference import InferenceEngine
from human_instance_segmentation_tpu_torch.models import assembly as pasm
from human_instance_segmentation_tpu_torch.models import baseline as pbase
from human_instance_segmentation_tpu_torch.models import extras as pext
from human_instance_segmentation_tpu_torch.models import heads as pheads
from human_instance_segmentation_tpu_torch.models import multiscale as pms
from human_instance_segmentation_tpu_torch.models.blocks import Dropout2d
from human_instance_segmentation_tpu_torch.ops import norms as pnorms
from human_instance_segmentation_tpu_torch.training import optim as poptim
from human_instance_segmentation_tpu_torch.training import steps as psteps
from human_instance_segmentation_tpu_torch.training.loop import run_training
from human_instance_segmentation_tpu_torch.training.state import TrainState
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

RTOL, ATOL = 1e-4, 1e-5
IMG = (64, 64)
ROIS = np.asarray([[0.0, 0.2, 0.2, 0.8, 0.8], [0.0, 0.1, 0.1, 0.5, 0.9],
                   [1.0, 0.3, 0.05, 0.95, 0.7]], np.float32)
VAR_ROI = {"layer_3": 56, "layer_22": 42, "layer_34": 28}
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(v, seed):
    """``fast_init`` variables with the norms' affine parameters moved off
    1 and 0, as numpy."""
    rng = np.random.default_rng(seed + 10)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        if path[0].key == "params" and name in ("scale", "bias"):
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(perturb, v))


def _vars(jm, *args, seed=1, **kw):
    return _perturbed(fast_init(jm, *args, seed=seed, **kw), seed)


def _japply(jm, v, *args, **kw):
    fn = jax.jit(lambda v, *a: jm.apply(v, *a, **kw))
    with jax.default_matmul_precision("highest"):
        return jax.tree.map(np.asarray, fn(v, *[jax.tree.map(jnp.asarray, a) for a in args]))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return _t(np.transpose(x, (0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _images(seed=0, b=2):
    return np.random.default_rng(seed).random((b, *IMG, 3), np.float32)


def _head_feats(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 14, 14, 24)).astype(np.float32)


def _pyramid_feats(seed=3):
    """External features in sorted key order (the order JAX's jit hands a
    dict over in)."""
    rng = np.random.default_rng(seed)
    shapes = {"layer_22": (2, 8, 8, 512), "layer_3": (2, 16, 16, 256),
              "layer_34": (2, 8, 8, 1024)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in sorted(shapes.items())}


HEADS = {
    "V1": (jheads.HierarchicalHeadV1, pheads.HierarchicalHeadV1, {}),
    "V3": (jheads.HierarchicalHeadV3, pheads.HierarchicalHeadV3, dict(base_channels=8, depth=2)),
    "V4": (jheads.HierarchicalHeadV4, pheads.HierarchicalHeadV4, {}),
}


@pytest.mark.parametrize("variant", sorted(HEADS))
def test_head_variant_matches_jax(variant):
    """Logits and every aux map, JAX's keys letter for letter; V4's
    cross-branch attention through its converted ``DenseGeneral`` kernels."""
    jcls, pcls, kw = HEADS[variant]
    jm = jcls(mid_channels=32, mask_size=(28, 28), **kw)
    feats = _head_feats()
    v = _vars(jm, jnp.zeros((1, 14, 14, 24)), train=False)
    want, want_aux = _japply(jm, v, feats, train=False)
    pm = load_jax_params(pcls(24, mid_channels=32, mask_size=(28, 28), **kw), v).eval()
    with torch.no_grad():
        got, aux = pm(_nchw(feats))
    assert got.shape == (2, 3, 28, 28)
    _close(_nhwc(got), want)
    assert set(aux) == set(want_aux)
    for k, w in want_aux.items():
        _close(_nhwc(aux[k]), w, k)


def test_shallow_unet_matches_jax():
    jm = jheads.ShallowUNet(base_channels=16)
    feats = np.random.default_rng(1).standard_normal((2, 13, 11, 24)).astype(np.float32)
    v = _vars(jm, jnp.zeros((1, 13, 11, 24)), train=False)
    pm = load_jax_params(pheads.ShallowUNet(24, 16), v).eval()
    with torch.no_grad():
        got = pm(_nchw(feats))
    _close(_nhwc(got), _japply(jm, v, feats, train=False))


def test_conv_feature_pyramid_matches_jax():
    jm = jms.ConvFeaturePyramid(layers=("layer_3", "layer_22", "layer_34"))
    images = _images()
    v = _vars(jm, jnp.zeros((1, *IMG, 3)), train=False)
    want = _japply(jm, v, images, train=False)
    pm = load_jax_params(pms.ConvFeaturePyramid(("layer_3", "layer_22", "layer_34")), v).eval()
    with torch.no_grad():
        got = pm(_nchw(images))
    assert set(got) == set(want)
    for layer, w in want.items():
        ch, stride = pms.FEATURE_SPECS[layer]
        assert w.shape == (2, 64 // stride, 64 // stride, ch)
        _close(_nhwc(got[layer]), w, layer)


@pytest.mark.parametrize("method", ["fpn", "concat", "sum"])
def test_feature_pyramid_fusion_matches_jax(method):
    feats = _pyramid_feats()
    jm = jms.FeaturePyramidFusion(out_channels=32, fusion_method=method)
    v = _vars(jm, {k: jnp.zeros((1, *f.shape[1:])) for k, f in feats.items()})
    want = _japply(jm, v, feats)
    pm = load_jax_params(pms.FeaturePyramidFusion({k: f.shape[-1] for k, f in feats.items()},
                                                  32, method), v)
    with torch.no_grad():
        got = pm({k: _nchw(f) for k, f in feats.items()})
    assert set(got) == set(want)
    for layer, w in want.items():
        _close(_nhwc(got[layer]), w, layer)


def _model_outputs(jm, pm, v, images, features=None):
    kw = {} if features is None else {"features": features}
    want, want_aux = _japply(jm, v, images, ROIS, train=False, **kw)
    load_jax_params(pm, v).eval()
    with torch.no_grad():
        got, aux = pm(_t(images), _t(ROIS), **{k: {l: _t(f) for l, f in x.items()}
                                               for k, x in kw.items()})
    _close(got.numpy(), want)
    assert set(aux) == set(want_aux)
    for k, w in want_aux.items():
        _close(aux[k].numpy(), w, k)
    return want, want_aux


@pytest.mark.parametrize("fusion", ["adaptive", "concat", "sum"])
def test_multiscale_model_matches_jax(fusion):
    kw = dict(roi_size=(14, 14), mask_size=(28, 28), mid_channels=32, fusion_method=fusion)
    jm = jms.MultiScaleSegmentationModel(**kw)
    images = _images()
    v = _vars(jm, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False)
    want, aux = _model_outputs(jm, pms.MultiScaleSegmentationModel(**kw), v, images)
    assert want.shape == (3, 28, 28, 3) and aux["roi_features"].shape == (3, 14, 14, 32)


@pytest.mark.parametrize("family", ["multiscale", "variable_roi"])
def test_multiscale_head_only_external_features(family):
    """``pyramid=False``: no pyramid parameters (the JAX tree of a model
    initialised with ``features=``), the external features cropped; the
    multi-scale model at roi 14, the variable-ROI model at its own sizes."""
    feats = _pyramid_feats()
    if family == "multiscale":
        kw = dict(roi_size=(14, 14), mask_size=(28, 28), mid_channels=32)
        jm, pm = jms.MultiScaleSegmentationModel(**kw), pms.MultiScaleSegmentationModel(
            **kw, pyramid=False)
    else:
        kw = dict(roi_sizes=VAR_ROI, mask_size=(28, 28), mid_channels=32)
        jm, pm = jms.VariableROISegmentationModel(**kw), pms.VariableROISegmentationModel(
            **kw, pyramid=False)
    v = _vars(jm, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False,
              features={k: jnp.zeros((1, *f.shape[1:])) for k, f in feats.items()})
    assert "pyramid" not in v["params"]
    _model_outputs(jm, pm, v, _images(), features=feats)
    with pytest.raises(ValueError, match="features="):
        pm(_t(_images()), _t(ROIS))


@pytest.mark.parametrize("rgb", [False, True], ids=["plain", "rgb_enhanced"])
def test_variable_roi_model_matches_jax(rgb):
    """56 -> 28 by the strided path, 42 -> 28 by the widened path and a
    resize, 28 as it is; with RGB enhancement of layer_34."""
    kw = dict(roi_sizes=VAR_ROI, mask_size=(56, 56), mid_channels=32, use_rgb_enhancement=rgb)
    jm = jms.VariableROISegmentationModel(**kw)
    v = _vars(jm, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False)
    assert ("rgb_enc_layer_34" in v["params"]) == rgb
    want, aux = _model_outputs(jm, pms.VariableROISegmentationModel(**kw), v, _images())
    assert want.shape == (3, 56, 56, 3) and aux["roi_features"].shape == (3, 28, 28, 32)


@pytest.mark.parametrize("source", ["pyramid", "features"])
def test_baseline_model_matches_jax(source):
    """The baseline at 64 x 64, roi 14, mask 28: its transposed convs ``up1``
    and ``up2`` converted by module type, the logits resized to the mask;
    on its own ``layer_34`` or on a (B, 8, 8, 1024) map passed as
    ``features=`` (``pyramid=False``)."""
    kw = dict(roi_size=(14, 14), mask_size=(28, 28))
    jm = jbase.ROISegmentationModel(**kw)
    images = _images()
    if source == "pyramid":
        v = _vars(jm, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False)
        want, aux = _model_outputs(jm, pbase.ROISegmentationModel(**kw), v, images)
        assert want.shape == (3, 28, 28, 3) and aux["features"].shape == (2, 8, 8, 1024)
        return
    feats = _pyramid_feats()["layer_34"]
    v = _vars(jm, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False,
              features=jnp.zeros((1, 8, 8, 1024)))
    assert "pyramid" not in v["params"]
    want, want_aux = _japply(jm, v, images, ROIS, train=False, features=feats)
    pm = load_jax_params(pbase.ROISegmentationModel(**kw, pyramid=False), v).eval()
    with torch.no_grad():
        got, aux = pm(_t(images), _t(ROIS), features=_t(feats))
    _close(got.numpy(), want)
    np.testing.assert_array_equal(aux["features"].numpy(), want_aux["features"])


@pytest.mark.parametrize("fusion", ["concat", "adaptive"])
def test_multiscale_rgb_model_matches_jax(fusion):
    """Crops at 56, 42 and 28 (``aligned=False``), each extractor's map
    resized to 28 x 28, fused, the V2 head at mid 256; aux
    ``roi_patches`` is the 56 x 56 crop."""
    kw = dict(mask_size=(28, 28), image_size=IMG, feature_dim=32, fusion_method=fusion)
    jm = jasm.MultiScaleRGBHierarchicalModel(**kw)
    v = _vars(jm, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False)
    assert ("fusion_weights" in v["params"]) == (fusion == "adaptive")
    want, aux = _model_outputs(jm, pasm.MultiScaleRGBHierarchicalModel(**kw), v, _images())
    assert aux["roi_patches"].shape == (3, 56, 56, 3)


def test_cascade_head_and_loss_match_jax():
    jm = jext.CascadeSegmentationHead(mid_channels=32)
    feats = _head_feats()
    v = _vars(jm, jnp.zeros((1, 14, 14, 24)), train=False)
    want, want_aux = _japply(jm, v, feats, train=False)
    pm = load_jax_params(pext.CascadeSegmentationHead(24, 32), v).eval()
    with torch.no_grad():
        got, aux = pm(_nchw(feats))
    _close(_nhwc(got), want)
    stages = [_nhwc(s) for s in aux["stage_outputs"]]
    for g, w in zip(stages, want_aux["stage_outputs"]):
        _close(g, w)
    targets = np.random.default_rng(2).integers(0, 3, (2, 14, 14)).astype(np.int32)
    valid = np.asarray([1.0, 0.0], np.float32)
    for vd in (None, valid):
        jt, jmet = jext.cascade_loss([jnp.asarray(w) for w in want_aux["stage_outputs"]],
                                     jnp.asarray(targets),
                                     valid=None if vd is None else jnp.asarray(vd))
        pt, pmet = pext.cascade_loss([_t(s) for s in stages], _t(targets),
                                     valid=None if vd is None else _t(vd))
        _close(float(pt), float(jt))
        assert set(pmet) == set(jmet) == {"stage0_loss", "stage1_loss", "stage2_loss",
                                          "total_loss"}
        for k in jmet:
            _close(float(pmet[k]), float(jmet[k]), k)


def test_class_specific_decoder_matches_jax():
    jm = jext.ClassSpecificDecoder(mid_channels=16)
    feats = _head_feats()
    v = _vars(jm, jnp.zeros((1, 14, 14, 24)), train=False)
    pm = load_jax_params(pext.ClassSpecificDecoder(24, 16), v).eval()
    with torch.no_grad():
        got = pm(_nchw(feats))
    _close(_nhwc(got), _japply(jm, v, feats, train=False))


def test_auxiliary_head_and_multitask_loss_match_jax():
    """The aux logit at 14 x 14; the loss pools 28 x 28 targets to it by a
    resize and the 0.5 threshold; with and without ``valid`` and
    ``pos_weight``."""
    jm = jext.AuxiliaryFgBgHead(mid_channels=16)
    feats = _head_feats()
    v = _vars(jm, jnp.zeros((1, 14, 14, 24)), train=False)
    want = _japply(jm, v, feats, train=False)
    pm = load_jax_params(pext.AuxiliaryFgBgHead(24, 16), v).eval()
    with torch.no_grad():
        got = _nhwc(pm(_nchw(feats)))
    _close(got, want)
    targets = np.random.default_rng(4).integers(0, 3, (2, 28, 28)).astype(np.int32)
    for pw, valid in ((None, None), (2.27, np.asarray([1.0, 0.0], np.float32))):
        jt, jmet = jext.multi_task_loss(jnp.asarray(1.0), jnp.asarray(want), jnp.asarray(targets),
                                        aux_weight=0.3, pos_weight=pw,
                                        valid=None if valid is None else jnp.asarray(valid))
        pt, pmet = pext.multi_task_loss(torch.tensor(1.0), _t(got), _t(targets), aux_weight=0.3,
                                        pos_weight=pw, valid=None if valid is None else _t(valid))
        assert set(pmet) == set(jmet)
        for k in jmet:
            _close(float(pmet[k]), float(jmet[k]), k)
        assert float(pt) > 1.0


# ---------------------------------------------------------------------------
# one train step of the multi-scale RGB model
# ---------------------------------------------------------------------------

MS_RGB = dict(roi_sizes=(28, 14), mask_size=(28, 28), image_size=IMG, feature_dim=32,
              fusion_method="adaptive")


def _ms_cfg(pkg):
    cfg = pkg.ConfigManager.get_config("rgb_hierarchical_unet_v2")
    cfg.model.multi_scale = True
    cfg.model.roi_sizes = MS_RGB["roi_sizes"]
    cfg.model.mask_size = MS_RGB["mask_size"]
    cfg.model.image_size = IMG
    cfg.model.fusion_method = "adaptive"
    return cfg


def _ms_batch():
    from human_instance_segmentation_tpu_torch.training.loop import synthetic_batches

    b = next(synthetic_batches(1, 2, IMG, (28, 28), seed=5))
    b["valid"][0, 1] = 0.0  # one padded ROI
    return b


class _Float64Statistics:
    """``jax.numpy`` with ``float32`` read as ``float64``, for the JAX
    ``ops/norms.py`` in the float64 reference: LayerNorm2d computes its
    statistics in float32 whatever x's dtype (the rule for bf16
    activations), which would leave float32 noise in a float64 step. The
    port's side is :func:`_layer_norm_in_x_dtype`."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _layer_norm_in_x_dtype(self, x):
    """The port's ``LayerNorm2d.forward`` with its statistics in x's dtype
    when that is wider than float32 (the same formula)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
    return y * self.weight[:, None, None] + self.bias[:, None, None]


def _ms_port(variables):
    model = pcfg.model_from_config(_ms_cfg(pcfg), device="cpu", feature_dim=32)
    load_jax_params(model, variables)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def ms_ref():
    """JAX's ``make_train_step`` on the multi-scale RGB model (dropout
    patched to the identity) in float64 (``jax.enable_x64``, float64 copies
    of the float32 variables and of the batch's images and boxes, and
    LayerNorm2d's statistics in float64, see :class:`_Float64Statistics`):
    the loss, the raw gradients (recorded by a first link of the optax
    chain) and the parameters after the step. Float64, because a float32
    gradient of a conv weight under LayerNorm2d over a whole crop sums
    thousands of products of both signs: the two packages' float32 orders
    leave up to 1.4e-5 on entries of 1.5e-3 (measured on
    ``rgb_extractor0.conv2`` with crops of 42 and 28 at 2 x 2 ROIs), noise
    that says nothing of the port. One image with two ROIs, one padded, and
    crops of 28 and 14 keep the float64 step short."""
    cfg = _ms_cfg(jcfg)
    jm = jcfg.model_from_config(cfg).clone(feature_dim=32)
    v = _vars(jm, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False, seed=3)
    batch = _ms_batch()
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"), \
            jax.enable_x64(True):
        mp.setattr(jheads, "Dropout2d", lambda rate, name=None: (lambda x, train=False: x))
        mp.setattr(jnorms, "jnp", _Float64Statistics())
        record = optax.GradientTransformation(
            lambda params: jax.tree.map(jnp.zeros_like, params),
            lambda grads, state, params=None: (grads, grads))
        sched = joptim.build_schedule(LR, 1, 100, "cosine", 1e-6, 0)
        tx = optax.chain(record, joptim.build_optimizer(sched, "adamw", 1e-4, 5.0))
        step = jsteps.make_train_step(jm, tx, jcfg.loss_config_from_experiment(cfg),
                                      donate=False)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        b64 = dict(batch, images=batch["images"].astype(np.float64),
                   boxes=batch["boxes"].astype(np.float64))
        state, metrics = step(JTrainState.create(v64, tx, jax.random.PRNGKey(1)), b64)
        state = jax.tree.map(np.asarray, state)
        return {"variables": v, "batch": batch, "loss": float(metrics["total_loss"]),
                "metrics": jax.tree.map(np.asarray, metrics),
                "grads": from_jax_params({"params": state.opt_state[0]}),
                "after": from_jax_params({"params": state.params})}


def test_multiscale_rgb_train_step_matches_jax(ms_ref, monkeypatch):
    """The multi-scale RGB model's train step against JAX's float64
    ``make_train_step`` (AdamW, clip 5.0, cosine): the port in float64 gives
    the loss, every metric and every gradient; its float32 ``make_train_step``
    gives the loss and the parameters after the step."""
    loss_cfg = pcfg.loss_config_from_experiment(_ms_cfg(pcfg))
    monkeypatch.setattr(pnorms.LayerNorm2d, "forward", _layer_norm_in_x_dtype)
    model = _ms_port(ms_ref["variables"]).double().train()
    loss, (_, _, metrics) = psteps.make_loss_fn(model, loss_cfg)(
        psteps.HierarchicalLossState.create(), torch.Generator().manual_seed(0),
        psteps.batch_to(ms_ref["batch"], "cpu"))
    _close(float(loss.detach()), ms_ref["loss"])
    assert set(metrics) == set(ms_ref["metrics"])
    for k, v in ms_ref["metrics"].items():
        _close(float(metrics[k].detach()), v, k)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert set(names) == set(ms_ref["grads"])
    for name, g in zip(names, grads):
        _close(g.numpy(), ms_ref["grads"][name].numpy(), name)
    assert float(dict(zip(names, grads))["fusion_weights"].abs().max()) > 0

    monkeypatch.undo()
    model = _ms_port(ms_ref["variables"])
    tx = poptim.build_optimizer(poptim.build_schedule(LR, 1, 100, "cosine", 1e-6, 0),
                                "adamw", 1e-4, 5.0)
    state = TrainState.create(model, tx, seed=1)
    state, m = psteps.make_train_step(model, loss_cfg)(state, ms_ref["batch"])
    assert state.skipped == 0
    _close(float(m["total_loss"]), ms_ref["loss"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ms_ref["after"][name].numpy(), rtol=0,
                                   atol=3 * LR, err_msg=name)


# ---------------------------------------------------------------------------
# model_from_config, serving and the loop
# ---------------------------------------------------------------------------

def _variable_roi_cfg(pkg):
    cfg = pkg.ConfigManager.get_config("baseline")
    cfg.model.variable_roi_sizes = {"layer_34": 28, "layer_22": 14}
    return cfg


def _multiscale_cfg(pkg):
    cfg = pkg.ConfigManager.get_config("rgb_hierarchical_unet_v2")
    cfg.model.multi_scale = True
    return cfg


BRANCHES = {
    "baseline": (lambda pkg: pkg.ConfigManager.get_config("baseline"), "ROISegmentationModel"),
    "variable_roi": (_variable_roi_cfg, "VariableROISegmentationModel"),
    "multiscale_rgb": (_multiscale_cfg, "MultiScaleRGBHierarchicalModel"),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_model_from_config_builds_the_three_branches(branch):
    """Each branch builds the JAX dispatch's class with the config's sizes,
    seeded (two builds equal) and in eval mode; the default ``device="cuda"``
    raises without CUDA (ROADMAP C5)."""
    make, want = BRANCHES[branch]
    jm = jcfg.model_from_config(make(jcfg))
    with torch.device("meta"):
        model = pcfg.model_from_config(make(pcfg), device="meta")
    assert type(model).__name__ == type(jm).__name__ == want
    assert model.mask_size == tuple(jm.mask_size)
    if branch == "baseline":
        assert model.roi_size == tuple(jm.roi_size)
    elif branch == "variable_roi":
        assert model.roi_sizes == dict(jm.roi_sizes) and not model.rgb_layers
        assert not jm.use_rgb_enhancement
    else:
        assert model.roi_sizes == tuple(jm.roi_sizes) == (56, 42, 28)
        assert model.fusion_method == jm.fusion_method
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pcfg.model_from_config(make(pcfg))


def test_model_from_config_is_seeded():
    cfg = _variable_roi_cfg(pcfg)
    a, b = (pcfg.model_from_config(cfg, seed=3, device="cpu", mid_channels=16) for _ in range(2))
    assert not a.training
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


SERVE = {
    "baseline": lambda: pbase.ROISegmentationModel(roi_size=(8, 8), mask_size=(16, 16)),
    "variable_roi": lambda: pms.VariableROISegmentationModel(
        {"layer_34": 8, "layer_3": 16}, mask_size=(16, 16), mid_channels=16),
    "multiscale_rgb": lambda: pasm.MultiScaleRGBHierarchicalModel(
        (16, 8), mask_size=(16, 16), image_size=IMG, feature_dim=16),
}


@pytest.mark.parametrize("family", sorted(SERVE))
def test_engine_serves_the_families(family):
    """``InferenceEngine`` serves each family (instance masks, no binary
    mask), the fused head (its plain version on the CPU) equal to the
    unfused forward."""
    pm = SERVE[family]()
    images = _images(b=2)
    inst, binary = InferenceEngine(pm, dilation_pixels=1)(images, ROIS)
    inst_f, binary_f = InferenceEngine(pm, dilation_pixels=1, fused_head=True)(images, ROIS)
    assert binary is None and binary_f is None
    assert inst.shape == (3, 16, 16, 1)
    np.testing.assert_array_equal(inst, inst_f)


@pytest.mark.parametrize("family", ["variable_roi", "multiscale_rgb"])
def test_tiny_loop_trains_the_families(family, tmp_path):
    """``run_training(--tiny)`` trains the variable-ROI and multi-scale RGB
    configs as it trains the flagship: one finite step, none skipped, the
    checkpoint written."""
    name, mods = {"variable_roi": ("baseline", {"model": {"variable_roi_sizes": {
        "layer_3": 16, "layer_34": 8}}}),
                  "multiscale_rgb": ("rgb_hierarchical_unet_v2", {"model": {
                      "multi_scale": True, "roi_sizes": [16, 8]}})}[family]
    metrics, state = run_training(name, steps=1, synthetic=True, tiny=True, device="cpu",
                                  output_dir=str(tmp_path), config_modifications=mods,
                                  return_state=True)
    assert type(state.model).__name__ == BRANCHES[family][1]
    assert state.step == 1 and state.skipped == 0 and np.isfinite(metrics["total_loss"])
    assert (tmp_path / "checkpoints" / "ckpt_1.pt").exists()


def test_loop_refuses_the_baseline(tmp_path):
    """ROADMAP C15: the baseline's aux holds only ``features``, which the
    hierarchical loss cannot train on; the loop raises before the first
    step, naming the key and the config."""
    with pytest.raises(ValueError) as e:
        run_training("baseline", steps=1, synthetic=True, tiny=True, device="cpu",
                     output_dir=str(tmp_path))
    assert "'baseline'" in str(e.value) and "bg_fg_logits" in str(e.value)
    assert not (tmp_path / "checkpoints").exists()


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

class _JDeconv(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(256, (4, 4), strides=(2, 2), padding="SAME", name="up1")(x)


class _PDeconv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.up1 = torch.nn.ConvTranspose2d(256, 256, 4, stride=2, padding=1)

    def forward(self, x):
        return self.up1(x)


@pytest.mark.parametrize("with_model", [True, False])
def test_transposed_conv_kernel_converts(with_model):
    """A (4, 4, 256, 256) ``nn.ConvTranspose`` kernel with random,
    asymmetric taps (Ci = Co, so a missing flip or a swapped Ci/Co still
    has the right shape) converts to the ConvTranspose2d that computes JAX's
    output: found by module type with ``model``, by the baseline's name
    without."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 3, 5, 256)).astype(np.float32)
    v = {"params": {"up1": {
        "kernel": (rng.standard_normal((4, 4, 256, 256)) / 64).astype(np.float32),
        "bias": rng.standard_normal(256).astype(np.float32)}}}
    want = _japply(_JDeconv(), v, x)
    pm = _PDeconv()
    pm.load_state_dict(from_jax_params(v, pm if with_model else None), strict=True)
    with torch.no_grad():
        got = pm(_nchw(x))
    assert got.shape == (1, 256, 6, 10)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("heads,features", [(1, 4), (2, 6)])
def test_attention_kernels_convert(heads, features):
    """flax ``SelfAttention``'s ``DenseGeneral`` kernels (q/k/v (in, heads,
    head_dim), out (heads, head_dim, out)) and biases into the port's
    :class:`SelfAttention`: equal outputs, V4's one head and two heads."""
    jm = fnn.SelfAttention(num_heads=heads, qkv_features=4)
    tokens = np.random.default_rng(8).standard_normal((2, 10, features)).astype(np.float32)
    v = _vars(jm, jnp.zeros((1, 10, features)))
    v["params"] = jax.tree.map(lambda a: a + np.float32(0.1), v["params"])  # biases off 0
    assert v["params"]["query"]["kernel"].shape == (features, heads, 4 // heads)
    pm = load_jax_params(pheads.SelfAttention(features, heads, 4), v)
    with torch.no_grad():
        got = pm(_t(tokens))
    _close(got.numpy(), _japply(jm, v, tokens))


def test_fusion_weights_keep_their_name():
    w = np.asarray([0.3, -1.0, 2.0], np.float32)
    state = from_jax_params({"params": {"fusion": {"fusion_weights": w}}})
    assert list(state) == ["fusion.fusion_weights"]
    np.testing.assert_array_equal(state["fusion.fusion_weights"].numpy(), w)
