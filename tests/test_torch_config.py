"""The port's config registry and ``model_from_config`` against the JAX
package's, and the import rule of the new modules. Every family builds
the JAX dispatch's class: the flagship, the pure-RGB, ROI-pretrained and
multi-scale RGB models, the variable-ROI model and the baseline.

The registry must be equal name for name and field for field
(``to_dict()``), as must the loss config each experiment describes. For the
flagship family the port's ``model_from_config`` must load, strictly
(``from_jax_params(..., model)``: every leaf consumed, every parameter
filled, equal shapes), the variables of the JAX ``model_from_config`` of
the same config: the parameter trees agree. The variables come from
``jax.eval_shape`` (shapes only, filled with zeros), so no JAX model runs.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu import config as jcfg
from human_instance_segmentation_tpu_torch import config as pcfg
from human_instance_segmentation_tpu_torch import inference
from human_instance_segmentation_tpu_torch.ops.norms import get_normalization
from human_instance_segmentation_tpu_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parents[1]
FAMILY = "rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_"


def test_registry_names_and_fields_equal():
    names = pcfg.ConfigManager.list_configs()
    assert names == jcfg.ConfigManager.list_configs()
    for name in names:
        assert (pcfg.ConfigManager.get_config(name).to_dict()
                == jcfg.ConfigManager.get_config(name).to_dict()), name


def test_loss_configs_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    stats = {"pixel_ratios": {"background": 0.8, "target": 0.15, "non_target": 0.05}}
    (tmp_path / "stats.json").write_text(json.dumps(stats))
    for name in pcfg.ConfigManager.list_configs():
        for mods in ({}, {"data": {"data_stats": "stats.json"},
                          "distance_loss": {"enabled": True, "boundary_width": 3},
                          "training": {"use_focal": True, "ce_weight": 0.5}}):
            p = pcfg._deep_merge(pcfg.ConfigManager.get_config(name), mods)
            j = jcfg._deep_merge(jcfg.ConfigManager.get_config(name), mods)
            assert p.to_dict() == j.to_dict()
            assert (dataclasses.asdict(pcfg.loss_config_from_experiment(p))
                    == dataclasses.asdict(jcfg.loss_config_from_experiment(j))), (name, mods)


@pytest.mark.parametrize("name", ["x_r64x48m128x96_y", "a_r112m224", "r8x6m16x12", "plain"])
def test_parse_sizes_from_name(name):
    assert pcfg.parse_sizes_from_name(name) == jcfg.parse_sizes_from_name(name)


def test_custom_config_and_json_roundtrip(tmp_path):
    mods = {"training": {"learning_rate": 3e-4, "stage_schedule": {"2": {"lr_scale": 0.5}}},
            "model": {"roi_size": [32, 24]}}
    base = FAMILY + "r64x48m128x96_disttrans_contdet_baware_from_b0"
    p = pcfg.ConfigManager.create_custom_config(base, "custom", mods)
    j = jcfg.ConfigManager.create_custom_config(base, "custom", mods)
    assert p.to_dict() == j.to_dict()
    p.save(str(tmp_path / "c.json"))
    assert pcfg.ExperimentConfig.load(str(tmp_path / "c.json")).to_dict() == p.to_dict()
    with pytest.raises(KeyError):
        pcfg.ConfigManager.get_config("no_such_experiment")


# one config per distinct parameter tree of the flagship family: encoder,
# head base/depth (the "enhanced" grid) and head width (the "fast" config)
TREES = [
    FAMILY + "r64x48m128x96_disttrans_contdet_baware_from_b0",
    FAMILY + "r64x48m128x96_disttrans_contdet_baware_from_B0_enhanced",
    FAMILY + "r80x60m160x120_disttrans_contdet_baware_from_b1",
    FAMILY + "r128x96m256x192_disttrans_contdet_baware_from_B7_enhanced",
    FAMILY + "r64x48m64x48_disttrans_contdet_baware_fast",
    FAMILY + "r64x48m64x48_disttrans_contdet_baware_progressive",
]


@pytest.mark.parametrize("name", TREES)
def test_flagship_family_loads_jax_variables_strictly(name):
    pc = pcfg.ConfigManager.get_config(name)
    jc = jcfg.ConfigManager.get_config(name)
    for c in (pc, jc):
        c.model.image_size = (64, 64)  # no parameter depends on it
    jm = jcfg.model_from_config(jc)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 5)),
                                              train=False), jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = pcfg.model_from_config(pc, device="cpu")
    model.load_state_dict(from_jax_params(variables, model), strict=True)
    assert model.freeze_pretrained and not model.pallas_roi_align
    assert not model.training
    m = pc.model
    assert model.roi_size == tuple(m.roi_size) and model.mask_size == tuple(m.mask_size)


def test_model_from_config_is_seeded_and_takes_overrides():
    name = TREES[0]
    cfg = pcfg.ConfigManager.get_config(name)
    cfg.model.encoder_name = "tiny"
    kw = dict(mid_channels=32, feature_dim=32, unet_decoder_channels=(32, 24, 16, 16, 8))
    a = pcfg.model_from_config(cfg, seed=3, device="cpu", **kw)
    b = pcfg.model_from_config(cfg, seed=3, device="cpu", **kw)
    c = pcfg.model_from_config(cfg, seed=4, device="cpu", **kw)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert any(not torch.equal(sa[k], sc[k]) for k in sa)
    assert a.head.base_head.shared_in.conv.out_channels == 32
    tail = pcfg.model_from_config(cfg, device="cpu", pallas_tail=True, encoder_fused_blocks=3,
                                  **kw)
    assert tail.pretrained_unet.pallas_tail and tail.pretrained_unet.encoder.fused_blocks == 3


def _strict_jax_load(jc, model, hw=(64, 64)):
    """Load the JAX ``model_from_config`` variables of ``jc`` (shapes from
    ``jax.eval_shape``, zeros) into ``model`` strictly."""
    jm = jcfg.model_from_config(jc)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, *hw, 3)), jnp.zeros((1, 5)),
                                              train=False), jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model.load_state_dict(from_jax_params(variables, model), strict=True)
    return jm


# The ids are the ones these cases had while the families were out of reach
# (ROADMAP A8): each now builds as the JAX dispatch builds it.
@pytest.mark.parametrize("name,want", [
    pytest.param("baseline", "ROISegmentationModel", id="baseline-A8"),
    pytest.param("rgb_hierarchical_unet_v2", "PureRGBHierarchicalModel",
                 id="rgb_hierarchical_unet_v2-A8"),
    pytest.param("rgb_hierarchical_unet_v2_pretrained_peopleseg_r64x48m64x48",
                 "ROIPretrainedHierarchicalModel",
                 id="rgb_hierarchical_unet_v2_pretrained_peopleseg_r64x48m64x48-A8"),
    pytest.param("rgb_hierarchical_unet_v2_attention_r64m64_refined_batchnorm",
                 "PureRGBHierarchicalModel",
                 id="rgb_hierarchical_unet_v2_attention_r64m64_refined_batchnorm-A8"),
    pytest.param("rgb_hierarchical_unet_v2_distillation_b0_from_b3", "PureRGBHierarchicalModel",
                 id="rgb_hierarchical_unet_v2_distillation_b0_from_b3-A8"),
])
def test_other_families_raise(name, want, monkeypatch):
    """The baseline and the hierarchical configs build the JAX dispatch's
    class and load its variables strictly (the seeded draw is skipped: the
    load overwrites every leaf)."""
    monkeypatch.setattr(inference, "init_weights", lambda model, seed=0: None)
    pc = pcfg.ConfigManager.get_config(name)
    jc = jcfg.ConfigManager.get_config(name)
    for c in (pc, jc):
        c.model.image_size = (64, 64)  # no parameter depends on it
    model = pcfg.model_from_config(pc, device="cpu")
    jm = _strict_jax_load(jc, model)
    assert type(model).__name__ == type(jm).__name__ == want
    assert model.roi_size == tuple(jm.roi_size) and model.mask_size == tuple(jm.mask_size)
    if want == "ROIPretrainedHierarchicalModel":
        assert model.freeze_pretrained is jm.freeze_pretrained is False
    assert not model.training


# The name is the one this test had while both models were refused (ROADMAP
# A8); they now build as the JAX dispatch builds them.
@pytest.mark.parametrize("name", ["rgb_hierarchical_unet_v2_multiscale", "variable_roi"])
def test_multiscale_and_variable_roi_raise(name, monkeypatch):
    """The multi-scale RGB and the variable-ROI configs build the JAX
    dispatch's class with its sizes and load its variables strictly."""
    monkeypatch.setattr(inference, "init_weights", lambda model, seed=0: None)
    cfgs = [c.ConfigManager.get_config("rgb_hierarchical_unet_v2") for c in (pcfg, jcfg)]
    for cfg in cfgs:
        cfg.model.image_size = (64, 64)
        if name == "variable_roi":
            cfg.model.use_rgb_hierarchical = cfg.model.use_hierarchical_unet_v2 = False
            cfg.model.variable_roi_sizes = {"layer_34": 28, "layer_3": 56}
        else:
            cfg.model.multi_scale = True
            cfg.model.fusion_method = "adaptive"
    model = pcfg.model_from_config(cfgs[0], device="cpu")
    jm = _strict_jax_load(cfgs[1], model)
    want = "VariableROISegmentationModel" if name == "variable_roi" else (
        "MultiScaleRGBHierarchicalModel")
    assert type(model).__name__ == type(jm).__name__ == want
    if name == "variable_roi":
        assert model.roi_sizes == dict(jm.roi_sizes) and not model.rgb_layers
    else:
        assert model.roi_sizes == tuple(jm.roi_sizes) == (56, 42, 28)
    assert model.mask_size == tuple(jm.mask_size) and not model.training


def test_every_rgb_family_config_builds(monkeypatch):
    """Every registered config of the pure-RGB and ROI-pretrained families
    builds the JAX dispatch's class with the config's sizes, norm,
    activation, attention flag and (ROI-pretrained) encoder and freezing
    (constructed on the meta device, weights not drawn)."""
    monkeypatch.setattr(inference, "init_weights", lambda model, seed=0: None)
    n = 0
    for name in pcfg.ConfigManager.list_configs():
        m = pcfg.ConfigManager.get_config(name).model
        hier = m.use_rgb_hierarchical or m.use_hierarchical_unet_v2 or m.use_hierarchical
        if not hier or m.multi_scale or (m.use_pretrained_unet and m.use_full_image_unet):
            continue
        jm = jcfg.model_from_config(jcfg.ConfigManager.get_config(name))
        with torch.device("meta"):
            model = pcfg.model_from_config(pcfg.ConfigManager.get_config(name), device="meta")
        assert type(model).__name__ == type(jm).__name__, name
        assert (model.roi_size, model.mask_size, model.image_size) == (
            tuple(jm.roi_size), tuple(jm.mask_size), tuple(jm.image_size)), name
        head = model.head
        assert (head.tnt_satt is not None) == jm.use_attention_module, name
        assert type(head.tnt_norm) is type(get_normalization(jm.norm, 16, jm.norm_groups)), name
        if type(jm).__name__ == "ROIPretrainedHierarchicalModel":
            assert model.freeze_pretrained == jm.freeze_pretrained, name
            assert len(model.pretrained_unet.encoder.stages[1]) == {"b3": 3}[jm.encoder_variant]
        n += 1
    assert n >= 40


# The ids are the ones these cases had while the flags were refused (ROADMAP
# A3): each flag now builds, and the flagship with it loads the JAX model's
# variables strictly.
@pytest.mark.parametrize("mods", [
    {"use_attention_module": True}, {"use_boundary_refinement": True},
    {"use_progressive_upsampling": True}, {"use_subpixel_conv": True},
    {"normalization_type": "batchnorm"}, {"activation_function": "swish"},
    {"freeze_pretrained_weights": False},
])
def test_flagship_modules_not_ported_raise(mods, monkeypatch):
    monkeypatch.setattr(inference, "init_weights", lambda model, seed=0: None)
    pc = pcfg._deep_merge(pcfg.ConfigManager.get_config(TREES[0]), {"model": mods})
    jc = jcfg._deep_merge(jcfg.ConfigManager.get_config(TREES[0]), {"model": mods})
    for c in (pc, jc):
        c.model.encoder_name = "tiny"
        c.model.image_size = (64, 64)
    model = pcfg.model_from_config(pc, device="cpu")
    _strict_jax_load(jc, model)
    assert model.freeze_pretrained == pc.model.freeze_pretrained_weights
    head = model.head
    assert (head.base_head.tnt_satt is not None) == pc.model.use_attention_module
    assert (head.boundary is not None) == pc.model.use_boundary_refinement
    assert (head.progressive is not None) == pc.model.use_progressive_upsampling
    assert (head.subpixel is not None) == pc.model.use_subpixel_conv


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without CUDA")
def test_model_from_config_needs_cuda_by_default():
    cfg = pcfg.ConfigManager.get_config(TREES[0])
    cfg.model.encoder_name = "tiny"
    with pytest.raises(RuntimeError, match="CUDA"):
        pcfg.model_from_config(cfg)


def test_new_modules_import_no_jax():
    """The config, the losses and the training package load neither jax nor
    flax nor the JAX package."""
    code = (
        "import sys\n"
        "import human_instance_segmentation_tpu_torch.config as c\n"
        "import human_instance_segmentation_tpu_torch.losses\n"
        "import human_instance_segmentation_tpu_torch.training.loop\n"
        "import human_instance_segmentation_tpu_torch.training.checkpoint\n"
        "import human_instance_segmentation_tpu_torch.training.logging\n"
        "import human_instance_segmentation_tpu_torch.training.progressive\n"
        "c.loss_config_from_experiment(c.ConfigManager.get_config('baseline'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'orbax', 'human_instance_segmentation_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
