"""Experiment configuration system.

Counterpart of the JAX package's ``config.py``, copied whole (the port
imports nothing of the JAX package): the nine nested dataclass groups, the
named-experiment registry generated from the naming grammar, ``_deep_merge``
(the ``--config_modifications`` JSON merge), ``parse_sizes_from_name`` and
``loss_config_from_experiment``. The configs are equal field for field
(``to_dict()``) to the JAX package's.

:func:`model_from_config` builds the port's model of any config, with
seeded random weights on a device: every family of the JAX dispatch (the
full-image flagship, the ROI-pretrained, pure-RGB and multi-scale RGB
hierarchical models, the variable-ROI and the baseline models).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

Size = Union[int, Tuple[int, int]]


def _as_hw(size: Size) -> Tuple[int, int]:
    if isinstance(size, (tuple, list)):
        return int(size[0]), int(size[1])
    return int(size), int(size)


@dataclass
class ModelConfig:
    """Architecture selection (mirrors config_manager.py:147-190)."""

    num_classes: int = 3
    roi_size: Size = 28
    mask_size: Size = 56
    image_size: Size = (640, 640)  # (h, w) the jitted graph is built for
    # Architecture family flags
    use_hierarchical: bool = False
    use_hierarchical_unet_v2: bool = True
    use_rgb_hierarchical: bool = True
    use_attention_module: bool = False
    # Refinement modules
    use_boundary_refinement: bool = False
    use_active_contour_loss: bool = False
    use_progressive_upsampling: bool = False
    use_subpixel_conv: bool = False
    use_contour_detection: bool = False
    use_distance_transform: bool = False
    use_boundary_aware_loss: bool = False
    # Activation / normalization
    activation_function: str = "relu"
    activation_beta: float = 1.0
    normalization_type: str = "layernorm2d"
    normalization_groups: int = 8
    # Pre-trained stage-1 UNet
    use_pretrained_unet: bool = False
    pretrained_weights_path: str = ""
    freeze_pretrained_weights: bool = False
    use_full_image_unet: bool = False
    encoder_name: str = "b3"  # efficientnet variant of the stage-1 encoder
    # Hierarchical head capacity
    hierarchical_base_channels: int = 64
    hierarchical_depth: int = 3
    # Stage-2 head width (mid_channels of the hierarchical heads). The
    # reference hardcodes 256 (hierarchical_segmentation_rgb.py:657-673);
    # 128 is the "fast" serving family distilled from the 256-wide
    # flagship (stage-2 carries 68% of program FLOPs — scripts/
    # profile_stage2.py — and the head stack scales quadratically here).
    head_mid_channels: int = 256
    # Multi-scale RGB
    multi_scale: bool = False
    roi_sizes: Optional[Tuple[int, ...]] = None
    fusion_method: str = "concat"
    # Variable per-layer ROI sizes (variable_roi_model.py experiments)
    variable_roi_sizes: Optional[Dict[str, int]] = None
    use_rgb_enhancement: bool = False
    rgb_enhanced_layers: Tuple[str, ...] = ("layer_34",)


@dataclass
class DataConfig:
    train_annotation: str = "data/annotations/instances_train2017_person_only_no_crowd.json"
    val_annotation: str = "data/annotations/instances_val2017_person_only_no_crowd_100.json"
    train_img_dir: str = "data/images/train2017"
    val_img_dir: str = "data/images/val2017"
    data_stats: str = "data_analyze_full.json"
    prefetch: int = 2          # device prefetch depth (replaces pin_memory)
    num_workers: int = 4
    roi_padding: float = 0.0
    rois_per_image: int = 8    # static ROI bucket per image
    use_augmentation: bool = True
    use_heavy_augmentation: bool = False


@dataclass
class TrainingConfig:
    batch_size: int = 8
    learning_rate: float = 1e-3
    num_epochs: int = 100
    optimizer: str = "adamw"
    weight_decay: float = 1e-4
    scheduler: str = "cosine"
    min_lr: float = 1e-6
    warmup_epochs: int = 5
    gradient_clip: float = 5.0
    compute_dtype: str = "bfloat16"  # forward and backward dtype; masters stay float32
    validate_every: int = 1
    save_every: int = 1
    early_stopping_patience: int = 10
    ce_weight: float = 1.0
    dice_weight: float = 1.0
    use_focal: bool = False
    focal_gamma: float = 2.0
    # Staged freezing: epoch -> stage flags (staged_training.py:10-242);
    # keys: freeze_pretrained / freeze_rgb_extractor / freeze_head / lr_scale
    stage_schedule: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    # Progressive feature activation: feature name -> activation epoch
    # (experiments/progressive_training.py:12-66). The parameter tree stays
    # static; scheduled features' LOSS terms switch on at their epoch
    # (training/progressive.py). Keys: see progressive.FEATURE_FLAGS.
    feature_schedule: Dict[str, int] = field(default_factory=dict)


@dataclass
class MultiScaleConfig:
    enabled: bool = False
    fusion_method: str = "adaptive"
    fusion_channels: int = 256


@dataclass
class DistanceLossConfig:
    enabled: bool = False
    boundary_width: int = 5
    boundary_weight: float = 2.0
    instance_sep_weight: float = 3.0
    adaptive: bool = False
    adaptation_rate: float = 0.01


@dataclass
class CascadeConfig:
    enabled: bool = False
    num_stages: int = 3
    stage_weights: Tuple[float, ...] = (0.3, 0.3, 0.4)
    share_features: bool = True


@dataclass
class RelationalConfig:
    enabled: bool = False
    num_heads: int = 8
    dropout: float = 0.1


@dataclass
class AuxiliaryTaskConfig:
    enabled: bool = False
    weight: float = 0.3
    mid_channels: int = 128
    pos_weight: Optional[float] = None


@dataclass
class DistillationConfig:
    """KD config — temperature progression and progressive unfreezing are
    first-class fields here (the reference smuggles them through
    feature_match_layers strings)."""

    enabled: bool = False
    teacher_encoder: str = "b3"
    teacher_checkpoint: str = ""
    student_encoder: str = "b0"
    temperature: float = 4.0
    alpha: float = 0.7
    task_weight: float = 0.3
    distill_logits: bool = True
    distill_features: bool = False
    freeze_teacher: bool = True
    # YOLO feature-matching distillation (the reference smuggles these
    # through feature_match_layers strings, config_manager.py:4975-4989)
    feature_match_layer: str = ""
    feature_match_loss: str = "mse"
    feature_match_weight: float = 0.5
    feature_match_hidden_dim: int = 768
    # Temperature progression (real fields)
    use_temperature_scheduling: bool = False
    initial_temperature: float = 10.0
    final_temperature: float = 1.0
    temperature_schedule: str = "cosine"  # linear | cosine | exponential
    # Progressive encoder unfreezing: {epoch: num_blocks}
    progressive_unfreeze: bool = False
    unfreeze_schedule: Dict[int, int] = field(default_factory=dict)
    unfreeze_encoder_lr_scale: float = 0.3
    # Adaptive distillation
    adaptive_distillation: bool = True
    amplification_factor: float = 30.0
    min_alpha: float = 0.0
    zero_distillation_threshold: float = 0.03


_GROUPS = {
    "model": ModelConfig,
    "data": DataConfig,
    "training": TrainingConfig,
    "multiscale": MultiScaleConfig,
    "distance_loss": DistanceLossConfig,
    "cascade": CascadeConfig,
    "relational": RelationalConfig,
    "auxiliary_task": AuxiliaryTaskConfig,
    "distillation": DistillationConfig,
}


@dataclass
class ExperimentConfig:
    name: str
    description: str = ""
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    multiscale: MultiScaleConfig = field(default_factory=MultiScaleConfig)
    distance_loss: DistanceLossConfig = field(default_factory=DistanceLossConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    relational: RelationalConfig = field(default_factory=RelationalConfig)
    auxiliary_task: AuxiliaryTaskConfig = field(default_factory=AuxiliaryTaskConfig)
    distillation: DistillationConfig = field(default_factory=DistillationConfig)
    output_dir: str = "experiments"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ExperimentConfig":
        data = dict(data)
        for key, group_cls in _GROUPS.items():
            if key in data and isinstance(data[key], dict):
                d = dict(data[key])
                for k, v in list(d.items()):
                    # JSON has no tuples; no group field legitimately holds
                    # a mutable list, so restore every sequence to a tuple.
                    if isinstance(v, list):
                        d[k] = tuple(v)
                if group_cls is DistillationConfig and "unfreeze_schedule" in d:
                    d["unfreeze_schedule"] = {int(k): int(v) for k, v in d["unfreeze_schedule"].items()}
                if group_cls is TrainingConfig and "stage_schedule" in d:
                    d["stage_schedule"] = {int(k): dict(v) for k, v in d["stage_schedule"].items()}
                data[key] = group_cls(**d)
        return cls(**data)

    def save(self, path: str) -> None:
        p = Path(path)
        data = self.to_dict()
        if p.suffix == ".json":
            p.write_text(json.dumps(data, indent=2, default=list))
        elif p.suffix in (".yaml", ".yml"):
            import yaml

            p.write_text(yaml.dump(data, default_flow_style=False))
        else:
            raise ValueError(f"unsupported config format: {p.suffix}")

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        p = Path(path)
        if p.suffix == ".json":
            data = json.loads(p.read_text())
        elif p.suffix in (".yaml", ".yml"):
            import yaml

            data = yaml.safe_load(p.read_text())
        else:
            raise ValueError(f"unsupported config format: {p.suffix}")
        return cls.from_dict(data)


def _deep_merge(cfg: ExperimentConfig, mods: Dict[str, Any]) -> ExperimentConfig:
    data = cfg.to_dict()

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(data, mods)
    return ExperimentConfig.from_dict(data)


# ---------------------------------------------------------------------------
# Registry (generated from the reference naming grammar)
# ---------------------------------------------------------------------------

_SIZE_GRID = [  # (roi, mask) square families from the reference registry
    (112, 224), (112, 192), (112, 160), (112, 112),
    (96, 192), (96, 160), (96, 112), (96, 96),
    (80, 160), (80, 112), (80, 96), (80, 80),
    (64, 112), (64, 96), (64, 80), (64, 64),
]

# Deployed flagship size variants (export CLI grammar
# export_hierarchical_instance_peopleseg_onnx.py:30-64): arch -> (roi, mask)
FLAGSHIP_SIZES = {
    "b0": ((64, 48), (128, 96)),
    "b1": ((80, 60), (160, 120)),
    "b7": ((128, 96), (256, 192)),
}


def _base_v2(name: str, roi: Size, mask: Size, **model_kw) -> ExperimentConfig:
    return ExperimentConfig(
        name=name,
        model=ModelConfig(roi_size=roi, mask_size=mask,
                          use_rgb_hierarchical=True, use_hierarchical_unet_v2=True,
                          **model_kw),
    )


def _build_registry() -> Dict[str, ExperimentConfig]:
    r: Dict[str, ExperimentConfig] = {}

    r["baseline"] = ExperimentConfig(
        name="baseline",
        description="Baseline ROI segmentation head (model.py:61-351 equivalent)",
        model=ModelConfig(use_rgb_hierarchical=False, use_hierarchical_unet_v2=False,
                          roi_size=28, mask_size=56),
    )

    r["rgb_hierarchical_unet_v2"] = _base_v2("rgb_hierarchical_unet_v2", 28, 56)
    r["rgb_hierarchical_unet_v2_attention"] = _base_v2(
        "rgb_hierarchical_unet_v2_attention", 28, 56, use_attention_module=True)

    for roi, mask in _SIZE_GRID:
        name = f"rgb_hierarchical_unet_v2_attention_r{roi}m{mask}"
        r[name] = _base_v2(name, roi, mask, use_attention_module=True)
        rname = name + "_refined"
        r[rname] = _base_v2(rname, roi, mask, use_attention_module=True,
                            use_boundary_refinement=True, use_contour_detection=True,
                            use_distance_transform=True)

    # refinement/norm ablations on r64m64 (config_manager registry block)
    for suffix, kw in {
        "refined_contour_activecontourloss_distance_boundaryrefinement": dict(
            use_contour_detection=True, use_active_contour_loss=True,
            use_distance_transform=True, use_boundary_refinement=True),
        "refined_contour_activecontourloss_distance_groupnorm": dict(
            use_contour_detection=True, use_active_contour_loss=True,
            use_distance_transform=True, normalization_type="groupnorm"),
        "refined_contour_activecontourloss_distance_batchnorm": dict(
            use_contour_detection=True, use_active_contour_loss=True,
            use_distance_transform=True, normalization_type="batchnorm"),
        "refined_contour_distance_batchnorm": dict(
            use_contour_detection=True, use_distance_transform=True,
            normalization_type="batchnorm"),
        "refined_boundaryref_contour_distance_batchnorm": dict(
            use_boundary_refinement=True, use_contour_detection=True,
            use_distance_transform=True, normalization_type="batchnorm"),
        "refined_boundaryref_contour_batchnorm": dict(
            use_boundary_refinement=True, use_contour_detection=True,
            normalization_type="batchnorm"),
        "refined_batchnorm": dict(normalization_type="batchnorm"),
    }.items():
        name = f"rgb_hierarchical_unet_v2_attention_r64m64_{suffix}"
        r[name] = _base_v2(name, 64, 64, use_attention_module=True, **kw)

    name = "rgb_hierarchical_unet_v2_attention_r64x48m64x48_refined_batchnorm"
    r[name] = _base_v2(name, (64, 48), (64, 48), use_attention_module=True,
                       normalization_type="batchnorm")

    # ROI-cropped pretrained peopleseg variants
    for name, frozen in (
        ("rgb_hierarchical_unet_v2_pretrained_peopleseg_r64x48m64x48", False),
        ("rgb_hierarchical_unet_v2_pretrained_peopleseg_frozen_r64x48m64x48", True),
    ):
        r[name] = _base_v2(name, (64, 48), (64, 48), use_pretrained_unet=True,
                           freeze_pretrained_weights=frozen)

    # Flagship full-image family (the deployed configs)
    base_name = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_"
                 "r64x48m64x48_disttrans_contdet_baware")
    r[base_name] = _base_v2(
        base_name, (64, 48), (64, 48), use_pretrained_unet=True,
        use_full_image_unet=True, freeze_pretrained_weights=True,
        use_distance_transform=True, use_contour_detection=True,
        use_boundary_aware_loss=True, hierarchical_base_channels=96)

    # "Fast" serving flagship: identical pipeline with a 128-wide stage-2
    # head (half mid_channels). No reference analogue — it exists because
    # stage-2 is 68% of the JAX program's FLOPs and the head stack scales
    # ~quadratically in mid_channels; trained by hierarchical KD from the
    # 256-wide flagship (training/distill.py:make_hierarchical_distill_step).
    # Gated at DEPLOYED scale (B0, 480x640, scripts/exp_b0_fast_deployed.py,
    # results in scripts/results/b0_fast_deployed.jsonl): teacher mid256 val
    # target-mIoU 0.9548 vs KD mid128 student 0.9547 (-0.0001, PASS; scratch
    # mid128 0.9515). Serving: 31.82 vs 34.62 ms/batch-32 (1006 vs 924
    # img/s, scripts/results/serving_matrix.jsonl) — bench.py serves this
    # family. Narrower axes (mid96, fd128, half-width stage-1 decoder) all
    # measured SLOWER on v5e's 128-lane layout; 128 is the floor.
    fast_name = base_name + "_fast"
    r[fast_name] = _base_v2(
        fast_name, (64, 48), (64, 48), use_pretrained_unet=True,
        use_full_image_unet=True, freeze_pretrained_weights=True,
        use_distance_transform=True, use_contour_detection=True,
        use_boundary_aware_loss=True, hierarchical_base_channels=96,
        head_mid_channels=128)

    # Progressive feature activation on the flagship: refinement loss terms
    # switch on at scheduled epochs (the reference's base_epochs=10 default
    # ladder, experiments/progressive_training.py:29-36) while the model —
    # and therefore the parameter tree — stays fixed from step 0.
    pname = base_name + "_progressive"
    pcfg = _base_v2(
        pname, (64, 48), (64, 48), use_pretrained_unet=True,
        use_full_image_unet=True, freeze_pretrained_weights=True,
        use_distance_transform=True, use_contour_detection=True,
        use_boundary_aware_loss=True, hierarchical_base_channels=96)
    pcfg.training.feature_schedule = {
        "contour_detection": 10, "distance_transform": 20,
        "boundary_aware": 30}
    r[pname] = pcfg

    # Full-image family grid: exact reference name set (capital-B arch tags,
    # config_manager.py fullimage block) plus lowercase aliases for CLI
    # ergonomics. mask = 2x roi throughout.
    _FULLIMAGE_ROIS = {
        "B0": [(32, 24), (64, 48), (80, 60), (96, 72), (112, 84), (128, 96)],
        "B1": [(32, 24), (64, 48), (80, 60), (96, 72), (112, 84), (128, 96)],
        "B7": [(64, 48), (80, 60)],
    }
    _FULLIMAGE_ENHANCED = {
        "B0": [(64, 48), (80, 60)],
        "B1": [(64, 48), (80, 60)],
        "B7": [(64, 48), (80, 60), (128, 96)],
    }

    def _fullimage(name, arch, rh, rw, enhanced):
        return _base_v2(
            name, (rh, rw), (rh * 2, rw * 2), use_pretrained_unet=True,
            use_full_image_unet=True, freeze_pretrained_weights=True,
            use_distance_transform=True, use_contour_detection=True,
            use_boundary_aware_loss=True, encoder_name=arch.lower(),
            hierarchical_base_channels=128 if enhanced else 96,
            hierarchical_depth=4 if enhanced else 3,
        )

    for grid, enhanced in ((_FULLIMAGE_ROIS, False), (_FULLIMAGE_ENHANCED, True)):
        for arch, sizes in grid.items():
            for rh, rw in sizes:
                stem = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_"
                        f"r{rh}x{rw}m{rh * 2}x{rw * 2}_disttrans_contdet_baware_from_")
                suffix = "_enhanced" if enhanced else ""
                for tag in (arch, arch.lower()):
                    name = stem + tag + suffix
                    r[name] = _fullimage(name, arch, rh, rw, enhanced)

    # Binary-UNet distillation family (temperature progression)
    for student, teacher in [("b0", "b3"), ("b0", "b7"), ("b1", "b3"), ("b1", "b7"),
                             ("b3", "b3"), ("b6", "b7"), ("b7", "b3"), ("b7", "b7")]:
        for variant in ("", "_temp", "_temp_prog"):
            if variant and (student, teacher) != ("b0", "b3") and variant != "_temp_prog":
                continue
            name = f"rgb_hierarchical_unet_v2_distillation_{student}_from_{teacher}{variant}"
            if variant == "" and (student, teacher) != ("b0", "b3"):
                continue
            r[name] = ExperimentConfig(
                name=name,
                model=ModelConfig(encoder_name=student),
                distillation=DistillationConfig(
                    enabled=True, student_encoder=student, teacher_encoder=teacher,
                    use_temperature_scheduling=variant in ("_temp", "_temp_prog"),
                    initial_temperature=4.0 if variant == "_temp" else 10.0,
                    final_temperature=1.0,
                    temperature_schedule="cosine",
                    progressive_unfreeze=variant == "_temp_prog",
                    unfreeze_schedule={10: 2, 20: 4, 30: 7} if variant == "_temp_prog" else {},
                ),
            )

    # YOLO feature-alignment distillation (config_manager.py:4922-5017):
    # UNet-only KD from B3 with MSE feature matching against YOLOv9
    # intermediate features (here: ConvFeaturePyramid stand-in features).
    yname = "rgb_hierarchical_unet_v2_distillation_b0_from_b3_yolo"
    r[yname] = ExperimentConfig(
        name=yname,
        description="UNet distillation B3->B0 with YOLO feature alignment",
        model=ModelConfig(encoder_name="b0", use_rgb_hierarchical=False,
                          use_hierarchical_unet_v2=False,
                          normalization_type="batchnorm"),
        training=TrainingConfig(learning_rate=1e-4, warmup_epochs=5,
                                num_epochs=50, batch_size=4,
                                dice_weight=1.0, ce_weight=0.5),
        distillation=DistillationConfig(
            enabled=True, student_encoder="b0", teacher_encoder="b3",
            temperature=3.0, alpha=0.3, distill_logits=True,
            distill_features=True,
            feature_match_layer="layer_34", feature_match_loss="mse",
            feature_match_weight=0.5, feature_match_hidden_dim=768,
            use_temperature_scheduling=True, initial_temperature=3.0,
            final_temperature=1.0, temperature_schedule="cosine"),
        data=DataConfig(use_heavy_augmentation=True),
    )

    r["rgb_hierarchical_unet_v2_finetune_b7"] = ExperimentConfig(
        name="rgb_hierarchical_unet_v2_finetune_b7",
        model=ModelConfig(encoder_name="b7"),
        training=TrainingConfig(learning_rate=1e-4),
    )
    return r


class ConfigManager:
    """Named-experiment lookup (config_manager.py:275-5054 equivalent)."""

    _REGISTRY: Optional[Dict[str, ExperimentConfig]] = None

    @classmethod
    def registry(cls) -> Dict[str, ExperimentConfig]:
        if cls._REGISTRY is None:
            cls._REGISTRY = _build_registry()
        return cls._REGISTRY

    @classmethod
    def get_config(cls, name: str) -> ExperimentConfig:
        reg = cls.registry()
        if name not in reg:
            raise KeyError(
                f"unknown experiment '{name}'; see ConfigManager.list_configs()")
        return copy.deepcopy(reg[name])

    @classmethod
    def list_configs(cls) -> List[str]:
        return sorted(cls.registry().keys())

    @classmethod
    def create_custom_config(cls, base_name: str, name: str,
                             modifications: Dict[str, Any]) -> ExperimentConfig:
        cfg = cls.get_config(base_name)
        cfg = _deep_merge(cfg, modifications)
        cfg.name = name
        return cfg


def parse_sizes_from_name(name: str) -> Tuple[Optional[Tuple[int, int]], Optional[Tuple[int, int]]]:
    """Extract (roi, mask) from the r{H}x{W}m{H}x{W} / r{S}m{S} grammar
    (export_hierarchical_instance_peopleseg_onnx.py:184-204)."""
    m = re.search(r"r(\d+)x(\d+)m(\d+)x(\d+)", name)
    if m:
        return (int(m[1]), int(m[2])), (int(m[3]), int(m[4]))
    m = re.search(r"r(\d+)m(\d+)", name)
    if m:
        return (int(m[1]), int(m[1])), (int(m[2]), int(m[2]))
    return None, None


def loss_config_from_experiment(cfg: ExperimentConfig):
    """Build the RefinedLossConfig a config describes — TrainingConfig's
    ce/dice/focal knobs, data_stats-derived class weights
    (train_advanced.py:999-1003 -> build_loss_function), the model's
    refinement flags, and the DistanceLossConfig group."""
    from .losses.distance_aware import DistanceAwareLossConfig
    from .losses.hierarchical import HierarchicalLossConfig, RefinedLossConfig
    from .losses.segmentation import class_weights_from_pixel_ratios

    t = cfg.training
    final_w = None
    stats_path = Path(cfg.data.data_stats)
    if stats_path.exists():
        stats = json.loads(stats_path.read_text())
        ratios = stats.get("pixel_ratios")
        if ratios:
            final_w = class_weights_from_pixel_ratios(ratios)

    base = HierarchicalLossConfig(
        bg_weight=1.5, fg_weight=1.5, target_weight=1.2, consistency_weight=0.3,
        ce_weight=t.ce_weight, dice_weight=t.dice_weight,
        use_focal=t.use_focal, focal_gamma=t.focal_gamma,
        final_class_weights=final_w)

    da = None
    if cfg.distance_loss.enabled:
        da = DistanceAwareLossConfig(
            boundary_weight=cfg.distance_loss.boundary_weight,
            separation_weight=cfg.distance_loss.instance_sep_weight,
            max_distance=max(cfg.distance_loss.boundary_width, 1))

    return RefinedLossConfig(
        base=base,
        use_contour_detection=cfg.model.use_contour_detection,
        use_distance_transform=cfg.model.use_distance_transform,
        use_active_contour_loss=cfg.model.use_active_contour_loss,
        use_boundary_aware_loss=cfg.model.use_boundary_aware_loss,
        base_mask_size=_as_hw(cfg.model.mask_size),
        distance_aware=da,
    )


def model_from_config(cfg: ExperimentConfig, seed: int = 0, device="cuda", **overrides):
    """Build the model a config describes, with seeded random weights
    (``inference.init_weights``), in eval mode on ``device``: the GPU unless
    the caller asks for the CPU (no CUDA raises). ``overrides`` go to the
    model's constructor (the tiny run's narrow widths, ``pallas_tail``,
    ``encoder_fused_blocks``).

    The JAX dispatch (JAX config.py:604-658): a config that is not
    hierarchical is :class:`VariableROISegmentationModel` when it names
    ``variable_roi_sizes``, else the baseline :class:`ROISegmentationModel`
    (norm and groups only). The variable-ROI model gets neither
    ``use_rgb_enhancement`` nor ``rgb_enhanced_layers`` from the config, as
    the JAX dispatch passes neither, so its RGB enhancement stays off.
    ``multi_scale`` is :class:`MultiScaleRGBHierarchicalModel` (``roi_sizes``,
    56, 42 and 28 by default, and ``fusion_method``). The full-image
    pretrained family is :class:`HierarchicalInstanceSegmenter` with every
    head flag, norm and activation (and ``pallas_roi_align=False``, the JAX
    model's default, stated because the port's own default differs, ROADMAP
    C5); the ROI-cropped pretrained family is
    :class:`ROIPretrainedHierarchicalModel`; the other hierarchical configs
    are :class:`PureRGBHierarchicalModel`."""
    from .inference import init_weights, resolve_device
    from .models.assembly import (HierarchicalInstanceSegmenter, MultiScaleRGBHierarchicalModel,
                                  PureRGBHierarchicalModel, ROIPretrainedHierarchicalModel)
    from .models.baseline import ROISegmentationModel
    from .models.multiscale import VariableROISegmentationModel

    m = cfg.model
    dev = resolve_device(device)
    roi, mask, img = _as_hw(m.roi_size), _as_hw(m.mask_size), _as_hw(m.image_size)
    common = dict(norm=m.normalization_type, norm_groups=m.normalization_groups,
                  activation=m.activation_function, activation_beta=m.activation_beta,
                  use_attention_module=m.use_attention_module)
    if not (m.use_rgb_hierarchical or m.use_hierarchical_unet_v2 or m.use_hierarchical):
        if m.variable_roi_sizes:
            cls = VariableROISegmentationModel
            kwargs = dict(roi_sizes=dict(m.variable_roi_sizes), mask_size=mask, **common)
        else:
            cls = ROISegmentationModel
            kwargs = dict(roi_size=roi, mask_size=mask, norm=m.normalization_type,
                          norm_groups=m.normalization_groups)
    elif m.multi_scale:
        cls = MultiScaleRGBHierarchicalModel
        kwargs = dict(roi_sizes=tuple(m.roi_sizes or (56, 42, 28)), mask_size=mask,
                      image_size=img, fusion_method=m.fusion_method, **common)
    elif m.use_pretrained_unet and m.use_full_image_unet:
        cls = HierarchicalInstanceSegmenter
        kwargs = dict(
            encoder_variant=m.encoder_name, roi_size=roi, mask_size=mask, image_size=img,
            use_contour_detection=m.use_contour_detection,
            use_distance_transform=m.use_distance_transform,
            use_boundary_refinement=m.use_boundary_refinement,
            use_progressive_upsampling=m.use_progressive_upsampling,
            use_subpixel_conv=m.use_subpixel_conv,
            base_channels=m.hierarchical_base_channels, depth=m.hierarchical_depth,
            mid_channels=m.head_mid_channels, freeze_pretrained=m.freeze_pretrained_weights,
            pallas_roi_align=False, **common)
    elif m.use_pretrained_unet:
        cls = ROIPretrainedHierarchicalModel
        kwargs = dict(encoder_variant=m.encoder_name, roi_size=roi, mask_size=mask,
                      image_size=img, freeze_pretrained=m.freeze_pretrained_weights, **common)
    else:
        cls = PureRGBHierarchicalModel
        kwargs = dict(roi_size=roi, mask_size=mask, image_size=img, **common)
    kwargs.update(overrides)
    model = cls(**kwargs)
    init_weights(model, seed)
    return model.to(dev).eval()
