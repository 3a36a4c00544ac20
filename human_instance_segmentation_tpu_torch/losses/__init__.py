"""Losses: segmentation, hierarchical with refinement terms, distance-aware,
distillation.

Counterpart of the JAX package's ``losses``.
"""

from .distance_aware import (
    DistanceAwareLossConfig,
    approximate_distance_transform,
    boundary_distance_weights,
    distance_aware_loss,
    instance_separation_weights,
)
from .distillation import (
    DistillationConfig,
    DistillationState,
    binary_dice_loss,
    feature_matching_loss,
    hierarchical_distillation_loss,
    scheduled_temperature,
    unet_distillation_loss,
    update_adaptive_weights,
    yolo_distillation_loss,
)
from .hierarchical import (
    HierarchicalLossConfig,
    HierarchicalLossState,
    RefinedLossConfig,
    active_contour_loss,
    boundary_aware_loss,
    generate_contour_targets,
    generate_distance_targets,
    hierarchical_loss,
    refined_hierarchical_loss,
)
from .segmentation import (
    class_weights_from_pixel_ratios,
    cross_entropy,
    dice_loss,
    focal_loss,
    segmentation_loss,
)

__all__ = [
    "cross_entropy", "dice_loss", "focal_loss", "segmentation_loss",
    "class_weights_from_pixel_ratios",
    "HierarchicalLossState", "HierarchicalLossConfig", "RefinedLossConfig",
    "hierarchical_loss", "refined_hierarchical_loss",
    "active_contour_loss", "boundary_aware_loss",
    "generate_contour_targets", "generate_distance_targets",
    "DistanceAwareLossConfig", "distance_aware_loss",
    "boundary_distance_weights", "instance_separation_weights",
    "approximate_distance_transform",
    "DistillationConfig", "DistillationState", "binary_dice_loss", "feature_matching_loss",
    "hierarchical_distillation_loss", "scheduled_temperature", "unet_distillation_loss",
    "update_adaptive_weights", "yolo_distillation_loss",
]
