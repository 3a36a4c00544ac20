"""Progressive feature activation: refinement loss terms that switch on at
scheduled epochs.

Counterpart of the JAX package's ``training/progressive.py`` without
``transfer_weights`` (ROADMAP A6). The model, and so its parameters, stay
the same from step 0; a scheduled feature's loss term starts contributing
at its epoch, and the train step is rebuilt then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

# feature name -> (config group attr, flag attr)
FEATURE_FLAGS: Dict[str, Tuple[str, str]] = {
    "distance_loss": ("distance_loss", "enabled"),
    "contour_detection": ("model", "use_contour_detection"),
    "distance_transform": ("model", "use_distance_transform"),
    "active_contour": ("model", "use_active_contour_loss"),
    "boundary_aware": ("model", "use_boundary_aware_loss"),
}


def active_features(schedule: Dict[str, int], epoch: int) -> List[str]:
    """Features whose activation epoch has been reached."""
    return sorted(f for f, e in schedule.items() if epoch >= int(e))


def activation_epochs(schedule: Dict[str, int]) -> List[int]:
    """Distinct epochs at which the active-feature set changes."""
    return sorted({int(e) for e in schedule.values()})


def gate_config(cfg: Any, schedule: Dict[str, int], epoch: int) -> Any:
    """Copy of an ExperimentConfig with scheduled features that are not
    active yet switched off (only loss-relevant flags move; the model never
    changes). A feature in the schedule must be on in the base config; the
    schedule decides when its loss term starts contributing."""
    cfg = dataclasses.replace(cfg)
    for feature, start in schedule.items():
        if feature not in FEATURE_FLAGS:
            raise ValueError(
                f"unknown progressive feature {feature!r}; known: {sorted(FEATURE_FLAGS)}")
        group_name, attr = FEATURE_FLAGS[feature]
        group = getattr(cfg, group_name)
        if epoch < int(start):
            setattr(cfg, group_name, dataclasses.replace(group, **{attr: False}))
    return cfg
