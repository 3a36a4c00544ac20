"""Progressive feature activation, and weight transfer between models.

Counterpart of the JAX package's ``training/progressive.py``. The model,
and so its parameters, stay the same from step 0; a scheduled feature's
loss term starts contributing at its epoch, and the train step is rebuilt
then. :func:`transfer_weights` warm-starts one model from another of a
different architecture (the reference's
``ProgressiveModelBuilder.transfer_weights``), over ``state_dict``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple, Union

import torch
from torch import nn

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


# ---------------------------------------------------------------------------
# Cross-model weight transfer
# ---------------------------------------------------------------------------

# the port's leaf names -> the JAX tree's, for walking in JAX's order
_JAX_LEAF = {"running_mean": "mean", "running_var": "var"}


def _jax_order(path: Tuple[str, ...], t: torch.Tensor) -> Tuple[str, ...]:
    """The sort key of a leaf in ``tree_flatten_with_path`` order: its path
    components with the JAX leaf name (a 4-D ``weight`` is a conv
    ``kernel``, another ``weight`` a norm ``scale``), compared as strings,
    so flax's auto-names sort as JAX sorts them (``Conv_0`` < ``Conv_1`` <
    ``Conv_10`` < ``Conv_2``)."""
    leaf = path[-1]
    if leaf == "weight":
        leaf = "kernel" if t.dim() == 4 else "scale"
    return path[:-1] + (_JAX_LEAF.get(leaf, leaf),)


def _flatten(tree: Union[nn.Module, Mapping[str, torch.Tensor]]):
    state = tree.state_dict() if isinstance(tree, nn.Module) else tree
    leaves = {tuple(k.split(".")): v for k, v in state.items()}
    return dict(sorted(leaves.items(), key=lambda kv: _jax_order(*kv)))


def shapes_match(a: torch.Tensor, b: torch.Tensor) -> bool:
    return tuple(a.shape) == tuple(b.shape)


def transfer_weights(
    source: Union[nn.Module, Mapping[str, torch.Tensor]],
    target: Union[nn.Module, Mapping[str, torch.Tensor]],
    strict: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Copy every source leaf whose path and shape match into the target.

    A leaf's path is its ``state_dict`` name split on ``.`` (the port's
    module names follow the JAX tree). Exact path matches first; with
    ``strict=False``, an unmatched source leaf then tries a suffix match
    (the last two path components, in the port's own names: ``weight``
    where JAX has ``kernel`` or ``scale``), taking the first target leaf of
    the same shape not already written. Both models are walked in the JAX
    tree's order (:func:`_jax_order`), so the suffix matches pick the
    leaves JAX's ``transfer_weights`` picks.

    Returns ``(state_dict, report)``: the target's ``state_dict`` (its key
    order) with the copied values, for ``load_state_dict``, and a report
    mapping each "/"-joined source path to "copied",
    "suffix:<target path>", "shape_mismatch" or "missing", with a
    ``_summary`` line. Neither model is changed.
    """
    src = _flatten(source)
    dst = _flatten(target)
    out = dict(dst)
    written = set()
    report: Dict[str, Any] = {}

    for path, leaf in src.items():
        key = "/".join(path)
        if path in dst:
            if shapes_match(leaf, dst[path]):
                out[path] = leaf
                written.add(path)
                report[key] = "copied"
            else:
                report[key] = "shape_mismatch"
            continue
        if strict:
            report[key] = "missing"
            continue
        suffix = path[-2:]
        for tpath in dst:
            if tpath[-2:] == suffix and tpath not in written and shapes_match(leaf, dst[tpath]):
                out[tpath] = leaf
                written.add(tpath)
                report[key] = "suffix:" + "/".join(tpath)
                break
        else:
            report[key] = "missing"

    state = target.state_dict() if isinstance(target, nn.Module) else target
    new_state = {}
    for k, v in state.items():
        t = out[tuple(k.split("."))]
        new_state[k] = t.detach().to(device=v.device, dtype=v.dtype).clone()
    n_copied = sum(1 for v in report.values() if v not in ("missing", "shape_mismatch"))
    report["_summary"] = f"transferred {n_copied}/{len(src)} leaves"
    return new_state, report
