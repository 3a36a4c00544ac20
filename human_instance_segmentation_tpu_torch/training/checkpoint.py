"""Checkpoints of the whole train state with ``torch.save``.

Counterpart of the JAX package's ``training/checkpoint.py`` (orbax there):
one file per step, ``<directory>/ckpt_<step>.pt``, holding the model's
``state_dict``, the optimizer's state, the loss EMA state, the
distillation state (None outside a distillation run), the step, the
skipped count, the generator's state and the metadata (also written beside
it as ``metadata_<step>.json``, as the JAX package does). Restoring into a
state built the same way gives back a state that continues bit for bit; a
checkpoint written without a distillation state leaves the state's own.
:func:`load_model_state` reads only the model's weights (a teacher's, an
exported model's).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..losses.distillation import DistillationState
from ..losses.hierarchical import HierarchicalLossState
from .state import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def _steps(d: Path):
    return sorted(int(m.group(1)) for f in d.iterdir() if (m := _NAME.match(f.name)))


def save_checkpoint(directory: str, state: TrainState, step: int,
                    metadata: Optional[Dict[str, Any]] = None, max_to_keep: int = 3) -> str:
    """Write ``state`` as step ``step`` (atomically: a temporary file renamed)
    and keep only the newest ``max_to_keep`` checkpoints. Returns the path."""
    d = Path(directory).absolute()
    d.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": int(state.step),
        "skipped": int(state.skipped),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "loss_state": state.loss_state.state_dict(),
        "distill_state": (state.distill_state.state_dict()
                          if state.distill_state is not None else None),
        "generator": state.generator.get_state(),
        "metadata": metadata,
    }
    path = d / f"ckpt_{step}.pt"
    tmp = d / f".ckpt_{step}.pt.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        (d / f"metadata_{step}.json").write_text(json.dumps(metadata, indent=2, default=str))
    for old in _steps(d)[:-max_to_keep] if max_to_keep else []:
        (d / f"ckpt_{old}.pt").unlink()
    return str(path)


def restore_checkpoint(directory: str, state: TrainState,
                       step: Optional[int] = None) -> Tuple[TrainState, int]:
    """Load checkpoint ``step`` (the newest by default) into ``state``, a
    state over the same model and optimizer groups, in place. Returns
    ``(state, step)``."""
    d = Path(directory).absolute()
    if step is None:
        step = latest_step(str(d))
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {d}")
    payload = torch.load(d / f"ckpt_{step}.pt", map_location="cpu", weights_only=True)
    device = next(state.model.parameters()).device
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.loss_state = HierarchicalLossState.from_state_dict(payload["loss_state"], device)
    if payload.get("distill_state") is not None:
        state.distill_state = DistillationState.from_state_dict(payload["distill_state"], device)
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    state.skipped = int(payload["skipped"])
    return state, step


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory).absolute()
    if not d.exists():
        return None
    steps = _steps(d)
    return steps[-1] if steps else None


def load_model_state(path: str, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a checkpoint: ``path`` is a ``ckpt_<step>.pt``
    file, or a checkpoint directory (step ``step``, the newest by default)."""
    p = Path(path).absolute()
    if p.is_dir():
        step = latest_step(str(p)) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {p}")
        p = p / f"ckpt_{step}.pt"
    return torch.load(p, map_location="cpu", weights_only=True)["model"]
