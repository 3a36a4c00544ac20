"""Train state: the model (its float32 master parameters and frozen
statistics), the optimizer with its state, the loss EMA state, the
generator every random draw of a step comes from, the step count, the
count of skipped steps and, for a distillation run, the distillation
schedule state.

Counterpart of the JAX package's ``training/state.py``. The JAX state is a
pytree the step returns anew; here the step updates the state in place and
returns it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..losses.distillation import DistillationState
from ..losses.hierarchical import HierarchicalLossState
from .optim import Optimizer, Transform


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    loss_state: HierarchicalLossState
    generator: torch.Generator
    # NaN guard telemetry: steps whose loss or gradients were not finite
    skipped: int = 0
    # temperature / adaptive-alpha state of a distillation run
    distill_state: Optional[DistillationState] = None

    @classmethod
    def create(cls, model: nn.Module, tx: Transform, seed: int = 1,
               distill_state: Optional[DistillationState] = None) -> "TrainState":
        """A fresh state over ``model`` (its device is the state's): step 0,
        ``tx`` initialised on every parameter (or ``tx`` itself where it is
        an already built :class:`Optimizer`), the loss EMA uninitialised, a
        generator on the model's device seeded with ``seed``, and
        ``distill_state`` moved to that device."""
        device = next(model.parameters()).device
        if distill_state is not None:
            distill_state = DistillationState.from_state_dict(distill_state.state_dict(), device)
        return cls(step=0, model=model,
                   optimizer=tx if isinstance(tx, Optimizer) else tx.init(model),
                   loss_state=HierarchicalLossState.create(device),
                   generator=torch.Generator(device=device).manual_seed(seed), skipped=0,
                   distill_state=distill_state)
