"""Train state: the model (its float32 master parameters and frozen
statistics), the optimizer with its state, the loss EMA state, the
generator every random draw of a step comes from, the step count and the
count of skipped steps.

Counterpart of the JAX package's ``training/state.py`` (without
``distill_state``, which waits for the distillation losses, ROADMAP A7).
The JAX state is a pytree the step returns anew; here the step updates
the state in place and returns it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

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

    @classmethod
    def create(cls, model: nn.Module, tx: Transform, seed: int = 1) -> "TrainState":
        """A fresh state over ``model`` (its device is the state's): step 0,
        ``tx`` initialised on every parameter, the loss EMA uninitialised,
        a generator on the model's device seeded with ``seed``."""
        device = next(model.parameters()).device
        return cls(step=0, model=model, optimizer=tx.init(model),
                   loss_state=HierarchicalLossState.create(device),
                   generator=torch.Generator(device=device).manual_seed(seed), skipped=0)
