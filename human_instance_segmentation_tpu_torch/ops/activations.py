"""Activation factory: the part of the JAX package's factory the flagship uses."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def get_activation(name: str = "relu") -> Callable[[torch.Tensor], torch.Tensor]:
    if name.lower() == "relu":
        return F.relu
    raise NotImplementedError(f"activation {name!r} is not ported yet")
