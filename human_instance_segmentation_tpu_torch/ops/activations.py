"""Activation factory (counterpart of the JAX package's ``ops/activations.py``):
relu / swish(beta) / silu / gelu (exact erf form) / sigmoid / tanh /
identity, as plain functions."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def swish(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """x * sigmoid(beta * x); beta = 1 is SiLU."""
    return x * torch.sigmoid(beta * x)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def get_activation(name: str = "relu", beta: float = 1.0) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name.lower()
    if name == "relu":
        return F.relu
    if name in ("silu", "swish"):
        if name == "swish" and beta != 1.0:
            return lambda x: swish(x, beta)
        return F.silu
    if name == "gelu":
        return F.gelu  # the exact (erf) form, as the JAX factory asks
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    if name in ("identity", "none", "linear"):
        return _identity
    raise ValueError(f"Unsupported activation function: {name}")
