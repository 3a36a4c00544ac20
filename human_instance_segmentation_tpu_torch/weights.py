"""Load the JAX package's parameters into the port.

:func:`from_jax_params` takes the JAX model's variables as a nested dict of
numpy arrays (``jax.tree.map(np.asarray, variables)``: ``params`` and
``batch_stats``) and returns a ``state_dict`` for the port's module of the
same architecture. It does not import jax. The port's module names follow
the JAX tree, so a leaf's path maps to a key one to one; the leaves change
as follows:

- conv ``kernel`` (kh, kw, Ci, Co), HWIO -> ``weight`` (Co, Ci, kh, kw), OIHW
  (depthwise (k, k, 1, C) -> (C, 1, k, k));
- a transposed conv's kernel -> ConvTranspose2d ``weight`` (Ci, Co, kh, kw)
  with the spatial taps flipped: lax.conv_transpose cross-correlates the
  zero-stuffed input where torch's transposed conv convolves (as
  ``convert_weights._deconv_p`` does the other way). With ``model`` given, a
  kernel is transposed when its key lands on an ``nn.ConvTranspose2d``;
  without it, by name: ``deconv``/``*_deconv`` (``_TConv2x`` (2, 2, Ci, Co),
  the progressive decoder's ``stage{i}_deconv`` (4, 4, Ci, Co)) and the
  baseline head's raw ``nn.ConvTranspose`` ``up1``/``up2`` (4, 4, Ci, Co);
- a ``DenseGeneral`` kernel of flax's attention (3-D) -> ``nn.Linear``
  ``weight``: ``query``/``key``/``value`` (in, heads, head_dim) -> (heads *
  head_dim, in), ``out`` (heads, head_dim, out) -> (out, heads * head_dim);
  their biases are flattened;
- norm ``scale`` -> ``weight``; ``bias`` stays ``bias``;
- ``batch_stats`` ``mean``/``var`` (BatchNorm, AdaptiveInstanceNorm2d) ->
  ``running_mean``/``running_var``;
- scalars and the foreground-aware norm's affine pairs keep their names
  (``threshold``, ``blend_weight``, ``fg_scale``, ``fg_bias``,
  ``bg_scale``, ``bg_bias``).

A ``MixedNormalization`` initialised for eval in JAX has no
``InstanceNorm2d_0`` parameters (flax creates them in train mode only);
with ``model`` given, the port's are filled with flax's initial values
(scale 1, bias 0).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "threshold"): "threshold",
    ("params", "blend_weight"): "blend_weight",
    ("params", "fg_scale"): "fg_scale",
    ("params", "fg_bias"): "fg_bias",
    ("params", "bg_scale"): "bg_scale",
    ("params", "bg_bias"): "bg_bias",
    ("params", "fusion_weights"): "fusion_weights",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


# the baseline head's raw nn.ConvTranspose modules (JAX baseline.py:48, :52)
_TRANSPOSED_NAMES = ("up1", "up2")


def _transposed_by_name(path: Tuple[str, ...]) -> bool:
    return bool(path) and (path[-1] == "deconv" or path[-1].endswith("_deconv")
                           or path[-1] in _TRANSPOSED_NAMES)


def _convert(collection: str, path: Tuple[str, ...], leaf: str, value: np.ndarray,
             transposed: Callable[[Tuple[str, ...]], bool] = _transposed_by_name):
    """-> (state_dict key, torch tensor) for one JAX leaf; ``transposed(path)``
    says whether a 4-D kernel belongs to a transposed conv."""
    if collection == "params" and leaf == "kernel":
        if value.ndim == 3:  # DenseGeneral: (in, heads, head_dim) or (heads, head_dim, out)
            if path and path[-1] == "out":
                w = value.reshape(-1, value.shape[-1]).T
            else:
                w = value.reshape(value.shape[0], -1).T
        elif value.ndim != 4:
            raise ValueError(f"{'/'.join(path)}/kernel: expected a 4-D kernel, got {value.shape}")
        elif transposed(path):
            w = value[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            w = value.transpose(3, 2, 0, 1)
        return ".".join(path + ("weight",)), torch.tensor(np.ascontiguousarray(w))
    name = _RENAME.get((collection, leaf))
    if name is None:
        raise KeyError(f"no mapping for JAX leaf {collection}/{'/'.join(path + (leaf,))}")
    if name == "bias" and value.ndim > 1:  # DenseGeneral's (heads, head_dim)
        value = value.reshape(-1)
    return ".".join(path + (name,)), torch.tensor(value)


def from_jax_params(variables: Mapping[str, Any],
                    model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """JAX variables (``{"params": ..., "batch_stats": ...}``) -> state_dict.

    With ``model``, every leaf must land on one of the model's parameters or
    buffers with the same shape, and every one of them must be filled;
    otherwise it raises, naming the keys.
    """
    transposed = _transposed_by_name
    if model is not None:
        deconvs = {tuple(name.split(".")) for name, m in model.named_modules()
                   if isinstance(m, nn.ConvTranspose2d)}
        transposed = deconvs.__contains__
    state: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unknown variable collection {collection!r}")
        for path, value in _leaves(tree):
            key, t = _convert(collection, path[:-1], path[-1], value, transposed)
            if key in state:
                raise KeyError(f"two JAX leaves map to {key}")
            state[key] = t
    if model is not None:
        expected = model.state_dict()
        for key, t in expected.items():  # a MixedNormalization initialised for eval
            if key not in state and key.rsplit(".", 2)[-2:-1] == ["InstanceNorm2d_0"]:
                state[key] = torch.ones_like(t) if key.endswith(".weight") else torch.zeros_like(t)
        unconsumed = sorted(set(state) - set(expected))
        unfilled = sorted(set(expected) - set(state))
        if unconsumed or unfilled:
            raise KeyError(f"JAX leaves with no port parameter: {unconsumed}; "
                           f"port parameters no leaf fills: {unfilled}")
        bad = [f"{k}: {tuple(state[k].shape)} vs {tuple(v.shape)}"
               for k, v in expected.items() if tuple(state[k].shape) != tuple(v.shape)]
        if bad:
            raise ValueError("shape mismatch: " + "; ".join(bad))
    return state


def load_jax_params(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Fill ``model`` from JAX variables in place (strict) and return it."""
    state = from_jax_params(variables, model)
    model.load_state_dict(state, strict=True)
    return model
