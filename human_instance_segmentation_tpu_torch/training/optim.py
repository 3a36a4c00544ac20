"""Optimizers, learning-rate schedules and staged freezing.

Counterpart of the JAX package's ``training/optim.py``, computing what its
optax chains compute:

- Schedules are functions of the optimizer's step count, equal to optax's
  ``warmup_cosine_decay_schedule``, ``cosine_decay_schedule`` (with
  ``alpha``), ``join_schedules``, ``exponential_decay`` (staircase and
  ``end_value``) and ``constant_schedule``, computed in float32 in optax's
  order of operations (the warmup's ``(init - end) * frac + end`` cancels,
  so a float64 evaluation would differ by up to 1e-5 relative).
- :class:`Transform` describes one optax chain: ``clip_by_global_norm``
  followed by ``adamw``, ``adam``, ``sgd`` (momentum 0.9) or
  ``set_to_zero``. The clip is optax's rule, written here: with the global
  norm ``n`` of the group's gradients, ``g -> g / n * max_norm`` unless
  ``n < max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to ``n``).
- :class:`Optimizer` applies transforms to parameter groups: every
  parameter of a group is updated at every step, and a parameter that got
  no gradient is given a zero gradient, as optax sees it. So AdamW decays a
  parameter whose gradient is zero (``p -= lr * wd * p``), the frozen
  stage 1 of the flagship included (ROADMAP C6), where
  ``torch.optim.AdamW`` would skip it; only a ``"zero"`` group
  (``optax.set_to_zero``, a staged freeze) keeps its parameters unchanged.
- :func:`label_params` / :func:`staged_optimizer` / :class:`StageConfig` /
  :func:`stage_rules`: name-based staged freezing as parameter groups (the
  JAX package's ``optax.multi_transform`` over path labels). An optimizer's
  own ``clip`` is ``optax.chain(clip_by_global_norm, multi_transform)``: one
  global norm over every parameter's gradient, the frozen ones' included,
  before any group's transform.
- :func:`progressive_unfreeze_rules` / :func:`distillation_optimizer`: the
  distillation path's progressive encoder unfreezing, the decoder at the
  full learning rate and the unfrozen encoder stages at a scaled one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM = 0.9


# ---------------------------------------------------------------------------
# Schedules (optax's, evaluated on the host at the optimizer's step count)
# ---------------------------------------------------------------------------


_F32 = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax ``linear_schedule`` (``polynomial_schedule`` at power 1)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = _F32(min(max(count, 0), transition_steps))
        frac = _F32(1) - c / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"the cosine_decay_schedule requires positive decay_steps, "
                         f"got {decay_steps=}")

    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c / _F32(decay_steps)))
        return float(_F32(init_value) * (_F32(1 - alpha) * cosine + _F32(alpha)))

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = s(step - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps])


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      staircase: bool = False, end_value: Optional[float] = None) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        p = _F32(count) / _F32(transition_steps)
        if staircase:
            p = np.floor(p)
        value = (_F32(init_value) if count <= 0
                 else _F32(init_value) * np.power(_F32(decay_rate), p))
        if end_value is not None:
            clip = np.maximum if decay_rate < 1.0 else np.minimum
            value = clip(value, _F32(end_value))
        return float(value)

    return schedule


def build_schedule(
    learning_rate: float,
    num_epochs: int,
    steps_per_epoch: int,
    scheduler: str = "cosine",
    min_lr: float = 1e-6,
    warmup_epochs: int = 0,
    t0_epochs: int = 10,
    t_mult: int = 2,
) -> Schedule:
    """cosine / cosine_warm_restarts / step / exponential / constant."""
    total = max(num_epochs * steps_per_epoch, 1)
    warmup = warmup_epochs * steps_per_epoch
    if scheduler == "cosine":
        if warmup > 0:
            return warmup_cosine_decay_schedule(min_lr, learning_rate, warmup, total, min_lr)
        return cosine_decay_schedule(learning_rate, total, alpha=min_lr / learning_rate)
    if scheduler == "cosine_warm_restarts":
        schedules, boundaries = [], []
        t = t0_epochs * steps_per_epoch
        elapsed = 0
        while elapsed < total:
            schedules.append(cosine_decay_schedule(learning_rate, t,
                                                   alpha=min_lr / learning_rate))
            elapsed += t
            boundaries.append(elapsed)
            t *= t_mult
        return join_schedules(schedules, boundaries[:-1])
    if scheduler == "step":
        return exponential_decay(learning_rate, 30 * steps_per_epoch, 0.1, staircase=True,
                                 end_value=min_lr)
    if scheduler == "exponential":
        return exponential_decay(learning_rate, steps_per_epoch, 0.95, end_value=min_lr)
    return constant_schedule(learning_rate)


# ---------------------------------------------------------------------------
# Transforms and the optimizer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Transform:
    """One optax chain: ``kind`` is "adamw", "adam", "sgd" or "zero"
    (``set_to_zero``); ``clip`` > 0 puts ``clip_by_global_norm(clip)``
    first."""

    kind: str
    schedule: Optional[Schedule] = None
    weight_decay: float = 0.0
    clip: float = 0.0

    def __post_init__(self):
        if self.kind not in ("adamw", "adam", "sgd", "zero"):
            raise ValueError(f"unknown optimizer {self.kind}")

    def init(self, model: nn.Module) -> "Optimizer":
        """The optimizer over every parameter of ``model``, in one group."""
        return Optimizer(model, {"train": self}, lambda name: "train")


def set_to_zero() -> Transform:
    return Transform("zero")


def build_optimizer(
    schedule: Schedule,
    optimizer: str = "adamw",
    weight_decay: float = 1e-4,
    gradient_clip: float = 5.0,
) -> Transform:
    if optimizer not in ("adamw", "adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer}")
    return Transform(optimizer, schedule, weight_decay if optimizer == "adamw" else 0.0,
                     gradient_clip if gradient_clip and gradient_clip > 0 else 0.0)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of ``tensors`` (optax
    ``global_norm``), a float32 scalar on their device; no host sync."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).square().sum().sqrt()


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm``: ``g / n * max_norm`` unless the global
    norm ``n < max_norm``."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, t, t / norm * max_norm) for t in grads]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


class Optimizer:
    """Parameter groups of ``model``, each updated by its :class:`Transform`
    (optax state: a step count per group, Adam's ``mu``/``nu`` or SGD's
    momentum trace per parameter, float32 on the parameter's device).

    :meth:`step` takes one gradient per parameter in ``named_parameters``
    order (``None`` where autograd gave none: a zero gradient) and updates
    the parameters in place under ``torch.no_grad`` (so their version
    counters move and every cache keyed on them is rebuilt). ``clip`` > 0
    first clips every gradient by their one global norm (optax's
    ``clip_by_global_norm`` chained before the groups)."""

    def __init__(self, model: nn.Module, transforms: Dict[str, Transform],
                 label_of: Callable[[str], str], clip: float = 0.0):
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        self.labels: List[str] = []
        for name, p in model.named_parameters():
            label = label_of(name)
            if label not in transforms:
                raise KeyError(f"no transform for label {label!r} of {name}")
            self.names.append(name)
            self.params.append(p)
            self.labels.append(label)
        self.transforms = dict(transforms)
        self.clip = clip
        self.count = {label: 0 for label in self.transforms}
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}
        self.trace: Dict[str, torch.Tensor] = {}
        for name, p, label in zip(self.names, self.params, self.labels):
            kind = self.transforms[label].kind
            if kind in ("adamw", "adam"):
                self.mu[name] = torch.zeros_like(p)
                self.nu[name] = torch.zeros_like(p)
            elif kind == "sgd":
                self.trace[name] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.clip > 0:
            grads = _clip_by_global_norm(
                [g.float() if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, self.params)], self.clip)
        for label, tx in self.transforms.items():
            idx = [i for i, lab in enumerate(self.labels) if lab == label]
            if tx.kind == "zero" or not idx:
                continue
            params = [self.params[i] for i in idx]
            names = [self.names[i] for i in idx]
            g = [grads[i].float() if grads[i] is not None else torch.zeros_like(self.params[i])
                 for i in idx]
            if tx.clip > 0:
                g = _clip_by_global_norm(g, tx.clip)
            count = self.count[label]
            lr = tx.schedule(count)
            if tx.kind == "sgd":
                trace = [self.trace[n] for n in names]
                torch._foreach_mul_(trace, SGD_MOMENTUM)
                torch._foreach_add_(trace, g)
                torch._foreach_add_(params, trace, alpha=-lr)
            else:
                mu = [self.mu[n] for n in names]
                nu = [self.nu[n] for n in names]
                torch._foreach_mul_(mu, ADAM_B1)
                torch._foreach_add_(mu, g, alpha=1 - ADAM_B1)
                torch._foreach_mul_(nu, ADAM_B2)
                torch._foreach_addcmul_(nu, g, g, value=1 - ADAM_B2)
                bc1 = _bias_correction(ADAM_B1, count + 1)
                bc2 = _bias_correction(ADAM_B2, count + 1)
                denom = torch._foreach_div(nu, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, ADAM_EPS)
                update = torch._foreach_div(mu, bc1)
                torch._foreach_div_(update, denom)
                if tx.kind == "adamw" and tx.weight_decay:
                    torch._foreach_add_(update, params, alpha=tx.weight_decay)
                torch._foreach_add_(params, update, alpha=-lr)
            self.count[label] = count + 1

    def state_dict(self) -> dict:
        return {"count": dict(self.count), "mu": dict(self.mu), "nu": dict(self.nu),
                "trace": dict(self.trace)}

    def load_state_dict(self, state: dict) -> None:
        if set(state["count"]) != set(self.count):
            raise KeyError(f"optimizer groups {sorted(state['count'])} != {sorted(self.count)}")
        self.count = {k: int(v) for k, v in state["count"].items()}
        for slot in ("mu", "nu", "trace"):
            mine = getattr(self, slot)
            if set(state[slot]) != set(mine):
                raise KeyError(f"optimizer {slot} holds other parameters than this model's")
            for name, t in state[slot].items():
                mine[name].copy_(t)


# ---------------------------------------------------------------------------
# Staged freezing via parameter-path labels
# ---------------------------------------------------------------------------


def _path(name: str) -> str:
    """A parameter's ``named_parameters`` name as the JAX package's
    '/'-joined path (module names follow the JAX tree)."""
    return name.replace(".", "/")


def label_params(names: Iterable[str], rules: Sequence[Tuple[str, str]],
                 default: str = "train") -> Dict[str, str]:
    """Label every parameter name by the first rule whose substring its
    '/'-joined path contains (``[(substring, label), ...]``)."""
    def label_for(name: str) -> str:
        p = _path(name)
        for sub, lab in rules:
            if sub in p:
                return lab
        return default

    return {name: label_for(name) for name in names}


def staged_optimizer(
    base_tx_for: Dict[str, Transform],
    model: nn.Module,
    rules: Sequence[Tuple[str, str]],
    default: str = "train",
    clip: float = 0.0,
) -> Optimizer:
    """Parameter groups by path label; a group labelled with
    :func:`set_to_zero` is frozen (its parameters never change). ``clip`` >
    0 clips all gradients by their global norm before the groups."""
    labels = label_params([n for n, _ in model.named_parameters()], rules, default)
    return Optimizer(model, base_tx_for, labels.__getitem__, clip)


@dataclass(frozen=True)
class StageConfig:
    """One freezing stage."""

    name: str
    freeze_pretrained: bool = True
    freeze_rgb_extractor: bool = False
    freeze_head: bool = False
    lr_scale: float = 1.0


def stage_rules(stage: StageConfig) -> Sequence[Tuple[str, str]]:
    return [
        ("pretrained_unet", "frozen" if stage.freeze_pretrained else "train"),
        ("unet_wrapper", "frozen" if stage.freeze_pretrained else "train"),
        ("rgb_extractor", "frozen" if stage.freeze_rgb_extractor else "train"),
        ("head", "frozen" if stage.freeze_head else "train"),
    ]


def progressive_unfreeze_rules(num_unfrozen_blocks: int, total_stages: int = 7,
                               encoder_path: str = "encoder") -> Sequence[Tuple[str, str]]:
    """Unfreeze the last ``num_unfrozen_blocks`` encoder stages (deeper
    stages first): the encoder's ``stage{i}_block{j}`` modules of stage
    ``i >= total_stages - num_unfrozen_blocks`` are labelled
    ``"encoder_train"``, the others ``"frozen"``; the stem trains only when
    every stage does."""
    first_trainable = total_stages - num_unfrozen_blocks
    rules = [(f"{encoder_path}/stage{s}_", "encoder_train" if s >= first_trainable else "frozen")
             for s in range(total_stages)]
    rules.append((f"{encoder_path}/stem",
                  "encoder_train" if num_unfrozen_blocks >= total_stages else "frozen"))
    return rules


def distillation_optimizer(
    model: nn.Module,
    schedule: Schedule,
    num_unfrozen_blocks: int,
    encoder_lr_scale: float = 0.3,
    weight_decay: float = 1e-4,
    gradient_clip: float = 5.0,
) -> Optimizer:
    """AdamW over ``model``: everything outside the encoder at ``schedule``,
    the unfrozen encoder stages at ``encoder_lr_scale`` x ``schedule`` (the
    product in float32, as optax multiplies its float32 schedule), the frozen
    stages never updated, after one ``clip_by_global_norm(gradient_clip)``
    over every gradient."""
    scale = _F32(encoder_lr_scale)

    def encoder_schedule(count: int) -> float:
        return float(_F32(schedule(count)) * scale)

    transforms = {
        "train": Transform("adamw", schedule, weight_decay),
        "encoder_train": Transform("adamw", encoder_schedule, weight_decay),
        "frozen": set_to_zero(),
    }
    return staged_optimizer(transforms, model, progressive_unfreeze_rules(num_unfrozen_blocks),
                            default="train",
                            clip=gradient_clip if gradient_clip and gradient_clip > 0 else 0.0)
