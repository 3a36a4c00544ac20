"""Train and eval steps for the hierarchical model.

Counterpart of the JAX package's ``training/steps.py``. A step computes
what the JAX step computes: the forward in training mode (dropout from the
state's generator; the frozen stage 1 in eval mode without autograd), the
refined hierarchical loss, the gradients of every parameter, the NaN guard
and the optimizer's update.

Data parallel (``mesh=``, JAX ``steps.py:113-156``, ``:158-218``,
``:221-262``): every rank of the mesh (``parallel.create_mesh``) holds the
whole state and takes its own slice of the global batch
(``parallel.shard_batch``). Each rank computes the loss and gradients of its
slice; the gradients, the metrics, the new loss state, the new running
statistics and the loss are then averaged over the ranks (JAX's list of
``pmean``s, ``:133-138``; one collective per dtype) before the update, so
every rank applies the same update and the states stay equal. The running
statistics are averaged in float32 and then written under the one-device
rule below. ``DistributedDataParallel`` is not used: it averages the
gradients only. After the averaging ``finite`` is the same on every rank,
so every rank keeps or skips the step together, and ``bool(finite)`` stays
the step's one host sync. The eval step sums its sums over the ranks; its
``acc`` is the global pixel accuracy, numerator and denominator summed
before the division, which the JAX mesh step does not do (ROADMAP C16: it
``psum``s the shards' accuracies, so with D shards its ``acc`` is their
sum).

Dropout under a mesh: JAX folds the step and the axis index into the
state's key. Here rank r draws a step's masks from a generator seeded by a
hash of the state's generator state, the step and r: two ranks never share
a stream at one step, and the state's generator itself is not advanced, so
it stays equal on every rank. A checkpoint (written by rank 0) holds that
generator and the step, which is all a resumed run needs to rebuild every
rank's stream.

Batch contract (numpy arrays or tensors):
    images: (B, H, W, 3) float in [0, 1]
    boxes:  (B, K, 4)    normalised [x1, y1, x2, y2]
    masks:  (B, K, mh, mw) int labels {0, 1, 2}
    valid:  (B, K)       1.0 for real ROIs, 0.0 for padding

``compute_dtype="bfloat16"`` runs the forward and the backward on bf16
copies of every floating parameter and buffer (``torch.func.functional_call``
over ``p.to(bf16)``, the JAX ``_cast_floating``), so the gradients reach the
float32 masters through the casts; the masters, the optimizer state and the
loss stay float32. (``torch.autocast`` would keep some ops in float32 and
compute something else.) The copies are made anew every step, so the fused
stage-1 kernels, which keep operands prepared from the weights they see,
rebuild them every step: the decay changes the frozen weights every step.

Running statistics (the JAX ``batch_stats``: the BatchNorms of an
unfrozen stage 1 or of a batchnorm head, ``AdaptiveInstanceNorm2d``) are
train state. The forward runs under ``ops.norms.deferred_running_stats``,
so the modules in train mode hand their new statistics over instead of
writing their buffers (the JAX ``mutable=["batch_stats"]``), and the step
writes them only when it keeps the update. In a bf16 step the forward
reads bf16 copies of the statistics, as JAX's forward reads
``_cast_floating(batch_stats)``, and the kept statistics are what JAX
returns cast back to float32: a module in train mode gives ``0.9 *
bf16(running)`` rounded to bf16 plus the float32 ``0.1 * batch`` term,
every other statistic (a frozen stage 1's too) comes back as
``bf16(running)``.

The NaN guard: a step whose loss or gradients' global norm is not finite
keeps the parameters, the running statistics, the optimizer state (its
step count with it) and the loss state, advances ``state.step`` and counts
one more ``skipped``. The decision is one host sync a step (``bool`` of a
device scalar); the JAX step selects on the device instead.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..losses.hierarchical import (HierarchicalLossState, RefinedLossConfig,
                                   refined_hierarchical_loss)
from ..models.blocks import set_dropout_generator
from ..ops.norms import deferred_running_stats, running_stat_modules
from .optim import global_norm
from .state import TrainState

Batch = Dict[str, object]


def rois_from_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) boxes -> (B*K, 5) rois with their batch indices."""
    b, k, _ = boxes.shape
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device).repeat_interleave(k)[:, None]
    return torch.cat([idx, boxes.reshape(b * k, 4)], dim=-1)


def batch_to(batch: Batch, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            .to(device) for k, v in batch.items()}


def _compute_dtype(compute_dtype: Optional[str]) -> Optional[torch.dtype]:
    if compute_dtype in (None, "float32", "f32"):
        return None
    return getattr(torch, compute_dtype)


def _frozen(model: nn.Module, name: str) -> bool:
    return getattr(model, "freeze_pretrained", False) and name.split(".")[0] in (
        "pretrained_unet", "unet_wrapper")


def cast_variables(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Copies of every floating parameter and buffer of ``model`` in
    ``dtype`` (others as they are), keyed by name: differentiable casts of
    the trainable parameters, detached ones of the frozen stage 1."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = (p.detach() if _frozen(model, name) else p).to(dtype)
    for name, b in model.named_buffers():
        out[name] = b.to(dtype) if b.is_floating_point() else b
    return out


def forward(model: nn.Module, images: torch.Tensor, rois: torch.Tensor,
            compute_dtype: Optional[str] = None):
    """``model(images, rois)`` in the step's compute dtype; logits and aux
    come back float32."""
    cdt = _compute_dtype(compute_dtype)
    if cdt is None:
        return model(images, rois)
    logits, aux = functional_call(model, cast_variables(model, cdt), (images.to(cdt), rois))
    return logits.float(), {k: v.float() if v.is_floating_point() else v for k, v in aux.items()}


def new_running_stats(model: nn.Module, collected: Dict, compute_dtype: Optional[str] = None):
    """``[(buffer, new value, rounded)]`` for every running statistic of
    ``model`` that a step changes, after a forward whose modules in train
    mode handed theirs to ``collected`` (``ops.norms.deferred_running_stats``):
    the collected value in float32, and in a bf16 step every statistic not
    collected rounded through bf16, as the JAX step casts them (module
    docstring). Rounding is idempotent, so a buffer this step rounded before
    and nothing wrote since (its version unchanged) is left out: a frozen
    stage 1 costs its ~350 rounding kernels once, not every step."""
    cdt = _compute_dtype(compute_dtype)
    out = []
    for m in running_stat_modules(model):
        for name in ("running_mean", "running_var"):
            buf = getattr(m, name)
            new = collected.get((m, name))
            if new is not None:
                out.append((buf, new.to(buf.dtype), False))
            elif cdt is not None and getattr(buf, "_rounded_at", None) != buf._version:
                out.append((buf, buf.to(cdt).to(buf.dtype), True))
    return out


def make_loss_fn(model: nn.Module, loss_cfg: RefinedLossConfig,
                 compute_dtype: Optional[str] = None):
    """``loss_fn(loss_state, generator, batch) -> (loss, (new_loss_state,
    new_stats, metrics))`` over ``model`` in its current mode, as the JAX
    loss returns; ``new_stats`` is :func:`new_running_stats`' list, and the
    model's running statistics are left as they were. With
    ``compute_dtype`` (e.g. "bfloat16") the forward and backward run in that
    dtype while the master parameters, their statistics and the loss stay
    float32. The images and boxes are taken in the parameters' dtype."""
    param_dtype = next(model.parameters()).dtype

    def loss_fn(loss_state: HierarchicalLossState, generator: torch.Generator,
                batch: Dict[str, torch.Tensor]):
        set_dropout_generator(model, generator)
        rois = rois_from_boxes(batch["boxes"].to(param_dtype))
        with deferred_running_stats() as collected:
            logits, aux = forward(model, batch["images"].to(param_dtype), rois, compute_dtype)
        new_stats = new_running_stats(model, collected, compute_dtype)
        b, k = batch["boxes"].shape[:2]
        mh, mw = batch["masks"].shape[-2:]
        targets = batch["masks"].reshape(b * k, mh, mw)
        valid = batch["valid"].reshape(b * k)
        loss, new_loss_state, metrics = refined_hierarchical_loss(
            logits, targets, aux, loss_state, loss_cfg, valid=valid)
        return loss, (new_loss_state, new_stats, metrics)

    return loss_fn


def _apply_step(state: TrainState, grads: List[Optional[torch.Tensor]],
                new_loss_state: HierarchicalLossState, new_stats, loss: torch.Tensor) -> TrainState:
    """The optimizer's update and the new running statistics, with the
    NaN-batch skip."""
    present = [g for g in grads if g is not None]
    finite = torch.isfinite(loss)
    if present:
        finite = finite & torch.isfinite(global_norm(present))
    if bool(finite):  # the step's one host sync
        state.optimizer.step(grads)
        state.loss_state = new_loss_state
        with torch.no_grad():
            for buf, value, rounded in new_stats:
                buf.copy_(value)
                buf._rounded_at = buf._version if rounded else None
    else:
        state.skipped += 1
    state.step += 1
    return state


def gradients(state: TrainState, loss: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """Gradients of ``loss`` for every parameter of the state's optimizer, in
    its order (None where a parameter got none or needs none)."""
    params = state.optimizer.params
    needed = [i for i, p in enumerate(params) if p.requires_grad]
    found = torch.autograd.grad(loss, [params[i] for i in needed], allow_unused=True)
    grads: List[Optional[torch.Tensor]] = [None] * len(params)
    for i, g in zip(needed, found):
        grads[i] = g
    return grads


def rank_seed(generator: torch.Generator, step: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout stream at ``step`` under a mesh: a
    hash of ``generator``'s state (read on the host, no device sync), the
    step and the rank (module docstring)."""
    h = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=8)
    h.update(struct.pack("<qq", int(step), int(rank)))
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


class RankGenerator:
    """The generator a step draws its dropout from: the state's own without
    a mesh, else this rank's stream of the step (:func:`rank_seed`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._gen: Optional[torch.Generator] = None

    def __call__(self, state: TrainState) -> torch.Generator:
        if self.mesh is None:
            return state.generator
        from ..parallel.mesh import rank_of

        if self._gen is None or self._gen.device != state.generator.device:
            self._gen = torch.Generator(device=state.generator.device)
        self._gen.manual_seed(rank_seed(state.generator, state.step, rank_of(self.mesh)))
        return self._gen


def mesh_average(mesh, grads: Sequence[Optional[torch.Tensor]], loss: torch.Tensor,
                 metrics: Dict[str, torch.Tensor],
                 loss_state: Optional[HierarchicalLossState] = None, new_stats=()):
    """The JAX step's ``pmean``s over the mesh's ranks: ``(grads, loss,
    metrics, loss_state, new_stats)`` averaged, in one collective per dtype
    (``parallel.all_mean``). Absent gradients stay absent (the same on every
    rank); the loss state's ``initialized`` flag, equal on every rank, is
    kept; running statistics are averaged in float32, and the ones a bf16
    step only rounds (equal on every rank) are kept as they are."""
    from ..parallel.mesh import all_mean

    gi = [i for i, g in enumerate(grads) if g is not None]
    mk = [k for k, v in metrics.items() if v.is_floating_point()]
    ls_fields = [] if loss_state is None else [
        f for f in HierarchicalLossState.FIELDS if getattr(loss_state, f).is_floating_point()]
    si = [i for i, (_, _, rounded) in enumerate(new_stats) if not rounded]
    flat = ([grads[i] for i in gi] + [loss] + [metrics[k] for k in mk]
            + [getattr(loss_state, f) for f in ls_fields]
            + [new_stats[i][1].float() for i in si])
    avg = iter(all_mean(flat, mesh))
    grads = list(grads)
    for i in gi:
        grads[i] = next(avg)
    loss = next(avg)
    metrics = {**metrics, **{k: next(avg) for k in mk}}
    if loss_state is not None:
        loss_state = HierarchicalLossState(**{
            f: next(avg) if f in ls_fields else getattr(loss_state, f)
            for f in HierarchicalLossState.FIELDS})
    new_stats = list(new_stats)
    for i in si:
        buf, _, rounded = new_stats[i]
        new_stats[i] = (buf, next(avg).to(buf.dtype), rounded)
    return grads, loss, metrics, loss_state, new_stats


def make_train_step(
    model: nn.Module,
    loss_cfg: RefinedLossConfig = RefinedLossConfig(),
    compute_dtype: Optional[str] = None,
    mesh=None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)`` for a state over
    ``model``; the state is updated in place. Metrics are device tensors.
    With ``mesh`` the batch is this rank's slice of the global batch and the
    step is data parallel (module docstring)."""
    loss_fn = make_loss_fn(model, loss_cfg, compute_dtype)
    dropout = RankGenerator(mesh)

    def step(state: TrainState, batch: Batch):
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        model.train()
        device = next(model.parameters()).device
        loss, (new_loss_state, new_stats, metrics) = loss_fn(
            state.loss_state, dropout(state), batch_to(batch, device))
        grads, loss = gradients(state, loss), loss.detach()
        if mesh is not None:
            grads, loss, metrics, new_loss_state, new_stats = mesh_average(
                mesh, grads, loss, metrics, new_loss_state, new_stats)
        state = _apply_step(state, grads, new_loss_state, new_stats, loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_scanned_train_step(
    model: nn.Module,
    loss_cfg: RefinedLossConfig = RefinedLossConfig(),
    scan_steps: int = 8,
    compute_dtype: Optional[str] = None,
    mesh=None,
):
    """``scan_steps`` optimizer steps per call over a stacked super-batch
    (each array gains a leading ``(scan_steps,)`` axis); returns ``(state,
    metrics of the last step)``, as the JAX ``lax.scan`` form does. With
    ``mesh`` the super-batch is this rank's slice along its batch axis
    (``parallel.shard_batch(mesh, batches, axis=1)``)."""
    step = make_train_step(model, loss_cfg, compute_dtype, mesh)

    def scanned(state: TrainState, batches: Batch):
        metrics = None
        for i in range(scan_steps):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()})
        return state, metrics

    return scanned


def stack_batches(batches):
    """Stack K host batches into the (K, ...) super-batch for
    :func:`make_scanned_train_step`."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def eval_forward(model: nn.Module, images: torch.Tensor, boxes: torch.Tensor):
    """``(logits, aux)`` of ``model`` in eval mode, in its parameters' dtype
    (float32 for a train state's masters) and without autograd (JAX's
    ``model.apply(train=False)``) on (B, H, W, 3) images and (B, K, 4)
    boxes, its mode restored after: the eval step's forward, and the curated
    renders' (the fused stage-1 kernels run in both)."""
    dtype = next(model.parameters()).dtype
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(images.to(dtype), rois_from_boxes(boxes.to(dtype)))
    finally:
        model.train(was_training)


def make_eval_step(model: nn.Module, mesh=None):
    """``eval_step(batch) -> sums`` of per-ROI target IoU, detection at 0.5
    and 0.7, the ROI count and pixel accuracy, through :func:`eval_forward`.
    With ``mesh`` the batch is this rank's slice and the sums are summed over
    the ranks; ``acc`` is then the global pixel accuracy (C16, module
    docstring)."""

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        batch = batch_to(batch, next(model.parameters()).device)
        logits, _ = eval_forward(model, batch["images"], batch["boxes"])
        b, k = batch["boxes"].shape[:2]
        mh, mw = batch["masks"].shape[-2:]
        targets = batch["masks"].reshape(b * k, mh, mw)
        valid = batch["valid"].reshape(b * k).to(logits.dtype)
        pred = torch.argmax(logits, dim=-1)
        tp = (pred == 1) & (targets == 1)
        union = (pred == 1) | (targets == 1)
        inter_n = torch.sum(tp, dim=(1, 2)).to(logits.dtype)
        union_n = torch.sum(union, dim=(1, 2)).to(logits.dtype)
        iou = inter_n / torch.clamp(union_n, min=1.0)
        correct = torch.sum((pred == targets) * valid[:, None, None])
        pixels = torch.sum(valid) * mh * mw
        sums = {
            "iou_sum": torch.sum(iou * valid),
            "det50_sum": torch.sum((iou > 0.5) * valid),
            "det70_sum": torch.sum((iou > 0.7) * valid),
            "n": torch.sum(valid),
        }
        if mesh is not None:
            from ..parallel.mesh import all_sum

            keys = list(sums)
            summed = all_sum([sums[k] for k in keys] + [correct, pixels], mesh)
            sums = dict(zip(keys, summed[:len(keys)]))
            correct, pixels = summed[len(keys):]
        sums["acc"] = correct / torch.clamp(pixels, min=1.0)
        return sums

    return step
