"""The port's training path against the JAX package's (CPU, float32, JAX
under ``jax.default_matmul_precision("highest")``, inputs from a numpy
seed).

The tiny flagship is the JAX loop's ``--tiny`` model of the deployed B0
config (variant "tiny", image 64x64, roi 16x12, mask 32x24, base 16, depth
2, mid 32, feature_dim 32). Both packages start from the same
JAX-initialised variables (``helpers.fast_init`` with perturbed norm
affines, brought over by ``from_jax_params``). Dropout draws from each
package's own generator, so the comparisons neutralise it on both sides:
the JAX head's ``Dropout2d`` is patched to the identity inside the module
fixture (which computes every JAX reference up front and then restores
it), and every port ``Dropout2d`` gets ``p = 0``. ``test_dropout2d_*``
hold the port's dropout to its own semantics.

Tolerances: a train step's loss, metrics, loss state and gradients within
rtol 1e-4 / atol 1e-6 (float32 summation order through a few dozen
layers); schedules within rtol 1e-6 of optax (both in float32; ``np.cos``
and XLA's cosine may differ by an ulp); optimizer steps within 1e-7 of
optax.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu import config as jcfg
from human_instance_segmentation_tpu.losses.hierarchical import HierarchicalLossState as JLossState
from human_instance_segmentation_tpu.models import heads as jheads
from human_instance_segmentation_tpu.training import optim as joptim
from human_instance_segmentation_tpu.training import progressive as jprog
from human_instance_segmentation_tpu.training import steps as jsteps
from human_instance_segmentation_tpu.training.state import TrainState as JTrainState
from human_instance_segmentation_tpu_torch import config as pcfg
from human_instance_segmentation_tpu_torch.losses.hierarchical import HierarchicalLossState
from human_instance_segmentation_tpu_torch.models.blocks import Dropout2d
from human_instance_segmentation_tpu_torch.training import optim as poptim
from human_instance_segmentation_tpu_torch.training import progressive as pprog
from human_instance_segmentation_tpu_torch.training import steps as psteps
from human_instance_segmentation_tpu_torch.training.checkpoint import (latest_step,
                                                                      restore_checkpoint,
                                                                      save_checkpoint)
from human_instance_segmentation_tpu_torch.training.loop import TINY_MODEL, synthetic_batches
from human_instance_segmentation_tpu_torch.training.state import TrainState
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_r64x48m128x96_"
            "disttrans_contdet_baware_from_b0")
RTOL, ATOL = 1e-4, 1e-6
LR = 1e-3  # cosine from the peak, no warmup: three steps move the parameters
WARM = {"ema_bg": 1.3, "ema_fg": 0.7, "ema_target": 2.1, "ema_nontarget": 0.6}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny train steps are many small ops: with several test workers on
    the same cores, intra-op threads that wait for each other make them
    orders of magnitude slower, so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(cfg):
    """The JAX loop's --tiny shapes (training/loop.py:77-85)."""
    cfg.model.image_size = (64, 64)
    cfg.model.roi_size = (16, 12)
    cfg.model.mask_size = (32, 24)
    cfg.model.encoder_name = "tiny"
    cfg.model.hierarchical_base_channels = 16
    cfg.model.hierarchical_depth = 2
    return cfg


def _batches(n, seed=5):
    gen = synthetic_batches(2, 2, (64, 64), (32, 24), seed=seed)
    out = []
    for _ in range(n):
        b = next(gen)
        b["valid"][1, 1] = 0.0  # one padded ROI
        out.append(b)
    return out


def _variables(model):
    v = fast_init(model, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 5)), train=False, seed=3)
    rng = np.random.default_rng(4)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        owner = str(getattr(path[-2], "key", path[-2]))
        if path[0].key == "params" and name in ("scale", "bias") and owner != "output_conv":
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, v)


def _jax_schedule():
    return joptim.build_schedule(LR, 1, 100, "cosine", 1e-6, 0)


@pytest.fixture(scope="module")
def ref():
    """JAX references of the tiny flagship from its ``make_train_step``: one
    step's loss, metrics, loss state and gradients (from an uninitialised and
    a warm EMA state), three consecutive steps' losses and the parameters
    after them; the eval step's sums; stage 1's logits."""
    cfg = _tiny(jcfg.ConfigManager.get_config(FLAGSHIP))
    model = jcfg.model_from_config(cfg).clone(**TINY_MODEL)
    variables = _variables(model)
    loss_cfg = jcfg.loss_config_from_experiment(cfg)
    batches = _batches(3)
    out = {"variables": jax.tree.map(np.asarray, variables), "batches": batches}
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jheads, "Dropout2d", lambda rate, name=None: (lambda x, train=False: x))
        # the first link of the chain keeps the step's raw gradients in its
        # state, so one compiled make_train_step gives them too
        record = optax.GradientTransformation(
            lambda params: jax.tree.map(jnp.zeros_like, params),
            lambda grads, state, params=None: (grads, grads))
        tx = optax.chain(record, joptim.build_optimizer(_jax_schedule(), "adamw", 1e-4, 5.0))
        step = jsteps.make_train_step(model, tx, loss_cfg, donate=False)
        start = JTrainState.create(variables, tx, jax.random.PRNGKey(1))
        warm = JLossState(**{k: jnp.asarray(v, jnp.float32) for k, v in WARM.items()},
                          initialized=jnp.asarray(True))
        for key, ls in (("fresh", start.loss_state), ("warm", warm)):
            state, metrics = step(start.replace(loss_state=ls), batches[0])
            out[key] = {"loss": float(metrics["total_loss"]),
                        "metrics": jax.tree.map(np.asarray, metrics),
                        "loss_state": jax.tree.map(np.asarray, state.loss_state),
                        "grads": from_jax_params(
                            {"params": jax.tree.map(np.asarray, state.opt_state[0])})}
            if key == "fresh":
                losses = [out[key]["loss"]]
                for b in batches[1:]:
                    state, m = step(state, b)
                    losses.append(float(m["total_loss"]))
                out["losses"] = losses
                out["params_after"] = from_jax_params(
                    {"params": jax.tree.map(np.asarray, state.params)})
        eval_step = jsteps.make_eval_step(model)
        out["eval"] = {k: float(v) for k, v in eval_step(
            (variables["params"], variables["batch_stats"]), batches[1]).items()}
        stage1 = jax.jit(lambda v, x: model.apply(v, x, method="stage1"))
        out["stage1"] = np.asarray(stage1(variables, jnp.asarray(batches[0]["images"])))
    return out


def _port_model(ref):
    cfg = _tiny(pcfg.ConfigManager.get_config(FLAGSHIP))
    model = pcfg.model_from_config(cfg, device="cpu", **TINY_MODEL)
    load_jax_params(model, ref["variables"])
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return model, pcfg.loss_config_from_experiment(cfg)


def _port_tx():
    return poptim.build_optimizer(poptim.build_schedule(LR, 1, 100, "cosine", 1e-6, 0),
                                  "adamw", 1e-4, 5.0)


def _grads(model, loss):
    params = [p for _, p in model.named_parameters()]
    return dict(zip([n for n, _ in model.named_parameters()],
                    torch.autograd.grad(loss, params, allow_unused=True)))


@pytest.mark.parametrize("which", ["fresh", "warm"])
def test_train_step_matches_jax(ref, which):
    """Loss, every metric, the new loss state and every parameter's gradient
    (the frozen stage 1's are zero in JAX and absent here) of one train step
    of the tiny flagship, with the EMA state uninitialised and warm."""
    model, loss_cfg = _port_model(ref)
    r = ref[which]
    ls = (HierarchicalLossState.create() if which == "fresh" else HierarchicalLossState(
        **{k: torch.tensor(v) for k, v in WARM.items()}, initialized=torch.tensor(True)))
    model.train()
    loss, (new_ls, _, metrics) = psteps.make_loss_fn(model, loss_cfg)(
        ls, torch.Generator().manual_seed(0), psteps.batch_to(ref["batches"][0], "cpu"))
    np.testing.assert_allclose(float(loss.detach()), r["loss"], rtol=RTOL, atol=ATOL)
    assert set(metrics) == set(r["metrics"])
    for k, v in r["metrics"].items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=RTOL, atol=ATOL, err_msg=k)
    for f in HierarchicalLossState.FIELDS:
        np.testing.assert_allclose(getattr(new_ls, f).numpy(), getattr(r["loss_state"], f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    grads = _grads(model, loss)
    assert set(grads) == set(r["grads"])
    for name, g in grads.items():
        want = r["grads"][name].numpy()
        if name.startswith(("pretrained_unet.", "unet_wrapper.")):
            assert g is None, name
        if g is None:  # the frozen stage 1, and the distance threshold no loss term reads
            assert not want.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=name)


def test_three_train_steps_match_jax(ref):
    """``make_train_step`` three times from the same start (AdamW, clip 5.0,
    cosine schedule): each step's loss within 1e-4 relative of JAX's, and the
    parameters after (the frozen ones decayed by JAX's unmasked AdamW)."""
    model, loss_cfg = _port_model(ref)
    state = TrainState.create(model, _port_tx(), seed=1)
    step = psteps.make_train_step(model, loss_cfg)
    losses = []
    for b in ref["batches"]:
        state, m = step(state, b)
        losses.append(float(m["total_loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert state.step == 3 and state.skipped == 0
    after = ref["params_after"]
    for name, p in model.named_parameters():
        # Adam's first steps divide each gradient by its own magnitude, so a
        # parameter whose gradient is near 0 moves by up to lr either way
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), rtol=0,
                                   atol=3 * LR if not name.startswith(("pretrained", "unet_w"))
                                   else 1e-7, err_msg=name)


def test_eval_step_matches_jax(ref):
    model, _ = _port_model(ref)
    got = {k: float(v) for k, v in psteps.make_eval_step(model)(ref["batches"][1]).items()}
    assert set(got) == set(ref["eval"])
    for k, v in ref["eval"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)


def test_frozen_stage1(ref):
    """No gradient reaches stage 1 or the wrapper; both stay in eval mode
    after ``model.train()``; ``stage1()`` equals the JAX method."""
    model, loss_cfg = _port_model(ref)
    model.train()
    assert model.training and model.head.training
    assert not model.pretrained_unet.training and not model.unet_wrapper.training
    assert not any(m.training for m in model.pretrained_unet.modules())
    loss, _ = psteps.make_loss_fn(model, loss_cfg)(
        HierarchicalLossState.create(), torch.Generator().manual_seed(0),
        psteps.batch_to(ref["batches"][0], "cpu"))
    loss.backward()
    for name, p in model.named_parameters():
        frozen = name.startswith(("pretrained_unet.", "unet_wrapper."))
        # no loss term reads the distance mask, so its threshold gets none either
        assert (p.grad is None) == (frozen or name == "head.distance.threshold"), name
    logits = model.stage1(torch.from_numpy(ref["batches"][0]["images"]))
    assert not logits.requires_grad
    np.testing.assert_allclose(logits.numpy(), ref["stage1"], rtol=1e-5, atol=1e-5)


def test_fused_stage1_follows_the_decayed_weights(ref):
    """The fused MBConv blocks keep folded weights until a parameter
    changes: after an optimizer step that decays the frozen stage 1 by 10%
    (AdamW, lr 0.1, weight decay 1), stage 1 with ``encoder_fused_blocks=3``
    and ``pallas_tail=True`` (their plain versions on the CPU) equals the
    unfused stage 1 holding the same decayed weights."""
    cfg = _tiny(pcfg.ConfigManager.get_config(FLAGSHIP))
    fused = pcfg.model_from_config(cfg, device="cpu", pallas_tail=True, encoder_fused_blocks=3,
                                   **TINY_MODEL)
    plain = pcfg.model_from_config(cfg, device="cpu", **TINY_MODEL)
    for m in (fused, plain):
        load_jax_params(m, ref["variables"])
    images = torch.from_numpy(ref["batches"][0]["images"])
    before = fused.stage1(images)  # folds and keeps the weights
    np.testing.assert_allclose(before.numpy(), plain.stage1(images).numpy(), atol=1e-5)
    state = TrainState.create(fused, poptim.Transform("adamw", poptim.constant_schedule(0.1),
                                                      1.0, 5.0))
    psteps.make_train_step(fused, pcfg.loss_config_from_experiment(cfg))(
        state, ref["batches"][0])
    w = fused.pretrained_unet.encoder.stage1_block0.project_conv.weight
    np.testing.assert_allclose(w.detach().numpy(),
                               0.9 * plain.pretrained_unet.encoder.stage1_block0
                               .project_conv.weight.detach().numpy(), rtol=1e-6)
    plain.load_state_dict(fused.state_dict())
    after = fused.stage1(images)
    np.testing.assert_allclose(after.numpy(), plain.stage1(images).numpy(), atol=1e-5)
    assert float((after - before).abs().max()) > 1e-3


def test_unfrozen_stage1_raises(ref):
    """Refused until the BatchNorm train mode landed; now an unfrozen stage
    1 trains: ``train()`` reaches it, a gradient reaches its parameters, and
    a step moves its parameters and its running statistics (their parity
    with JAX: tests/test_torch_batch_stats.py)."""
    cfg = _tiny(pcfg.ConfigManager.get_config(FLAGSHIP))
    cfg.model.freeze_pretrained_weights = False
    model = pcfg.model_from_config(cfg, device="cpu", **TINY_MODEL)
    load_jax_params(model, ref["variables"])
    model.train()
    assert model.pretrained_unet.training and model.unet_wrapper.training
    stem = model.pretrained_unet.encoder.stem_conv.weight.detach().clone()
    stats = model.pretrained_unet.encoder.stem_bn.running_mean.clone()
    state = TrainState.create(model, _port_tx(), seed=1)
    state, _ = psteps.make_train_step(model, pcfg.loss_config_from_experiment(cfg))(
        state, ref["batches"][0])
    assert state.skipped == 0
    assert not torch.equal(model.pretrained_unet.encoder.stem_conv.weight.detach(), stem)
    assert not torch.equal(model.pretrained_unet.encoder.stem_bn.running_mean, stats)


def test_dropout2d_drops_whole_channels():
    """Whole (sample, channel) maps are zeroed or scaled by 1/(1-p), drawn
    from the generator; eval mode and p = 0 are the identity; p = 1 zeros."""
    x = torch.rand(8, 64, 5, 7) + 0.5
    d = Dropout2d(0.25)
    d.generator = torch.Generator().manual_seed(0)
    y = d.train()(x)
    kept = (y != 0).all(dim=(2, 3))
    assert ((y == 0).all(dim=(2, 3)) | kept).all()  # all of a map or none
    np.testing.assert_allclose(y[kept[..., None, None].expand_as(y)].numpy(),
                               (x / 0.75)[kept[..., None, None].expand_as(x)].numpy(), rtol=1e-6)
    assert 0.6 < float(kept.float().mean()) < 0.9
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)  # the same draw from the same generator state
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(Dropout2d(0.0).train()(x), x)
    assert not Dropout2d(1.0).train()(x).any()
    assert list(Dropout2d(0.1).parameters()) == []


def test_dropout_draws_from_the_state_generator(ref):
    """With its default rate the head drops channels in training, the draw
    comes from the state's generator (same seed, same loss) and eval mode
    is untouched."""
    model, loss_cfg = _port_model(ref)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.5
    batch = psteps.batch_to(ref["batches"][0], "cpu")
    loss_fn = psteps.make_loss_fn(model, loss_cfg)
    model.train()

    def loss(seed):
        return float(loss_fn(HierarchicalLossState.create(), torch.Generator().manual_seed(seed),
                             batch)[0])

    assert loss(0) == loss(0)
    assert loss(0) != loss(1)
    assert abs(loss(0) - ref["fresh"]["loss"]) > 1e-4


def test_nan_batch_is_skipped(ref):
    """A NaN image: params, optimizer state and loss state bitwise unchanged,
    ``skipped == 1``, the step still advances."""
    model, loss_cfg = _port_model(ref)
    state = TrainState.create(model, _port_tx(), seed=1)
    step = psteps.make_train_step(model, loss_cfg)
    state, _ = step(state, ref["batches"][0])
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = state.optimizer.state_dict()
    opt = {"count": dict(opt["count"]), "mu": {k: t.clone() for k, t in opt["mu"].items()},
           "nu": {k: t.clone() for k, t in opt["nu"].items()}}
    ls = {k: v.clone() for k, v in state.loss_state.state_dict().items()}
    bad = dict(ref["batches"][1])
    bad["images"] = bad["images"].copy()
    bad["images"][0, 3, 4, 1] = np.nan
    state, metrics = step(state, bad)
    assert not np.isfinite(float(metrics["total_loss"]))
    assert state.step == 2 and state.skipped == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    after = state.optimizer.state_dict()
    assert after["count"] == opt["count"]
    for slot in ("mu", "nu"):
        for k, t in after[slot].items():
            assert torch.equal(t, opt[slot][k]), (slot, k)
    for k, v in state.loss_state.state_dict().items():
        assert torch.equal(v, ls[k]), k


def test_bf16_step_keeps_f32_masters(ref):
    """The port's counterpart of test_training_plumbing.py::
    test_bf16_train_step_keeps_f32_masters at the tiny size: the masters and
    the optimizer state stay float32, the step moves them, and the bf16 loss
    is close to the float32 loss on the same batch."""
    model, loss_cfg = _port_model(ref)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, _port_tx(), seed=1)
    state, metrics = psteps.make_train_step(model, loss_cfg, compute_dtype="bfloat16")(
        state, ref["batches"][0])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32,) for b in model.buffers() if b.is_floating_point())
    assert all(t.dtype == torch.float32 for t in state.optimizer.mu.values())
    assert metrics["total_loss"].dtype == torch.float32
    assert np.isfinite(float(metrics["total_loss"])) and state.skipped == 0
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in model.named_parameters() if n.startswith("head."))
    assert moved > 0
    np.testing.assert_allclose(float(metrics["total_loss"]), ref["fresh"]["loss"], rtol=0.05)


def test_scanned_step_equals_sequential(ref):
    model_a, loss_cfg = _port_model(ref)
    state_a = TrainState.create(model_a, _port_tx(), seed=1)
    state_a, m = psteps.make_scanned_train_step(model_a, loss_cfg, scan_steps=3)(
        state_a, psteps.stack_batches(ref["batches"]))
    model_b, _ = _port_model(ref)
    state_b = TrainState.create(model_b, _port_tx(), seed=1)
    step = psteps.make_train_step(model_b, loss_cfg)
    for b in ref["batches"]:
        state_b, mb = step(state_b, b)
    assert state_a.step == state_b.step == 3
    assert float(m["total_loss"]) == float(mb["total_loss"])
    for (n, a), b in zip(model_a.named_parameters(), model_b.parameters()):
        assert torch.equal(a, b), n


def test_checkpoint_resume_is_bit_exact(ref, tmp_path):
    """Save after two steps, restore into a fresh state over a fresh model,
    and the next two steps (dropout on, drawn from the restored generator)
    equal the uninterrupted run's bit for bit."""
    def fresh():
        model, loss_cfg = _port_model(ref)
        for m in model.modules():
            if isinstance(m, Dropout2d):
                m.p = 0.1
        return model, loss_cfg, TrainState.create(model, _port_tx(), seed=7)

    batches = ref["batches"] + _batches(1, seed=9)
    model, loss_cfg, state = fresh()
    step = psteps.make_train_step(model, loss_cfg)
    for b in batches[:2]:
        state, _ = step(state, b)
    save_checkpoint(str(tmp_path), state, 2, metadata={"note": "two steps"})
    assert latest_step(str(tmp_path)) == 2
    assert json.loads((tmp_path / "metadata_2.json").read_text()) == {"note": "two steps"}
    run = []
    for b in batches[2:]:
        state, m = step(state, b)
        run.append(float(m["total_loss"]))

    model2, _, state2 = fresh()
    state2, got = restore_checkpoint(str(tmp_path), state2)
    assert got == 2 and state2.step == 2
    step2 = psteps.make_train_step(model2, loss_cfg)
    resumed = []
    for b in batches[2:]:
        state2, m = step2(state2, b)
        resumed.append(float(m["total_loss"]))
    assert resumed == run
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(state.optimizer.mu.values(), state2.optimizer.mu.values()):
        assert torch.equal(a, b)
    for k, v in state.loss_state.state_dict().items():
        assert torch.equal(v, state2.loss_state.state_dict()[k]), k


STAGED = {
    # (stage_schedule, steps_per_epoch, steps before the restore, steps in all)
    "stage_at_0": ({0: {"freeze_pretrained": True}}, 100, 2, 4),
    "stage_after_restore": ({1: {"freeze_pretrained": True, "lr_scale": 0.5}}, 2, 2, 4),
    "restored_under_stage": ({0: {"freeze_head": False}, 1: {"freeze_rgb_extractor": True}},
                             2, 3, 5),
}


@pytest.mark.parametrize("case", sorted(STAGED))
def test_staged_resume_is_bit_exact(case, tmp_path):
    """ROADMAP C8: a run with a ``stage_schedule``, stopped and resumed from
    its checkpoint, ends bit for bit where the uninterrupted run ends:
    parameters, running statistics, optimizer state, loss state and the
    last loss. The cases: a stage from step 0, a stage that starts at the
    restored step (applied by the resumed loop) and a checkpoint written
    under a later stage than the first."""
    from human_instance_segmentation_tpu_torch.training.loop import run_training

    schedule, spe, first, total = STAGED[case]
    kw = dict(synthetic=True, tiny=True, device="cpu", steps_per_epoch=spe, return_state=True,
              config_modifications={"training": {"stage_schedule": schedule}})
    whole, ws = run_training(FLAGSHIP, steps=total, output_dir=str(tmp_path / "a"), **kw)
    run_training(FLAGSHIP, steps=first, output_dir=str(tmp_path / "b"), **kw)
    resumed, rs = run_training(FLAGSHIP, steps=total, output_dir=str(tmp_path / "b"),
                               resume=True, **kw)
    assert rs.step == ws.step == total and rs.skipped == ws.skipped == 0
    assert resumed["total_loss"] == whole["total_loss"]
    for (n, a), b in zip(ws.model.state_dict().items(), rs.model.state_dict().values()):
        assert torch.equal(a, b), n
    wo, ro = ws.optimizer.state_dict(), rs.optimizer.state_dict()
    assert wo["count"] == ro["count"] and len(wo["count"]) == 2  # the staged groups
    for slot in ("mu", "nu"):
        for k, t in wo[slot].items():
            assert torch.equal(t, ro[slot][k]), (slot, k)
    for k, v in ws.loss_state.state_dict().items():
        assert torch.equal(v, rs.loss_state.state_dict()[k]), k


def test_checkpoints_keep_the_newest(ref, tmp_path):
    model, _ = _port_model(ref)
    state = TrainState.create(model, _port_tx())
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), state, s, max_to_keep=2)
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pt")) == ["ckpt_3.pt", "ckpt_4.pt"]
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), state)


# ---------------------------------------------------------------------------
# schedules and the optimizer against optax
# ---------------------------------------------------------------------------


SCHEDULES = {
    "cosine_warmup": dict(scheduler="cosine", warmup_epochs=1),
    "cosine": dict(scheduler="cosine", warmup_epochs=0),
    "cosine_warm_restarts": dict(scheduler="cosine_warm_restarts", t0_epochs=1, t_mult=2),
    "step": dict(scheduler="step"),
    "exponential": dict(scheduler="exponential"),
    "constant": dict(scheduler="none"),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedule_matches_optax(kind):
    """At every step 0..300 (the cosine kinds over 3 epochs of 40 steps run
    past their end; "step" decays every 30 epochs of 2 steps)."""
    kw = SCHEDULES[kind]
    spe = 2 if kind == "step" else 40
    args = (2e-3, 3 if kind != "step" else 150, spe)
    j = joptim.build_schedule(*args, min_lr=1e-5, **kw)
    p = poptim.build_schedule(*args, min_lr=1e-5, **kw)
    steps = np.arange(301)
    want = np.asarray([float(j(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.asarray([p(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert kind == "constant" or len(set(want)) > 2  # the schedule moves


class _Params(torch.nn.Module):
    """Parameters named as the flagship's groups."""

    def __init__(self, values):
        super().__init__()
        for top, leaves in values.items():
            sub = torch.nn.Module()
            for k, v in leaves.items():
                sub.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
            self.add_module(top, sub)


def _case(rng, scale):
    values = {
        "pretrained_unet": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
        "rgb_extractor": {"w": rng.standard_normal((5,)).astype(np.float32)},
        "head": {"w": rng.standard_normal((3, 3)).astype(np.float32),
                 "b": rng.standard_normal((3,)).astype(np.float32)},
    }
    grads = {top: {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                   for k, v in leaves.items()} for top, leaves in values.items()}
    grads["pretrained_unet"]["w"][:] = 0.0  # a parameter with a zero gradient
    return values, grads


@pytest.mark.parametrize("case", ["adamw_zero_grad_decays", "adamw_above_clip", "adam", "sgd",
                                  "staged_frozen"])
def test_optimizer_steps_match_optax(case):
    """Three steps on identical numpy gradients equal ``optax.chain(
    clip_by_global_norm, adamw / adam / sgd)`` within 1e-7: the parameter
    with a zero gradient decays under AdamW (it would not under
    ``torch.optim.AdamW``); gradients above the clip norm are scaled by
    optax's rule; a staged "frozen" group stays exactly unchanged."""
    rng = np.random.default_rng(11)
    values, grads = _case(rng, 40.0 if case == "adamw_above_clip" else 0.3)
    sched_j = optax.warmup_cosine_decay_schedule(1e-3, 5e-2, 2, 10, 1e-4)
    sched_p = poptim.warmup_cosine_decay_schedule(1e-3, 5e-2, 2, 10, 1e-4)
    kind = {"adam": "adam", "sgd": "sgd"}.get(case, "adamw")
    wd = 0.05
    model = _Params(values)
    jparams = jax.tree.map(jnp.asarray, values)
    if case == "staged_frozen":
        stage = joptim.StageConfig("s", freeze_pretrained=True, freeze_rgb_extractor=True)
        jtx = joptim.staged_optimizer(
            {"train": optax.chain(optax.clip_by_global_norm(5.0),
                                  optax.adamw(sched_j, weight_decay=wd)),
             "frozen": optax.set_to_zero()}, jparams, joptim.stage_rules(stage))
        opt = poptim.staged_optimizer(
            {"train": poptim.Transform("adamw", sched_p, wd, 5.0),
             "frozen": poptim.set_to_zero()}, model, poptim.stage_rules(
                poptim.StageConfig("s", freeze_pretrained=True, freeze_rgb_extractor=True)))
    else:
        jtx = joptim.build_optimizer(sched_j, kind, wd, 5.0)
        opt = poptim.build_optimizer(sched_p, kind, wd, 5.0).init(model)
    jstate = jtx.init(jparams)
    for _ in range(3):
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step([torch.tensor(grads[n.split(".")[0]][n.split(".")[1]])
                  for n, _ in model.named_parameters()])
    for name, p in model.named_parameters():
        top, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[top][leaf]),
                                   rtol=0, atol=1e-7, err_msg=name)
        if case == "staged_frozen" and top in ("pretrained_unet", "rgb_extractor"):
            assert np.array_equal(p.detach().numpy(), values[top][leaf]), name
    zero_grad = model.pretrained_unet.w.detach().numpy()
    if kind == "adamw" and case != "staged_frozen":
        assert not np.array_equal(zero_grad, values["pretrained_unet"]["w"])  # decayed
    if case == "adamw_above_clip":
        norm = np.sqrt(sum(float((g ** 2).sum()) for lv in grads.values() for g in lv.values()))
        assert norm > 5.0


def test_label_params_match_jax():
    names = ["pretrained_unet.encoder.stem_conv.weight", "unet_wrapper.output_conv.bias",
             "rgb_extractor.conv0.conv.weight", "head.base_head.shared_in.conv.weight",
             "feature_combiner.weight"]
    for stage in (poptim.StageConfig("a"), poptim.StageConfig("b", freeze_pretrained=False,
                                                              freeze_head=True)):
        rules = poptim.stage_rules(stage)
        assert list(rules) == list(joptim.stage_rules(joptim.StageConfig(**dataclasses.asdict(
            stage))))
        tree = {}
        for n in names:
            node = tree
            parts = n.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = 0.0
        jl = joptim.label_params(tree, rules)
        for n, lab in poptim.label_params(names, rules).items():
            node = jl
            for part in n.split("."):
                node = node[part]
            assert lab == node, n


def test_progressive_matches_jax():
    sched = {"contour_detection": 10, "distance_transform": 20, "boundary_aware": 30}
    assert pprog.FEATURE_FLAGS == jprog.FEATURE_FLAGS
    assert pprog.activation_epochs(sched) == jprog.activation_epochs(sched)
    cfg_p = pcfg.ConfigManager.get_config(FLAGSHIP)
    cfg_j = jcfg.ConfigManager.get_config(FLAGSHIP)
    for epoch in (0, 10, 25, 40):
        assert pprog.active_features(sched, epoch) == jprog.active_features(sched, epoch)
        assert (pprog.gate_config(cfg_p, sched, epoch).to_dict()
                == jprog.gate_config(cfg_j, sched, epoch).to_dict())
    with pytest.raises(ValueError):
        pprog.gate_config(cfg_p, {"unknown": 1}, 0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _env(tmp_path):
    return dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))


def test_cli_runs_writes_its_checkpoint_and_resumes(tmp_path):
    """``main()`` with ``--steps 2 --synthetic --tiny --device cpu``, then
    again with ``--steps 3 --resume``, in one process (the TensorBoard
    import alone takes seconds): the checkpoints, the JSON-lines log and the
    resumed step."""
    argv = ["loop", "--config", FLAGSHIP, "--synthetic", "--tiny", "--device", "cpu",
            "--output_dir", str(tmp_path / "run")]
    script = ("import sys\n"
              "from human_instance_segmentation_tpu_torch.training.loop import main\n"
              f"sys.argv = {argv + ['--steps', '2']!r}\nmain()\n"
              f"sys.argv = {argv + ['--steps', '3', '--resume']!r}\nmain()\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=tmp_path, env=_env(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    run = tmp_path / "run"
    assert "resumed from step 2" in out.stdout
    assert (run / "checkpoints_best" / "metadata_2.json").exists()
    assert sorted(p.name for p in (run / "checkpoints").glob("*.pt")) == ["ckpt_2.pt",
                                                                           "ckpt_3.pt"]
    payload = torch.load(run / "checkpoints" / "ckpt_3.pt", weights_only=True)
    assert payload["step"] == 3 and payload["skipped"] == 0
    rows = [json.loads(line) for f in sorted((run / "logs").glob("*.jsonl"))
            for line in f.read_text().splitlines()]
    assert [r["step"] for r in rows if "total_loss" in r] == [0, 1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in rows if "total_loss" in r)
    assert any("val_miou" in r for r in rows)
    assert json.loads((run / "logs" / "config.json").read_text())["name"] == FLAGSHIP


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without CUDA")
def test_cli_refuses_without_cuda(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "human_instance_segmentation_tpu_torch.training.loop",
         "--config", FLAGSHIP, "--synthetic", "--tiny", "--steps", "1", "--output_dir",
         str(tmp_path / "run")], capture_output=True, text=True, cwd=tmp_path,
        env=_env(tmp_path), timeout=300)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert not (tmp_path / "run").exists()


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """More than one device is ported now (A9): ``--devices 2 --device cpu
    --tiny --synthetic`` trains one step on two Gloo ranks, rank 0 alone
    writing the checkpoint and the log, and returns a finite loss; more CUDA
    ranks than cards raise. COCO data is ported too: without ``--synthetic``
    the loop reads the configured annotations, so a missing file is the
    error (tests/test_torch_coco_training.py trains on a tree)."""
    from human_instance_segmentation_tpu_torch.parallel import launch
    from human_instance_segmentation_tpu_torch.training.loop import run_training

    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", 240.0)  # the ranks are killed after 240 s
    run = tmp_path / "dp"
    m = run_training(FLAGSHIP, steps=1, synthetic=True, devices=2, tiny=True, device="cpu",
                     output_dir=str(run))
    assert np.isfinite(m["total_loss"]) and m["val_n"] == 8.0  # 2 val batches x 2 x 2 ROIs
    assert [p.name for p in run.glob("checkpoints/ckpt_*.pt")] == ["ckpt_1.pt"]
    logs = list(run.glob("logs/*.log"))
    assert len(logs) == 1 and logs[0].read_text().count("done: 1 steps") == 1
    with pytest.raises(ValueError, match=r"need \d+ devices, have \d+"):
        run_training(FLAGSHIP, steps=1, synthetic=True, tiny=True, device="cuda",
                     devices=max(torch.cuda.device_count(), 1) + 1)
    missing = str(tmp_path / "no_such_annotations.json")
    with pytest.raises(FileNotFoundError, match="no_such_annotations"):
        run_training(FLAGSHIP, steps=1, synthetic=False, device="cpu", tiny=True,
                     output_dir=str(tmp_path / "run"),
                     config_modifications={"data": {"train_annotation": missing}})
