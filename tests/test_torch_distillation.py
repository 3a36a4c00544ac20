"""The port's distillation (``losses/distillation.py``, ``training/distill.py``,
``training/distill_loop.py``, ``optim.distillation_optimizer``) against the
JAX package's (CPU, JAX under ``jax.default_matmul_precision("highest")``,
inputs from a numpy seed, the same variables carried across by
``weights.from_jax_params``).

The binary KD step runs the tiny student and teacher UNets at 64 x 64,
batch 2. Its student trains every BatchNorm in train mode, down to 2 x 2
maps at stride 32, so its float32 gradient is ill-conditioned (as
``test_torch_batch_stats.py`` finds for the flagship): the gradients and
the parameters after a step are held in float64 (the port's modules
``.double()`` against JAX under ``jax.enable_x64``), and the float32 step
against JAX's float64 step with the forward's tolerances. The hierarchical
KD step runs the tiny flagship (student at mid 32, teacher at mid 48, stage
1 frozen, LayerNorm heads, norm affines perturbed): its gradients in float64
too (the KD term's float32 gradient lands a few 1e-6 from JAX's float32 one
on single elements, and at mid 16 a head gradient is 2% away in float32
while the two agree to 3e-6 in float64), its float32 step against JAX's
float64 step. Dropout is neutralised on both sides as in
``test_torch_training.py``.

Tolerances: losses and metrics within rtol 1e-5 / atol 1e-7 of JAX on the
same inputs (float32 reductions in another order); a step's loss, metrics
and gradients within rtol 1e-4 / atol 1e-6; the float64 step's running
statistics within rtol 1e-7 / atol 1e-9, its parameters within atol 1e-8
(the port's schedule and Adam bias correction are float32, as optax's are
without x64, where JAX under x64 computes them in float64: ``1 - 0.999`` in
float32 is 1.3e-5 off, so a first update of about lr moves by up to
lr x 1e-5); the float32 binary
step against JAX's float64 step: loss within rtol 1e-4, running statistics
within rtol 1e-4 / atol 1e-5, trained parameters within 3 * lr (AdamW's
first step moves each by about lr, whatever the sign of a noise-level
gradient), frozen ones bit for bit; optimizer steps within 1e-7 of optax.
"""

import contextlib
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu import config as jcfg
from human_instance_segmentation_tpu.losses import distillation as jdl
from human_instance_segmentation_tpu.models import heads as jheads
from human_instance_segmentation_tpu.models.unet import PeopleSegmentationUNet as JUNet
from human_instance_segmentation_tpu.training import distill as jdist
from human_instance_segmentation_tpu.training import distill_loop as jloop
from human_instance_segmentation_tpu.training import optim as joptim
from human_instance_segmentation_tpu.training.state import TrainState as JTrainState
from human_instance_segmentation_tpu_torch import config as pcfg
from human_instance_segmentation_tpu_torch.losses import distillation as pdl
from human_instance_segmentation_tpu_torch.losses.hierarchical import HierarchicalLossState
from human_instance_segmentation_tpu_torch.models.blocks import Dropout2d
from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet
from human_instance_segmentation_tpu_torch.ops.norms import running_stat_modules
from human_instance_segmentation_tpu_torch.parallel import launch
from human_instance_segmentation_tpu_torch.training import distill as pdist
from human_instance_segmentation_tpu_torch.training import distill_loop as ploop
from human_instance_segmentation_tpu_torch.training import optim as poptim
from human_instance_segmentation_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                                      save_checkpoint)
from human_instance_segmentation_tpu_torch.training.loop import TINY_MODEL, synthetic_batches
from human_instance_segmentation_tpu_torch.training.state import TrainState
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

FLAGSHIP = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_r64x48m128x96_"
            "disttrans_contdet_baware_from_b0")
DISTILL = "rgb_hierarchical_unet_v2_distillation_b0_from_b7_temp_prog"
IMG = (64, 64)
DECODER = (32, 24, 16, 16, 8)
LR = 1e-3
UNFROZEN = 2  # the binary step's optimizer: the last two encoder stages train
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
F64_TOL = dict(rtol=1e-7, atol=1e-9)
F64_PARAM_TOL = dict(rtol=0, atol=LR * 1e-5)
LABEL_IDS = {"train": 0, "encoder_train": 1, "frozen": 2}
RECORD = optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                      lambda grads, state, params=None: (grads, grads))
# distillation states the loss is held at: fresh, after the student beat the
# teacher (ratio > 1, alpha decayed), eliminated, alpha 0 and task weight 1
STATES = {
    "fresh": dict(temperature=4.0, alpha=0.5, task_weight=0.3, ratio=1.0, elim=False),
    "better": dict(temperature=2.5, alpha=0.21, task_weight=0.55, ratio=1.02, elim=False),
    "eliminated": dict(temperature=1.0, alpha=0.0, task_weight=1.0, ratio=1.05, elim=True),
    "alpha_zero": dict(temperature=3.0, alpha=0.0, task_weight=0.3, ratio=0.9, elim=False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _states(kind):
    s = STATES[kind]
    j = jdl.DistillationState.create(s["temperature"], s["alpha"], s["task_weight"]).replace(
        performance_ratio=jnp.asarray(s["ratio"], jnp.float32),
        eliminated=jnp.asarray(s["elim"]))
    p = pdl.DistillationState.create(s["temperature"], s["alpha"], s["task_weight"]).replace(
        performance_ratio=torch.tensor(s["ratio"], dtype=torch.float32),
        eliminated=torch.tensor(s["elim"]))
    return j, p


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), err_msg=err_msg, **tol)


def _binary_batch(seed=5):
    return next(ploop.synthetic_binary_batches(2, IMG, seed=seed))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _logits(seed, shape=(2, 16, 16, 1), scale=4.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(STATES))
@pytest.mark.parametrize("variant", ["default", "no_dice", "not_adaptive", "no_masks"])
def test_unet_distillation_loss_matches_jax(kind, variant):
    s, t = _logits(0), _logits(1, scale=6.0)  # beyond the [-10, 10] clamp in places
    masks = (np.random.default_rng(2).random((2, 16, 16, 1)) > 0.6).astype(np.float32)
    cfg_kw = {"no_dice": dict(use_dice_loss=False),
              "not_adaptive": dict(adaptive_distillation=False)}.get(variant, {})
    js, ps = _states(kind)
    m = None if variant == "no_masks" else masks
    jt, jm = jdl.unet_distillation_loss(jnp.asarray(s), jnp.asarray(t),
                                        None if m is None else jnp.asarray(m), js,
                                        jdl.DistillationConfig(**cfg_kw))
    pt, pm = pdl.unet_distillation_loss(torch.from_numpy(s), torch.from_numpy(t),
                                        None if m is None else torch.from_numpy(m), ps,
                                        pdl.DistillationConfig(**cfg_kw))
    assert set(pm) == set(jm)
    _close(pt, jt, **LOSS_TOL)
    for k, v in jm.items():
        _close(pm[k], v, err_msg=k, **LOSS_TOL)


def test_binary_dice_loss_matches_jax():
    s = _logits(3)
    t = (np.random.default_rng(4).random(s.shape) > 0.5).astype(np.float32)
    _close(pdl.binary_dice_loss(torch.from_numpy(s), torch.from_numpy(t)),
           jdl.binary_dice_loss(jnp.asarray(s), jnp.asarray(t)), **LOSS_TOL)


def test_feature_matching_loss_matches_jax():
    """Equal sizes, a student map resized to the teacher's, a layer with
    another channel count (skipped), a key only one side has; normalised
    and not."""
    rng = np.random.default_rng(6)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    s = {"l1": f(1, 8, 8, 4), "l2": f(1, 4, 4, 8), "l3": f(1, 4, 4, 6), "only_s": f(1, 2, 2, 2)}
    t = {"l1": f(1, 8, 8, 4), "l2": f(1, 8, 8, 8), "l3": f(1, 4, 4, 5), "only_t": f(1, 2, 2, 2)}
    for normalize in (True, False):
        jt, jm = jdl.feature_matching_loss({k: jnp.asarray(v) for k, v in s.items()},
                                           {k: jnp.asarray(v) for k, v in t.items()}, normalize)
        pt, pm = pdl.feature_matching_loss({k: torch.from_numpy(v) for k, v in s.items()},
                                           {k: torch.from_numpy(v) for k, v in t.items()},
                                           normalize)
        assert set(pm) == set(jm)
        _close(pt, jt, **LOSS_TOL)
        for k, v in jm.items():
            _close(pm[k], v, err_msg=k, **LOSS_TOL)


def test_hierarchical_distillation_loss_matches_jax():
    rng = np.random.default_rng(7)

    def f(*shape):
        return (3 * rng.standard_normal(shape)).astype(np.float32)

    s, t = f(3, 8, 6, 3), f(3, 8, 6, 3)
    s_aux = {"bg_fg_logits": f(3, 8, 6, 2), "target_nontarget_logits": f(3, 8, 6, 2)}
    t_aux = {"bg_fg_logits": f(3, 8, 6, 2), "target_nontarget_logits": f(3, 8, 6, 2),
             "extra": f(3, 8, 6, 1)}
    base = np.float32(0.8)
    for keep in (("bg_fg_logits", "target_nontarget_logits"), ()):
        jt, jm = jdl.hierarchical_distillation_loss(
            jnp.asarray(s), jnp.asarray(t), {k: jnp.asarray(s_aux[k]) for k in keep},
            {k: jnp.asarray(v) for k, v in t_aux.items()}, jnp.asarray(base), 3.0, 0.6, 0.25)
        pt, pm = pdl.hierarchical_distillation_loss(
            torch.from_numpy(s), torch.from_numpy(t), {k: torch.from_numpy(s_aux[k]) for k in keep},
            {k: torch.from_numpy(v) for k, v in t_aux.items()}, torch.tensor(base), 3.0, 0.6, 0.25)
        assert set(pm) == set(jm)
        for k, v in jm.items():
            _close(pm[k], v, err_msg=k, **LOSS_TOL)
        _close(pt, jt, **LOSS_TOL)


@pytest.mark.parametrize("features", ["mse", "cosine", None])
def test_yolo_distillation_loss_matches_jax(features):
    rng = np.random.default_rng(8)
    s, t = _logits(9), _logits(10)
    masks = (rng.random((2, 16, 16)) > 0.5).astype(np.float32)  # (B, H, W): gains an axis
    sf = rng.standard_normal((2, 2, 2, 16)).astype(np.float32)
    yf = rng.standard_normal((2, 2, 2, 16)).astype(np.float32)
    kw = dict(feature_loss_type=features or "mse", temperature=2.0)
    jt, jm = jdl.yolo_distillation_loss(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(masks),
        None if features is None else jnp.asarray(sf),
        None if features is None else jnp.asarray(yf), **kw)
    pt, pm = pdl.yolo_distillation_loss(
        torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(masks),
        None if features is None else torch.from_numpy(sf),
        None if features is None else torch.from_numpy(yf), **kw)
    assert set(pm) == set(jm)
    for k, v in jm.items():
        _close(pm[k], v, err_msg=k, **LOSS_TOL)
    with pytest.raises(ValueError):
        pdl.yolo_distillation_loss(torch.from_numpy(s), torch.from_numpy(t),
                                   torch.from_numpy(masks), torch.from_numpy(sf),
                                   torch.from_numpy(yf), feature_loss_type="l1")


@pytest.mark.parametrize("schedule", ["linear", "cosine", "exponential", "unknown"])
def test_scheduled_temperature_matches_jax(schedule):
    jc = jdl.DistillationConfig(initial_temperature=10.0, final_temperature=1.0,
                                schedule_type=schedule)
    pc = pdl.DistillationConfig(initial_temperature=10.0, final_temperature=1.0,
                                schedule_type=schedule)
    for total in (1, 2, 7, 100):
        got = [pdl.scheduled_temperature(pc, e, total) for e in range(total)]
        assert got == [jdl.scheduled_temperature(jc, e, total) for e in range(total)]
    if schedule != "unknown":
        assert pdl.scheduled_temperature(pc, 0, 7) == 10.0
        assert pdl.scheduled_temperature(pc, 6, 7) == pytest.approx(1.0)


def test_update_adaptive_weights_through_an_elimination():
    """A sequence of validation IoUs: behind the teacher (initial weights),
    ahead by less than 3% (alpha decays, the task weight rises), ahead by
    more (eliminated), then behind again (elimination is permanent); every
    field equal to JAX's within float32 rounding, and a non-adaptive config
    leaving the state alone."""
    jc, pc = jdl.DistillationConfig(), pdl.DistillationConfig()
    js = jdl.DistillationState.create(4.0, jc.initial_alpha, jc.initial_task_weight)
    ps = pdl.DistillationState.create(4.0, pc.initial_alpha, pc.initial_task_weight)
    teacher = 0.6
    seen = []
    for student in (0.5, 0.605, 0.61, 0.7, 0.4):
        js = jdl.update_adaptive_weights(js, jc, jnp.asarray(student), jnp.asarray(teacher))
        ps = pdl.update_adaptive_weights(ps, pc, student, teacher)
        for f in pdl.DistillationState.FIELDS:
            _close(getattr(ps, f), getattr(js, f), err_msg=f, rtol=1e-6, atol=1e-7)
        assert ps.eliminated.dtype == torch.bool and ps.alpha.dtype == torch.float32
        seen.append((bool(ps.eliminated), float(ps.alpha), float(ps.task_weight)))
    assert seen[0] == (False, 0.5, pytest.approx(0.3))
    assert not seen[1][0] and 0 < seen[1][1] < 0.5 and 0.3 < seen[1][2] < 1.0
    assert [e for e, _, _ in seen] == [False, False, False, True, True]
    assert seen[-1][1:] == (0.0, 1.0)
    off = pdl.DistillationConfig(adaptive_distillation=False)
    assert pdl.update_adaptive_weights(ps, off, 0.9, 0.1) is ps


def test_distillation_state_round_trip():
    s = pdl.DistillationState.create(7.0, 0.4, 0.2).replace(eliminated=torch.tensor(True))
    back = pdl.DistillationState.from_state_dict(
        {k: v.clone() for k, v in s.state_dict().items()}, "cpu")
    for f in pdl.DistillationState.FIELDS:
        assert torch.equal(getattr(back, f), getattr(s, f)), f


# ---------------------------------------------------------------------------
# progressive unfreezing and the distillation optimizer against optax
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet_variables():
    jm = JUNet(encoder_variant="tiny", decoder_channels=DECODER)
    v = fast_init(jm, jnp.zeros((1, *IMG, 3)), train=False, seed=3)
    rng = np.random.default_rng(4)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if path[0].key == "params" and str(path[-1].key) in ("scale", "bias"):
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(perturb, v))


def _port_unet(variables, **kw):
    m = PeopleSegmentationUNet("tiny", decoder_channels=DECODER, **kw)
    load_jax_params(m, variables)
    return m


@pytest.mark.parametrize("unfrozen", [0, 2, 4, 7])
def test_progressive_unfreeze_labels_match_jax(unet_variables, unfrozen):
    """Every parameter's label (decoder "train", encoder stages and stem
    "encoder_train" or "frozen") equal to JAX's label of the same leaf."""
    params = unet_variables["params"]
    jlabels = joptim.label_params(params, joptim.progressive_unfreeze_rules(unfrozen))
    ids = jax.tree.map(lambda lab, leaf: np.full(leaf.shape, LABEL_IDS[lab], np.float32),
                       jlabels, params)
    want = {k: int(v.flatten()[0]) for k, v in from_jax_params({"params": ids}).items()}
    model = _port_unet(unet_variables)
    got = poptim.label_params([n for n, _ in model.named_parameters()],
                              poptim.progressive_unfreeze_rules(unfrozen))
    assert {k: LABEL_IDS[v] for k, v in got.items()} == want
    trained = {v for k, v in got.items() if k.startswith("encoder.stage")}
    assert trained == ({"frozen"} if unfrozen == 0 else {"encoder_train"} if unfrozen == 7
                       else {"frozen", "encoder_train"})
    assert got["encoder.stem_conv.weight"] == ("encoder_train" if unfrozen == 7 else "frozen")
    assert got["decoder0.conv0.weight"] == "train"


@pytest.mark.parametrize("unfrozen", [0, 4])
def test_distillation_optimizer_matches_optax(unet_variables, unfrozen):
    """Three steps of ``distillation_optimizer`` on random gradients, large
    enough that the global clip at 5 acts, from the tiny UNet's parameters:
    the parameters after each step within 1e-7 of optax's (frozen stages
    unchanged), the step counts per group, and a clip over every gradient
    (the frozen ones' included), as ``optax.chain`` puts it first."""
    params = jax.tree.map(jnp.asarray, unet_variables["params"])
    jsched = joptim.build_schedule(LR, 2, 10, "cosine", 1e-6)
    jtx = joptim.distillation_optimizer(params, jsched, unfrozen, encoder_lr_scale=0.3,
                                        weight_decay=1e-4, gradient_clip=5.0)
    jstate = jtx.init(params)
    jupdate = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
        *jtx.update(g, st, p)))
    model = _port_unet(unet_variables)
    opt = poptim.distillation_optimizer(model, poptim.build_schedule(LR, 2, 10, "cosine", 1e-6),
                                        unfrozen, encoder_lr_scale=0.3, weight_decay=1e-4,
                                        gradient_clip=5.0)
    assert opt.clip == 5.0 and set(opt.count) == set(LABEL_IDS)
    rng = np.random.default_rng(11)
    names = [n for n, _ in model.named_parameters()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.5).astype(np.float32), params)
        params, jstate = jupdate(g, jstate, params)
        grads = from_jax_params({"params": g})
        opt.step([grads[n] for n in names])
        want = from_jax_params({"params": jax.tree.map(np.asarray, params)})
        for n, p in model.named_parameters():
            _close(p, want[n], err_msg=f"step {i} {n}", rtol=0, atol=1e-7)
    labels = poptim.label_params(names, poptim.progressive_unfreeze_rules(unfrozen))
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]) == (labels[n] == "frozen"), n
    # a group without parameters takes no step (optax's would count them)
    assert opt.count == {"train": 3, "encoder_train": 3 if unfrozen else 0, "frozen": 0}


# ---------------------------------------------------------------------------
# the binary KD step against JAX's make_distill_train_step
# ---------------------------------------------------------------------------


def _jax_binary_step(student_vars, teacher_vars, dtype):
    js = JUNet(encoder_variant="tiny", decoder_channels=DECODER)
    jt = JUNet(encoder_variant="tiny", decoder_channels=DECODER)
    batch = _binary_batch()
    with jax.enable_x64(dtype == "float64"):
        if dtype == "float64":
            student_vars, teacher_vars = (jax.tree.map(lambda a: np.asarray(a, np.float64), v)
                                          for v in (student_vars, teacher_vars))
            batch = dict(batch, images=batch["images"].astype(np.float64))
        tx = optax.chain(RECORD, joptim.distillation_optimizer(
            student_vars["params"], joptim.build_schedule(LR, 2, 10, "cosine", 1e-6), UNFROZEN))
        ds = jdl.DistillationState.create(temperature=4.0, alpha=0.5, task_weight=0.3)
        state = JTrainState.create(student_vars, tx, jax.random.PRNGKey(2), distill_state=ds)
        step = jdist.make_distill_train_step(js, jt, teacher_vars, tx, jdl.DistillationConfig())
        state, metrics = step(state, batch)
        state = jax.tree.map(np.asarray, state)
        return {"loss": float(metrics["total_loss"]),
                "metrics": {k: np.asarray(v) for k, v in metrics.items()},
                "params": from_jax_params({"params": state.params}),
                "stats": from_jax_params({"batch_stats": state.batch_stats}),
                "grads": from_jax_params({"params": state.opt_state[0]})}


@pytest.fixture(scope="module")
def binary_ref(unet_variables):
    jt = JUNet(encoder_variant="tiny", decoder_channels=DECODER)
    teacher = jax.tree.map(np.asarray, fast_init(jt, jnp.zeros((1, *IMG, 3)), train=False, seed=8))
    with jax.default_matmul_precision("highest"):
        return {"student": unet_variables, "teacher": teacher,
                "float64": _jax_binary_step(unet_variables, teacher, "float64")}


def _binary_port(ref, dtype=torch.float32, **teacher_kw):
    student = _port_unet(ref["student"]).to(dtype)
    teacher = _port_unet(ref["teacher"], **teacher_kw).to(dtype).eval()
    opt = poptim.distillation_optimizer(
        student, poptim.build_schedule(LR, 2, 10, "cosine", 1e-6), UNFROZEN)
    state = TrainState.create(student, opt, seed=2,
                              distill_state=pdl.DistillationState.create(4.0, 0.5, 0.3))
    return student, teacher, state


def _stats(model):
    mods = running_stat_modules(model)
    return {f"{name}.{b}": getattr(m, b).clone()
            for name, m in model.named_modules() if m in mods
            for b in ("running_mean", "running_var")}


def test_binary_distill_gradients_match_jax_float64(binary_ref):
    """Loss and every student parameter's gradient of the binary KD step,
    the port in float64 against JAX's float64 step."""
    r = binary_ref["float64"]
    student, teacher, state = _binary_port(binary_ref, torch.float64)
    student.train()
    loss_fn = pdist.make_distill_loss_fn(student, teacher)
    batch = pdist.batch_to(_binary_batch(), "cpu")
    loss, (_, metrics) = loss_fn(state.distill_state, batch)
    _close(loss, r["loss"], rtol=1e-10)
    assert set(metrics) == set(r["metrics"])
    named = list(student.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert {n for n, _ in named} == set(r["grads"])
    for (name, _), g in zip(named, grads):
        _close(g, r["grads"][name].numpy(), err_msg=name, **STEP_TOL)


def test_binary_distill_step_matches_jax_float64(binary_ref):
    """The whole step in float64: the parameters after it (the frozen
    encoder stages unchanged) and the student's running statistics."""
    r = binary_ref["float64"]
    student, teacher, state = _binary_port(binary_ref, torch.float64)
    state, metrics = pdist.make_distill_train_step(student, teacher)(state, _binary_batch())
    assert state.step == 1 and state.skipped == 0
    for k, v in r["metrics"].items():
        _close(metrics[k], v, err_msg=k, rtol=1e-9, atol=1e-12)
    for n, p in student.named_parameters():
        _close(p, r["params"][n].numpy(), err_msg=n, **F64_PARAM_TOL)
    for n, v in _stats(student).items():
        _close(v, r["stats"][n].numpy(), err_msg=n, **F64_TOL)


def test_binary_distill_step_float32(binary_ref):
    """The float32 step against JAX's float64 step: loss and metrics,
    running statistics, trained parameters within 3 * lr, frozen ones bit
    for bit; the teacher's weights untouched."""
    r = binary_ref["float64"]
    student, teacher, state = _binary_port(binary_ref)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    stats_before = _stats(student)
    state, metrics = pdist.make_distill_train_step(student, teacher)(state, _binary_batch())
    assert state.skipped == 0 and metrics["total_loss"].dtype == torch.float32
    for k, v in r["metrics"].items():
        _close(metrics[k], v, err_msg=k, **STEP_TOL)
    labels = poptim.label_params(before, poptim.progressive_unfreeze_rules(UNFROZEN))
    for n, p in student.named_parameters():
        if labels[n] == "frozen":
            assert torch.equal(p.detach(), before[n]), n
        else:
            _close(p, r["params"][n].numpy(), err_msg=n, rtol=0, atol=3 * LR)
    for n, v in _stats(student).items():
        _close(v, r["stats"][n].numpy(), err_msg=n, rtol=1e-4, atol=1e-5)
        assert not torch.equal(v, stats_before[n]), n
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, t_before[k]), k


def test_binary_distill_teacher_routes(binary_ref):
    """A teacher built with ``pallas_tail=True`` (its dense (B, H, W) map,
    read as (B, H, W, 1)) and ``encoder_fused_blocks=3`` (their plain
    versions on the CPU) gives the step the same loss and metrics as the
    plain teacher."""
    out = []
    for kw in ({}, dict(pallas_tail=True, encoder_fused_blocks=3)):
        student, teacher, state = _binary_port(binary_ref, **kw)
        x = torch.from_numpy(_binary_batch()["images"])
        with torch.no_grad():
            logits = pdist.unet_logits(teacher, x)
        assert logits.shape == (2, *IMG, 1)
        out.append((logits, pdist.make_distill_train_step(student, teacher)(
            state, _binary_batch())[1]))
    _close(out[1][0], out[0][0].numpy(), rtol=1e-5, atol=1e-5)
    for k, v in out[0][1].items():
        _close(out[1][1][k], v.numpy(), err_msg=k, rtol=1e-5, atol=1e-6)


def test_binary_distill_bf16(binary_ref, monkeypatch):
    """``compute_dtype="bfloat16"``: the masters, statistics and optimizer
    state stay float32, the loss is close to the float32 step's, and the
    teacher's bf16 copy is made when the step is built, not in a step."""
    student, teacher, state = _binary_port(binary_ref)
    calls = []
    real = pdist.teacher_copy
    monkeypatch.setattr(pdist, "teacher_copy", lambda t, cd: calls.append(cd) or real(t, cd))
    step = pdist.make_distill_train_step(student, teacher, compute_dtype="bfloat16")
    assert calls == ["bfloat16"]
    state, metrics = step(state, _binary_batch())
    _close(metrics["total_loss"], binary_ref["float64"]["loss"], rtol=0.05)
    state, _ = step(state, _binary_batch(seed=6))
    assert calls == ["bfloat16"] and state.skipped == 0
    t16 = real(teacher, "bfloat16")
    assert t16 is not teacher and not t16.training
    assert {t.dtype for t in t16.state_dict().values()} == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in student.parameters())
    assert all(b.dtype == torch.float32 for b in student.buffers() if b.is_floating_point())
    assert all(t.dtype == torch.float32 for t in state.optimizer.mu.values())
    assert next(teacher.parameters()).dtype == torch.float32


def test_nan_batch_is_skipped(binary_ref):
    """A NaN image: parameters, running statistics and the optimizer state
    bitwise unchanged, ``skipped == 1``, the step advances."""
    student, teacher, state = _binary_port(binary_ref)
    step = pdist.make_distill_train_step(student, teacher)
    state, _ = step(state, _binary_batch())
    params = {n: p.detach().clone() for n, p in student.named_parameters()}
    stats = _stats(student)
    mu = {k: v.clone() for k, v in state.optimizer.mu.items()}
    count = dict(state.optimizer.count)
    bad = _binary_batch(seed=6)
    bad["images"][1, 3, 4, 0] = np.nan
    state, metrics = step(state, bad)
    assert not np.isfinite(float(metrics["total_loss"]))
    assert state.step == 2 and state.skipped == 1
    for n, p in student.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    for n, v in _stats(student).items():
        assert torch.equal(v, stats[n]), n
    assert state.optimizer.count == count
    for k, v in state.optimizer.mu.items():
        assert torch.equal(v, mu[k]), k


def test_epoch_update_matches_jax(unet_variables):
    """The temperature of each epoch and, with validation IoUs, the adaptive
    weights, equal to JAX's ``epoch_update`` on a JAX state."""
    jcfg_kd = jdl.DistillationConfig(amplification_factor=30.0)
    pcfg_kd = pdl.DistillationConfig(amplification_factor=30.0)
    jstate = JTrainState.create(unet_variables, optax.sgd(0.1), jax.random.PRNGKey(0),
                                distill_state=jdl.DistillationState.create(10.0, 0.7, 0.3))
    model = _port_unet(unet_variables)
    pstate = TrainState.create(model, poptim.Transform("sgd", poptim.constant_schedule(0.1)),
                               distill_state=pdl.DistillationState.create(10.0, 0.7, 0.3))
    for epoch, ious in ((0, None), (0, (0.4, 0.5)), (1, (0.52, 0.5)), (2, None), (3, (0.6, 0.5))):
        kw = {} if ious is None else dict(student_iou=ious[0], teacher_iou=ious[1])
        jstate = jdist.epoch_update(jstate, jcfg_kd, epoch, 5, **kw)
        assert pdist.epoch_update(pstate, pcfg_kd, epoch, 5, **kw) is pstate
        for f in pdl.DistillationState.FIELDS:
            _close(getattr(pstate.distill_state, f), getattr(jstate.distill_state, f),
                   err_msg=f"{epoch} {f}", rtol=1e-6, atol=1e-7)
    assert bool(pstate.distill_state.eliminated)


# ---------------------------------------------------------------------------
# hierarchical KD against JAX's make_hierarchical_distill_step
# ---------------------------------------------------------------------------


def _tiny_cfg(mod):
    cfg = mod.ConfigManager.get_config(FLAGSHIP)
    cfg.model.image_size = IMG
    cfg.model.roi_size = (16, 12)
    cfg.model.mask_size = (32, 24)
    cfg.model.encoder_name = "tiny"
    cfg.model.hierarchical_base_channels = 16
    cfg.model.hierarchical_depth = 2
    return cfg


TEACHER_HEAD = dict(TINY_MODEL, mid_channels=48)


def _perturbed(variables, seed):
    """Norm scales and biases moved off 1 and 0, as test_torch_training.py
    moves them."""
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        owner = str(getattr(path[-2], "key", path[-2]))
        if path[0].key == "params" and name in ("scale", "bias") and owner != "output_conv":
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(perturb, variables))


def _hier_batch():
    b = next(synthetic_batches(2, 2, IMG, (32, 24), seed=5))
    b["valid"][1, 1] = 0.0
    return b


@pytest.fixture(scope="module")
def hier_ref():
    cfg = _tiny_cfg(jcfg)
    js = jcfg.model_from_config(cfg).clone(**TINY_MODEL)
    jt = jcfg.model_from_config(cfg).clone(**TEACHER_HEAD)
    args = (jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)))
    sv = _perturbed(fast_init(js, *args, train=False, seed=3), 4)
    tv = _perturbed(fast_init(jt, *args, train=False, seed=9), 10)
    tx = optax.chain(RECORD, joptim.build_optimizer(joptim.build_schedule(LR, 1, 100, "cosine",
                                                                          1e-6, 0),
                                                    "adamw", 1e-4, 5.0))
    batch = _hier_batch()
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"), \
            jax.enable_x64(True):
        mp.setattr(jheads, "Dropout2d", lambda rate, name=None: (lambda x, train=False: x))
        step = jdist.make_hierarchical_distill_step(
            js, jt, _f64(tv), tx, jcfg.loss_config_from_experiment(cfg), temperature=3.0,
            alpha=0.6, aux_weight=0.3)
        state, metrics = step(JTrainState.create(_f64(sv), tx, jax.random.PRNGKey(1)),
                              dict(batch, images=batch["images"].astype(np.float64),
                                   boxes=batch["boxes"].astype(np.float64)))
        state = jax.tree.map(np.asarray, state)
    return {"student": sv, "teacher": tv,
            "metrics": {k: np.asarray(v) for k, v in metrics.items()},
            "loss_state": state.loss_state,
            "params": from_jax_params({"params": state.params}),
            "grads": from_jax_params({"params": state.opt_state[0]})}


def _f64(variables):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def _hier_port(ref, **teacher_kw):
    cfg = _tiny_cfg(pcfg)
    student = pcfg.model_from_config(cfg, device="cpu", **TINY_MODEL)
    teacher = pcfg.model_from_config(cfg, device="cpu", **TEACHER_HEAD, **teacher_kw)
    load_jax_params(student, ref["student"])
    load_jax_params(teacher, ref["teacher"])
    for m in student.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return student, teacher, pcfg.loss_config_from_experiment(cfg)


def _port_tx():
    return poptim.build_optimizer(poptim.build_schedule(LR, 1, 100, "cosine", 1e-6, 0),
                                  "adamw", 1e-4, 5.0)


@contextlib.contextmanager
def _one_rank_mesh():
    """A mesh over a Gloo process group of this one process."""
    import torch.distributed as dist

    from human_instance_segmentation_tpu_torch.parallel.launch import free_port
    from human_instance_segmentation_tpu_torch.parallel.mesh import INIT_TIMEOUT, create_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, timeout=INIT_TIMEOUT)
    try:
        yield create_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_hierarchical_distill_gradients_match_jax(hier_ref):
    """Loss, every metric (the refined loss's and ``kd_*``), the new loss
    state and every student gradient (the frozen stage 1 has none here and
    zeros in JAX), the port in float64 against JAX's float64 step."""
    student, teacher, loss_cfg = _hier_port(hier_ref)
    student, teacher = student.double(), teacher.double()
    student.train()
    loss_fn = pdist.make_hierarchical_distill_loss_fn(student, teacher, loss_cfg, 3.0, 0.6, 0.3)
    loss, (new_ls, _, metrics) = loss_fn(HierarchicalLossState.create(),
                                         torch.Generator().manual_seed(0),
                                         pdist.batch_to(_hier_batch(), "cpu"))
    assert set(metrics) == set(hier_ref["metrics"])
    assert {"kd_final", "kd_bg_fg_logits", "kd_target_nontarget_logits"} <= set(metrics)
    for k, v in hier_ref["metrics"].items():
        _close(metrics[k], v, err_msg=k, **STEP_TOL)
    for f in HierarchicalLossState.FIELDS:
        _close(getattr(new_ls, f), getattr(hier_ref["loss_state"], f), err_msg=f, **STEP_TOL)
    named = list(student.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    assert {n for n, _ in named} == set(hier_ref["grads"])
    for (name, _), g in zip(named, grads):
        want = hier_ref["grads"][name].numpy()
        if name.startswith(("pretrained_unet.", "unet_wrapper.")):
            assert g is None, name
        if g is None:
            assert not want.any(), name
            continue
        _close(g, want, err_msg=name, **STEP_TOL)


def test_hierarchical_distill_step_matches_jax(hier_ref, binary_ref):
    """The float32 step against JAX's float64 step: loss and metrics, the
    parameters after it (the frozen stage 1 decayed by AdamW as JAX's
    unmasked AdamW does); the teacher untouched and left in eval mode; with
    ``mesh=`` at one rank, the same step bit for bit (and the binary KD
    step's too)."""
    student, teacher, loss_cfg = _hier_port(hier_ref)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = TrainState.create(student, _port_tx(), seed=1)
    step = pdist.make_hierarchical_distill_step(student, teacher, loss_cfg, 3.0, 0.6, 0.3)
    state, metrics = step(state, _hier_batch())
    assert state.step == 1 and state.skipped == 0
    for k, v in hier_ref["metrics"].items():
        _close(metrics[k], v, err_msg=k, **STEP_TOL)
    for n, p in student.named_parameters():
        frozen = n.startswith(("pretrained_unet.", "unet_wrapper."))
        _close(p, hier_ref["params"][n].numpy(), err_msg=n, rtol=0,
               atol=1e-7 if frozen else 3 * LR)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, t_before[k]), k
    assert not teacher.training
    # data parallel at one rank (a Gloo group of one process): the mean over
    # one rank leaves the step bit for bit as it is
    with _one_rank_mesh() as mesh:
        student_m, teacher_m, _ = _hier_port(hier_ref)
        state_m = TrainState.create(student_m, _port_tx(), seed=1)
        state_m, metrics_m = pdist.make_hierarchical_distill_step(
            student_m, teacher_m, loss_cfg, 3.0, 0.6, 0.3, mesh=mesh)(state_m, _hier_batch())
    assert torch.equal(metrics_m["total_loss"], metrics["total_loss"])
    for (n, p), (_, q) in zip(student.named_parameters(), student_m.named_parameters()):
        assert torch.equal(p, q), n
    # and the binary KD step
    runs = []
    for one_rank in (False, True):
        b_student, b_teacher, b_state = _binary_port(binary_ref)
        with _one_rank_mesh() if one_rank else contextlib.nullcontext() as mesh:
            b_state, b_metrics = pdist.make_distill_train_step(b_student, b_teacher, mesh=mesh)(
                b_state, _binary_batch())
        runs.append((b_metrics["total_loss"], dict(b_student.state_dict())))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_hierarchical_teacher_kernel_routes(hier_ref):
    """A teacher with the fused tail, the fused encoder blocks and the
    kernel crop (their plain versions on the CPU) gives the step the loss
    of the plain teacher."""
    losses = []
    for kw in ({}, dict(pallas_tail=True, encoder_fused_blocks=3, pallas_roi_align=True)):
        student, teacher, loss_cfg = _hier_port(hier_ref, **kw)
        state = TrainState.create(student, _port_tx(), seed=1)
        _, m = pdist.make_hierarchical_distill_step(student, teacher, loss_cfg, 3.0, 0.6, 0.3)(
            state, _hier_batch())
        losses.append(float(m["total_loss"]))
    _close(losses[1], losses[0], rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints, the loop and the CLI
# ---------------------------------------------------------------------------


def test_synthetic_binary_batches_equal_jax():
    for seed in (0, 1234):
        pg = ploop.synthetic_binary_batches(3, (48, 40), seed=seed)
        jg = jloop.synthetic_binary_batches(3, (48, 40), seed=seed)
        for _ in range(3):
            p, j = next(pg), next(jg)
            assert p.keys() == j.keys()
            for k in p:
                assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k]), k


def test_checkpoint_carries_the_distill_state(binary_ref, tmp_path):
    """The distillation state is written and restored; a checkpoint written
    without one leaves the restored state's own."""
    student, _, state = _binary_port(binary_ref)
    state.distill_state = state.distill_state.replace(
        temperature=torch.tensor(2.5), eliminated=torch.tensor(True))
    save_checkpoint(str(tmp_path / "a"), state, 1)
    plain = TrainState.create(student, poptim.Transform("sgd", poptim.constant_schedule(0.1)))
    save_checkpoint(str(tmp_path / "b"), plain, 1)

    _, _, fresh = _binary_port(binary_ref)
    fresh, step = restore_checkpoint(str(tmp_path / "a"), fresh)
    assert step == 1
    for f in pdl.DistillationState.FIELDS:
        assert torch.equal(getattr(fresh.distill_state, f), getattr(state.distill_state, f)), f
    s2, _, other = _binary_port(binary_ref)
    other.optimizer = poptim.Transform("sgd", poptim.constant_schedule(0.1)).init(s2)
    own = other.distill_state
    other, _ = restore_checkpoint(str(tmp_path / "b"), other)
    assert other.distill_state is own


RESUME = {
    # unfreeze_schedule: the unfreeze the resumed loop applies at its first
    # epoch, and one applied before the checkpoint (replayed at the resume)
    "unfreeze_after_resume": {"1": 2},
    "unfreeze_replayed": {"0": 2},
}


@pytest.mark.parametrize("case", sorted(RESUME))
def test_resumed_distillation_is_bit_exact(case, tmp_path):
    """``run_distillation --tiny --device cpu``, 2 epochs x 2 steps: the run
    stopped after its first epoch (its first checkpoint alone on disk) and
    resumed ends bit for bit where the uninterrupted run ends: parameters,
    running statistics, optimizer state, distillation state, metrics."""
    mods = {"distillation": {"unfreeze_schedule": RESUME[case]}}
    kw = dict(epochs=2, steps_per_epoch=2, synthetic=True, tiny=True, device="cpu",
              config_modifications=mods, return_state=True)
    whole, ws = ploop.run_distillation(DISTILL, output_dir=str(tmp_path / "a"), **kw)
    ckpts = tmp_path / "a" / "checkpoints"
    assert (ckpts / "ckpt_1.pt").exists()
    (tmp_path / "b" / "checkpoints").mkdir(parents=True)
    for name in ("ckpt_1.pt", "metadata_1.json"):
        shutil.copy(ckpts / name, tmp_path / "b" / "checkpoints" / name)
    meta = json.loads((ckpts / "metadata_1.json").read_text())
    assert set(meta) == {"student_miou", "teacher_miou", "num_unfrozen"}
    assert meta["num_unfrozen"] == (2 if case == "unfreeze_replayed" else 0)
    resumed, rs = ploop.run_distillation(DISTILL, output_dir=str(tmp_path / "b"), resume=True,
                                         **kw)
    assert resumed == whole
    assert rs.step == ws.step == 4 and rs.skipped == ws.skipped == 0
    for (n, a), b in zip(ws.model.state_dict().items(), rs.model.state_dict().values()):
        assert torch.equal(a, b), n
    wo, ro = ws.optimizer.state_dict(), rs.optimizer.state_dict()
    assert wo["count"] == ro["count"] and wo["count"]["encoder_train"] > 0
    for slot in ("mu", "nu"):
        assert wo[slot].keys() == ro[slot].keys()
        for k, t in wo[slot].items():
            assert torch.equal(t, ro[slot][k]), (slot, k)
    for f in pdl.DistillationState.FIELDS:
        assert torch.equal(getattr(ws.distill_state, f), getattr(rs.distill_state, f)), f
    assert float(ws.distill_state.temperature) == 1.0  # the cosine schedule's last epoch


def test_distill_cli(tmp_path, monkeypatch, capsys):
    """The CLI at ``--tiny --device cpu``: 2 epochs x 2 steps with an unfreeze
    at epoch 1, the JSON report with the JAX loop's keys, finite losses, the
    unfreeze and the checkpoints logged; ``--devices 2`` distils on two Gloo
    ranks for one step, rank 0 alone writing, and more CUDA ranks than cards
    raise."""
    mods = json.dumps({"distillation": {"unfreeze_schedule": {"1": 2}}})
    argv = ["distill_loop", "--config", DISTILL, "--epochs", "2", "--steps-per-epoch", "2",
            "--synthetic", "--tiny", "--device", "cpu", "--output_dir", str(tmp_path),
            "--config_modifications", mods]
    monkeypatch.setattr(sys, "argv", argv)
    ploop.main()
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert {"kl_loss", "mse_loss", "bce_loss", "dice_loss", "total_loss", "temperature",
            "alpha", "task_weight", "student_miou", "teacher_miou", "best_student_miou",
            "eliminated"} <= set(report)
    assert all(np.isfinite(v) for v in report.values())
    assert "epoch 1: unfroze last 2 encoder stages" in out
    assert any(tmp_path.glob("checkpoints/ckpt_*.pt"))
    # two data-parallel ranks on the CPU for one step: rank 0 alone writes
    # (the ranks are killed after 240 s)
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", 240.0)
    dp_dir = tmp_path / "dp"
    monkeypatch.setattr(sys, "argv", ["distill_loop", "--config", DISTILL, "--epochs", "1",
                                      "--steps-per-epoch", "1", "--synthetic", "--tiny",
                                      "--device", "cpu", "--output_dir", str(dp_dir),
                                      "--devices", "2"])
    ploop.main()
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert np.isfinite(report["total_loss"]) and report["best_student_miou"] > 0
    assert [p.name for p in dp_dir.glob("checkpoints/ckpt_*.pt")] == ["ckpt_1.pt"]
    logs = list(dp_dir.glob("logs/*.log"))
    assert len(logs) == 1 and logs[0].read_text().count("new best student mIoU") == 1
    with pytest.raises(ValueError, match=r"need \d+ devices, have \d+"):
        ploop.run_distillation(DISTILL, epochs=1, steps_per_epoch=1, synthetic=True, tiny=True,
                               devices=max(torch.cuda.device_count(), 1) + 1, device="cuda")
