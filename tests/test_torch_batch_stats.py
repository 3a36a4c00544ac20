"""The train step with running statistics against the JAX package's
``make_train_step`` (CPU, JAX under ``jax.default_matmul_precision(
"highest")``, inputs from a numpy seed, the same float32 variables through
``weights.from_jax_params``), and the port's own rules for them: the NaN
guard, checkpoints, the fused stage-1 caches.

The tiny flagship runs with BatchNorm heads (``norm="batchnorm"``, every
stage-2 norm trains its statistics), the attention module and the boundary
refinement, without the contour and distance branches (a smaller program
for JAX to compile; the loss is the ROI-pretrained config's, which has no
terms for them). Two cases (``CASES``): "float32", stage 1 unfrozen, so its
BatchNorms train too; "bfloat16", stage 1 frozen and no boundary
refinement (so the guided head), a bf16 step holding both of JAX's rules
for a bf16 step's statistics: trained ones are ``0.9 * bf16(running)``
rounded to bf16 plus the float32 ``0.1 * batch`` term, the frozen stage
1's come back as ``bf16(running)``.

The references are JAX steps in float64 (``jax.enable_x64``) for both
cases' models, and JAX's bf16 step for the "bfloat16" case. Float64,
because this model's float32 gradient is ill-conditioned: BatchNorm in
train mode over a 2-image batch, with ROI maps of a few pixels, cancels
most of each sum, so JAX's own float32 gradient differs from its float64
one by up to 8% of a tensor's norm (and the convs feeding a BatchNorm have
a true bias gradient of 0, which float32 gives as noise). In float64 the
port's gradients agree with JAX's to 6e-12 of each tensor's norm.

Tolerances: the gradients, the port's in float64 against JAX's in
float64, within rtol 1e-4 / atol 1e-6. The float32 step against JAX's
float64 step: loss within rtol 1e-4 / atol 1e-6, running statistics within
the forward's rtol 1e-4 / atol 1e-5 (means of activations through up to
thirty layers; ``test_torch_norms_attention.py`` holds one norm's within
atol 1e-6), parameters within 3 * lr (AdamW's first step moves each by
about lr, whatever the sign of a noise-level gradient). The bf16 step
against JAX's bf16 step: loss within rtol 1e-3 (measured 3.8e-4: bf16
activations, rounded by XLA's and by PyTorch's bf16 convs, which are not
bitwise equal; a float32 step lands 4.0e-4 from it too, so every conv of
the step is held to bf16 output instead), trained statistics within atol
1e-2 + rtol 2e-2 (0.1 x the batch moments of those bf16 activations, which
after up to thirty bf16 layers differ by a few bf16 steps between the
packages; measured up to 8.5e-4 on a mean and 4.1e-3, 0.38%, on a
variance; the rounding rule itself is held within atol 1e-6 on one module
in ``test_torch_norms_attention.py``), the frozen statistics bit for bit.
Dropout is neutralised on both sides as in ``test_torch_training.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from helpers import fast_init
from human_instance_segmentation_tpu import config as jcfg
from human_instance_segmentation_tpu.models import assembly as jasm
from human_instance_segmentation_tpu.models import heads as jheads
from human_instance_segmentation_tpu.training import optim as joptim
from human_instance_segmentation_tpu.training import steps as jsteps
from human_instance_segmentation_tpu.training.state import TrainState as JTrainState
from human_instance_segmentation_tpu_torch import config as pcfg
from human_instance_segmentation_tpu_torch.losses.hierarchical import HierarchicalLossState
from human_instance_segmentation_tpu_torch.models import assembly as pasm
from human_instance_segmentation_tpu_torch.models.blocks import Dropout2d
from human_instance_segmentation_tpu_torch.ops.norms import running_stat_modules
from human_instance_segmentation_tpu_torch.training import optim as poptim
from human_instance_segmentation_tpu_torch.training import steps as psteps
from human_instance_segmentation_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                                      save_checkpoint)
from human_instance_segmentation_tpu_torch.training.loop import synthetic_batches
from human_instance_segmentation_tpu_torch.training.state import TrainState
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

LR = 1e-3
IMG = (64, 64)
MASK = (32, 24)
LOSS_CONFIG = "rgb_hierarchical_unet_v2_pretrained_peopleseg_r64x48m64x48"
TINY = dict(encoder_variant="tiny", roi_size=(16, 12), mask_size=MASK, image_size=IMG,
            feature_dim=32, mid_channels=32, base_channels=16, depth=2,
            unet_decoder_channels=(32, 24, 16, 16, 8), norm="batchnorm",
            use_attention_module=True, use_boundary_refinement=True,
            use_contour_detection=False, use_distance_transform=False)
# bf16 without the boundary refinement: the JAX module's gradient is NaN
# where bf16 probabilities tie, so JAX skips such a step (ROADMAP C9)
CASES = {"float32": dict(freeze_pretrained=False),
         "bfloat16": dict(freeze_pretrained=True, use_boundary_refinement=False)}
# the first link of the JAX chain keeps the step's raw gradients in its
# state, so one compiled make_train_step gives them too
RECORD = optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                      lambda grads, state, params=None: (grads, grads))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(jmodel, seed=2):
    v = fast_init(jmodel, jnp.zeros((1, *IMG, 3)), jnp.zeros((1, 5)), train=False, seed=seed)
    rng = np.random.default_rng(seed + 10)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        owner = str(getattr(path[-2], "key", path[-2]))
        if path[0].key == "params" and name in ("scale", "bias") and owner != "output_conv":
            return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(perturb, v))


def _batch(seed=5):
    b = next(synthetic_batches(2, 2, IMG, MASK, seed=seed))
    b["valid"][1, 1] = 0.0
    return b


def _loss_cfg(cfg_mod):
    cfg = cfg_mod.ConfigManager.get_config(LOSS_CONFIG)
    cfg.model.mask_size = MASK
    return cfg_mod.loss_config_from_experiment(cfg)


def _tx(opt_mod):
    return opt_mod.build_optimizer(opt_mod.build_schedule(LR, 1, 100, "cosine", 1e-6, 0),
                                   "adamw", 1e-4, 5.0)


def _stats(model):
    mods = running_stat_modules(model)
    return {f"{name}.{b}": getattr(m, b).clone()
            for name, m in model.named_modules() if m in mods
            for b in ("running_mean", "running_var")}


def _port(variables, **kw):
    pm = pasm.HierarchicalInstanceSegmenter(**dict(TINY, **kw), pallas_roi_align=False)
    load_jax_params(pm, variables)
    for m in pm.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return pm


def _jax_step(jm, variables, compute):
    """One JAX ``make_train_step`` from ``variables``: its loss, and the
    parameters, ``batch_stats`` and raw gradients after it, by the port's
    names. ``compute`` "float64" runs it on float64 copies of the variables
    and of the batch's images and boxes."""
    tx = optax.chain(RECORD, _tx(joptim))
    batch = _batch()
    with jax.enable_x64(compute == "float64"):
        if compute == "float64":
            variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
            batch = dict(batch, images=batch["images"].astype(np.float64),
                         boxes=batch["boxes"].astype(np.float64))
        step = jsteps.make_train_step(jm, tx, _loss_cfg(jcfg), donate=False,
                                      compute_dtype=None if compute == "float64" else compute)
        state, metrics = step(JTrainState.create(variables, tx, jax.random.PRNGKey(1)), batch)
        state = jax.tree.map(np.asarray, state)
        return {"loss": float(metrics["total_loss"]),
                "params": from_jax_params({"params": state.params}),
                "stats": from_jax_params({"batch_stats": state.batch_stats}),
                "grads": from_jax_params({"params": state.opt_state[0]})}


@pytest.fixture(scope="module")
def ref():
    """For each case: the float32 JAX variables, and JAX's float64 step of
    its model; for "bfloat16", JAX's bf16 step too."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        mp.setattr(jheads, "Dropout2d", lambda rate, name=None: (lambda x, train=False: x))
        for case, kw in CASES.items():
            jm = jasm.HierarchicalInstanceSegmenter(**dict(TINY, **kw))
            v = _variables(jm)
            out[case] = {"variables": v, "float64": _jax_step(jm, v, "float64")}
            if case == "bfloat16":
                out[case]["bfloat16"] = _jax_step(jm, v, "bfloat16")
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(ref, case):
    """Every parameter's gradient of one step's loss, the port's autograd
    through ``make_loss_fn`` on the model in float64 against the gradients
    JAX's float64 ``make_train_step`` computed: the batch statistics'
    gradients in BatchNorm's train mode (stage 1's and the heads'), the
    attention module, the boundary refinement (away from ties) or the
    guided head; a frozen stage 1 has none here and zeros in JAX."""
    want = ref[case]["float64"]["grads"]
    pm = _port(ref[case]["variables"], **CASES[case]).double()
    pm.train()
    loss, _ = psteps.make_loss_fn(pm, _loss_cfg(pcfg))(
        HierarchicalLossState.create(), torch.Generator().manual_seed(0),
        psteps.batch_to(_batch(), "cpu"))
    np.testing.assert_allclose(float(loss.detach()), ref[case]["float64"]["loss"], rtol=1e-10)
    named = list(pm.named_parameters())
    found = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    assert {n for n, _ in named} == set(want)
    frozen = CASES[case]["freeze_pretrained"]
    for (name, _), g in zip(named, found):
        w = want[name].numpy()
        if name.startswith(("pretrained_unet.", "unet_wrapper.")):
            assert (g is None) == frozen, name
        if g is None:
            assert not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6, err_msg=name)
    parts = ("rgb_extractor.", "head.") + (() if frozen else ("pretrained_unet.",))
    for part in parts:  # no branch left without a gradient
        assert max(float(g.abs().max()) for (n, _), g in zip(named, found)
                   if n.startswith(part) and g is not None) > 1e-3, part


@pytest.mark.parametrize("dtype", sorted(CASES))
def test_train_step_with_batch_stats_matches_jax(ref, dtype):
    """One ``make_train_step`` from the same variables in ``dtype``: the
    loss, the parameters and the running statistics after it (JAX's
    ``batch_stats`` through ``mutable=["batch_stats"]``), against JAX's
    float64 step for float32 and its bf16 step for bf16."""
    r = ref[dtype]["float64" if dtype == "float32" else "bfloat16"]
    pm = _port(ref[dtype]["variables"], **CASES[dtype])
    before = _stats(pm)
    out_dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: out_dtypes.add(o.dtype))
             for m in pm.modules() if isinstance(m, nn.Conv2d)]
    state = TrainState.create(pm, _tx(poptim), seed=1)
    state, metrics = psteps.make_train_step(
        pm, _loss_cfg(pcfg), compute_dtype=None if dtype == "float32" else dtype)(state, _batch())
    for h in hooks:
        h.remove()
    assert state.skipped == 0
    assert out_dtypes == {getattr(torch, dtype)}
    if dtype == "float32":
        np.testing.assert_allclose(float(metrics["total_loss"]), r["loss"], rtol=1e-4, atol=1e-6)
        for name, p in pm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), r["params"][name].numpy(), rtol=0,
                                       atol=3 * LR, err_msg=name)
    else:
        np.testing.assert_allclose(float(metrics["total_loss"]), r["loss"], rtol=1e-3)
    got = _stats(pm)
    assert set(got) == set(r["stats"])
    assert any(k.startswith("pretrained_unet.") for k in got)
    assert any(k.startswith("head.") for k in got)
    frozen = CASES[dtype]["freeze_pretrained"]
    for k, want in r["stats"].items():
        trained = not (frozen and k.startswith("pretrained_unet."))
        if trained:
            assert not torch.equal(got[k], before[k]), k  # the step moved it
        if not trained:  # a bf16 step's frozen statistics: bf16(running), bit for bit
            assert torch.equal(got[k], want), k
            assert torch.equal(got[k], before[k].bfloat16().float()), k
        elif dtype == "float32":
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=2e-2, atol=1e-2,
                                       err_msg=k)


def test_frozen_float32_step_leaves_stage1_stats(ref):
    """A float32 step of a model with a frozen stage 1 leaves its statistics
    bitwise as they were (eval mode; JAX returns them unchanged)."""
    pm = _port(ref["bfloat16"]["variables"], **CASES["bfloat16"])
    before = _stats(pm)
    state = TrainState.create(pm, _tx(poptim), seed=1)
    psteps.make_train_step(pm, _loss_cfg(pcfg))(state, _batch())
    for k, v in _stats(pm).items():
        assert torch.equal(v, before[k]) == k.startswith("pretrained_unet."), k


def test_bf16_rounding_of_frozen_stats_happens_once(ref):
    """The frozen statistics a bf16 step rounds stay ``bf16(running)``; a
    later step, finding them unchanged, does not round them again (no
    entries, no kernels), and a write in between makes it round anew."""
    pm = _port(ref["bfloat16"]["variables"], **CASES["bfloat16"])
    before = _stats(pm)
    state = TrainState.create(pm, _tx(poptim), seed=1)
    step = psteps.make_train_step(pm, _loss_cfg(pcfg), compute_dtype="bfloat16")
    state, _ = step(state, _batch())
    frozen = running_stat_modules(pm.pretrained_unet)
    assert psteps.new_running_stats(pm.pretrained_unet, {}, "bfloat16") == []
    state, _ = step(state, _batch(seed=6))
    assert state.skipped == 0
    for k, v in _stats(pm).items():
        if k.startswith("pretrained_unet."):
            assert torch.equal(v, before[k].bfloat16().float()), k
    with torch.no_grad():
        frozen[0].running_mean.add_(1e-3)
    again = psteps.new_running_stats(pm.pretrained_unet, {}, "bfloat16")
    assert [b for b, _, _ in again] == [frozen[0].running_mean]


def test_nan_step_keeps_running_stats(ref):
    """A step the NaN guard skips leaves the running statistics (and the
    parameters) as they were, as JAX's ``sel`` does."""
    pm = _port(ref["float32"]["variables"], freeze_pretrained=False)
    state = TrainState.create(pm, _tx(poptim), seed=1)
    step = psteps.make_train_step(pm, _loss_cfg(pcfg))
    state, _ = step(state, _batch())
    stats = _stats(pm)
    params = {n: p.detach().clone() for n, p in pm.named_parameters()}
    bad = _batch(seed=6)
    bad["images"][0, 5, 5, 0] = np.nan
    state, _ = step(state, bad)
    assert state.skipped == 1 and state.step == 2
    for k, v in _stats(pm).items():
        assert torch.equal(v, stats[k]), k
    for n, p in pm.named_parameters():
        assert torch.equal(p.detach(), params[n]), n


def test_checkpoint_carries_running_stats(ref, tmp_path):
    """The statistics a step moved are in the checkpoint (buffers of the
    state_dict) and come back equal in a fresh model."""
    pm = _port(ref["float32"]["variables"], freeze_pretrained=False)
    state = TrainState.create(pm, _tx(poptim), seed=1)
    state, _ = psteps.make_train_step(pm, _loss_cfg(pcfg))(state, _batch())
    save_checkpoint(str(tmp_path), state, 1)
    moved = _stats(pm)
    fresh = _port(ref["float32"]["variables"], freeze_pretrained=False)
    assert any(not torch.equal(v, _stats(fresh)[k]) for k, v in moved.items())
    _, step = restore_checkpoint(str(tmp_path), TrainState.create(fresh, _tx(poptim)))
    assert step == 1
    for k, v in _stats(fresh).items():
        assert torch.equal(v, moved[k]), k


def test_served_caches_follow_trained_statistics(ref):
    """The fused stage-1 blocks and the fused tail fold the running
    statistics and keep the folded weights until a parameter or a buffer
    changes: after an unfrozen train step has moved the statistics, the
    served model with ``encoder_fused_blocks`` and ``pallas_tail`` (their
    plain versions on the CPU) equals the plain served model."""
    v = ref["float32"]["variables"]
    fused = _port(v, freeze_pretrained=False, pallas_tail=True, encoder_fused_blocks=3)
    plain = _port(v, freeze_pretrained=False)
    images = torch.from_numpy(_batch()["images"])
    with torch.no_grad():
        before = fused.eval().stage1(images)  # folds and keeps the weights
    state = TrainState.create(fused, _tx(poptim))
    psteps.make_train_step(fused, _loss_cfg(pcfg))(state, _batch())
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        after = fused.eval().stage1(images)
        np.testing.assert_allclose(after.numpy(), plain.eval().stage1(images).numpy(),
                                   atol=1e-5)
    assert float((after - before).abs().max()) > 1e-4
