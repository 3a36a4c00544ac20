"""The port's data parallelism (``parallel/``, the ``mesh=`` forms of the
train, eval and KD steps, ``InferenceEngine(mesh=)``) against the JAX
package's mesh of 2 on the conftest's virtual CPU devices.

The port runs two ranks over Gloo on the CPU (``parallel.launch.spawn``),
each rank fed its ``shard_batch`` slice; the ranks' results come back to
the test, which holds them against JAX. The models are the tiny flagship
of ``tests/test_parallel.py`` (32 x 32 images, mid 16), its variables from
``helpers.fast_init`` carried across by ``weights.load_jax_params``, and
the tiny UNets of the binary KD step.

Training is compared in float64 on both sides (the port's modules
``.double()``, JAX under ``jax.enable_x64``), so that the comparison holds
the averaging itself and not float32 summation noise. The train steps keep
stage 1 frozen, as ``tests/test_parallel.py`` does: with stage 1 training
its BatchNorms over a 2-image shard at 1 x 1 maps, the gradient is so
ill-conditioned that the float32 islands both packages keep in float64 runs
(LayerNorm statistics) grow from 1e-8 after one step to 1e-5 after three,
on one device as on two. The binary KD step trains its student's
BatchNorms for one step, where both agree to 1e-8, and holds the averaged
running statistics. The optimizer is SGD with momentum 0.9 at a constant
learning rate on both sides, whose update is linear in the gradient.
Dropout is neutralised on both sides (the JAX head's ``Dropout2d`` patched
to the identity inside the reference fixture, the port's at ``p = 0``).

Tolerances: three DP train steps' losses, parameters, running statistics
and loss state within rtol 1e-4 / atol 1e-6 of JAX's (the training
tolerance of ``test_torch_training.py``); the same for one step of each KD
step; the loss and every parameter bit-identical across the two ranks; the
eval sums within rtol 1e-6 / atol 1e-6; mesh serving, of the flagship and
of a family without its stage-1 split, within atol 1e-5 of the
single-device engine (ROADMAP C2's tolerance, stated and checked).
Every spawn is killed after :data:`SPAWN_TIMEOUT` seconds.
"""

import logging

import numpy as np
import pytest
import torch

TINY = dict(encoder_variant="tiny", roi_size=(8, 8), mask_size=(16, 16), image_size=(32, 32),
            base_channels=8, depth=2, mid_channels=16, feature_dim=16,
            unet_decoder_channels=(16, 16, 8, 8, 8))
TEACHER_MID = 24  # the hierarchical KD teacher's head width
UNET_DECODER = (32, 24, 16, 16, 8)
UNET_IMG = (64, 64)
LR = 1e-2
STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-6)
SERVE_ATOL = 1e-5
SPAWN_TIMEOUT = 240
KD = dict(temperature=3.0, alpha=0.6, aux_weight=0.3)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    boxes = np.tile(np.asarray([[0.2, 0.2, 0.8, 0.8], [0.1, 0.15, 0.6, 0.9]], np.float32),
                    (4, 1, 1)) + rng.uniform(-0.05, 0.05, (4, 2, 4)).astype(np.float32)
    valid = np.ones((4, 2), np.float32)
    valid[3, 1] = 0.0  # one padded ROI, on the second shard
    return {"images": rng.random((4, 32, 32, 3), np.float32), "boxes": boxes,
            "masks": rng.integers(0, 3, (4, 2, 16, 16)).astype(np.int32), "valid": valid}


def _binary_batch(seed=1):
    rng = np.random.default_rng(seed)
    masks = np.zeros((4, *UNET_IMG, 1), np.float32)
    for b in range(4):
        y, x = rng.integers(0, 32, 2)
        masks[b, y:y + 32, x:x + 32] = 1.0
    return {"images": rng.random((4, *UNET_IMG, 3), np.float32), "masks": masks}


def _f64(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


# ---------------------------------------------------------------------------
# the port's ranks (module-level: pickled by name into the spawned processes)
# ---------------------------------------------------------------------------


def _port_tiny(variables, dtype=torch.float64, **kw):
    from human_instance_segmentation_tpu_torch.models.assembly import (
        HierarchicalInstanceSegmenter)
    from human_instance_segmentation_tpu_torch.models.blocks import Dropout2d
    from human_instance_segmentation_tpu_torch.weights import load_jax_params

    model = HierarchicalInstanceSegmenter(**{**TINY, **kw})
    load_jax_params(model, variables)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return model.to(dtype)


def _snapshot(state) -> dict:
    return {"params": {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()},
            "buffers": {n: b.detach().numpy().copy() for n, b in state.model.named_buffers()
                        if b.is_floating_point()},
            "loss_state": {k: float(v) for k, v in state.loss_state.state_dict().items()}}


def _sgd():
    from human_instance_segmentation_tpu_torch.training.optim import Transform, constant_schedule

    return Transform("sgd", constant_schedule(LR))


def _rank_training(rank, refs):
    """Three DP train steps, the mesh eval step, one step of each KD step,
    all in float64; every result as numpy."""
    from human_instance_segmentation_tpu_torch.losses import distillation as pdl
    from human_instance_segmentation_tpu_torch.losses.hierarchical import RefinedLossConfig
    from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet
    from human_instance_segmentation_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from human_instance_segmentation_tpu_torch.training import distill as pdist
    from human_instance_segmentation_tpu_torch.training import steps as psteps
    from human_instance_segmentation_tpu_torch.training.state import TrainState
    from human_instance_segmentation_tpu_torch.weights import load_jax_params

    mesh = create_mesh(2, device="cpu")
    out = {}
    batch = dict(_batch(), images=_batch()["images"].astype(np.float64),
                 boxes=_batch()["boxes"].astype(np.float64))
    local = shard_batch(mesh, batch)

    model = _port_tiny(refs["train_vars"])
    out["eval"] = {k: float(v) for k, v in psteps.make_eval_step(model, mesh)(local).items()}
    out["eval_local_acc"] = float(psteps.make_eval_step(model)(local)["acc"])
    state = TrainState.create(model, _sgd(), seed=1)
    step = psteps.make_train_step(model, RefinedLossConfig(), mesh=mesh)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, local)
        losses.append(float(metrics["total_loss"]))
    out["train"] = {"losses": losses, **_snapshot(state),
                    "metrics": {k: float(v) for k, v in metrics.items()}}

    student = PeopleSegmentationUNet("tiny", decoder_channels=UNET_DECODER)
    teacher = PeopleSegmentationUNet("tiny", decoder_channels=UNET_DECODER)
    load_jax_params(student, refs["student_vars"])
    load_jax_params(teacher, refs["teacher_vars"])
    student, teacher = student.double(), teacher.double().eval()
    bb = _binary_batch()
    state = TrainState.create(student, _sgd(), seed=1,
                              distill_state=pdl.DistillationState.create(4.0, 0.5, 0.3))
    state, metrics = pdist.make_distill_train_step(student, teacher, mesh=mesh)(
        state, shard_batch(mesh, dict(bb, images=bb["images"].astype(np.float64))))
    out["binary_kd"] = {"loss": float(metrics["total_loss"]), **_snapshot(state),
                        "metrics": {k: float(v) for k, v in metrics.items()}}

    student = _port_tiny(refs["train_vars"])
    teacher = _port_tiny(refs["kd_teacher_vars"], mid_channels=TEACHER_MID)
    state = TrainState.create(student, _sgd(), seed=1)
    state, metrics = pdist.make_hierarchical_distill_step(
        student, teacher, RefinedLossConfig(), mesh=mesh, **KD)(state, local)
    out["hier_kd"] = {"loss": float(metrics["total_loss"]), **_snapshot(state),
                      "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _rank_serving(rank, variables):
    """The mesh engine and ROI-sharded inference against the single-device
    engine, float32, with the engine's warnings recorded per request."""
    from human_instance_segmentation_tpu_torch.inference import (InferenceEngine,
                                                                 deployed_outputs, init_weights,
                                                                 pad_rois)
    from human_instance_segmentation_tpu_torch.models.assembly import (
        MultiScaleRGBHierarchicalModel)
    from human_instance_segmentation_tpu_torch.parallel.mesh import create_mesh
    from human_instance_segmentation_tpu_torch.parallel.roi_sharding import (
        make_roi_sharded_infer, shard_rois)

    mesh = create_mesh(2, device="cpu")
    model = _port_tiny(variables, dtype=torch.float32).eval()
    rng = np.random.default_rng(1)
    images = rng.random((8, 32, 32, 3), np.float32)
    box = np.asarray([[0.1, 0.15, 0.85, 0.9]], np.float32)
    requests = {
        "sharded": (images, np.concatenate([np.repeat(np.arange(8, dtype=np.float32), 2)[:, None],
                                            np.tile(box, (16, 1))], axis=1)),
        "replicated": (images[:3], np.concatenate([np.asarray([[2.0]], np.float32), box],
                                                  axis=1)),
        # 1 roi -> bucket 1, which 2 ranks do not divide; the batch of 8 shards
        "mixed": (images, np.concatenate([np.asarray([[3.0]], np.float32), box], axis=1)),
    }
    single = InferenceEngine(model, dilation_pixels=1, device="cpu")
    sharded = InferenceEngine(model, dilation_pixels=1, device="cpu", mesh=mesh)
    log = logging.getLogger("human_instance_segmentation_tpu_torch.inference")
    out = {}
    for name, (img, rois) in requests.items():
        handler = _Records()
        log.addHandler(handler)
        try:
            inst_m, bin_m = sharded(img, rois)
        finally:
            log.removeHandler(handler)
        inst_1, bin_1 = single(img, rois)
        out[name] = {"inst_m": inst_m, "bin_m": bin_m, "inst_1": inst_1, "bin_1": bin_1,
                     "warnings": handler.messages}

    # a family without the flagship's stage-1 split: the batch replicated,
    # the ROI bucket of 16 sharded
    other = MultiScaleRGBHierarchicalModel((16, 8), mask_size=(16, 16), image_size=(32, 32),
                                           feature_dim=16)
    init_weights(other, 0)
    handler = _Records()
    log.addHandler(handler)
    try:
        inst_m, bin_m = InferenceEngine(other, dilation_pixels=1, device="cpu", mesh=mesh)(
            *requests["sharded"])
    finally:
        log.removeHandler(handler)
    inst_1, bin_1 = InferenceEngine(other, dilation_pixels=1, device="cpu")(*requests["sharded"])
    out["other_family"] = {"inst_m": inst_m, "bin_m": bin_m, "inst_1": inst_1, "bin_1": bin_1,
                           "warnings": handler.messages}

    rois = requests["sharded"][1][:5]  # images 0, 0, 1, 1, 2
    infer = make_roi_sharded_infer(model, mesh, dilation_pixels=1)
    local, n = shard_rois(mesh, rois)
    inst_s, bin_s = infer(torch.as_tensor(images[:3]), local)
    padded = torch.as_tensor(pad_rois(rois, inst_s.shape[0]))
    with torch.no_grad():
        logits, aux = model(torch.as_tensor(images[:3]), padded)
        inst_r, bin_r = deployed_outputs(logits, aux, padded, 1)
    out["roi_sharded"] = {"n": n, "local": local.shape[0], "inst_s": inst_s.numpy(),
                          "bin_s": bin_s.numpy(), "inst_r": inst_r.numpy(),
                          "bin_r": bin_r.numpy()}
    return out


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """JAX's mesh-of-2 results of the same steps, in float64."""
    import jax
    import jax.numpy as jnp
    import optax

    from helpers import fast_init
    from human_instance_segmentation_tpu.losses import distillation as jdl
    from human_instance_segmentation_tpu.losses.hierarchical import RefinedLossConfig
    from human_instance_segmentation_tpu.models import heads as jheads
    from human_instance_segmentation_tpu.models.assembly import HierarchicalInstanceSegmenter
    from human_instance_segmentation_tpu.models.unet import PeopleSegmentationUNet as JUNet
    from human_instance_segmentation_tpu.parallel.mesh import create_mesh, replicate, shard_batch
    from human_instance_segmentation_tpu.training import distill as jdist
    from human_instance_segmentation_tpu.training import steps as jsteps
    from human_instance_segmentation_tpu.training.state import TrainState as JTrainState
    from human_instance_segmentation_tpu_torch.weights import from_jax_params

    def variables(model, *args, seed):
        return jax.tree.map(np.asarray, fast_init(model, *args, train=False, seed=seed))

    model = HierarchicalInstanceSegmenter(**TINY)
    teacher = HierarchicalInstanceSegmenter(**{**TINY, "mid_channels": TEACHER_MID})
    args = (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 5)))
    js = JUNet(encoder_variant="tiny", decoder_channels=UNET_DECODER)
    jt = JUNet(encoder_variant="tiny", decoder_channels=UNET_DECODER)
    out = {"train_vars": variables(model, *args, seed=3),
           "kd_teacher_vars": variables(teacher, *args, seed=9),
           "student_vars": variables(js, jnp.zeros((1, *UNET_IMG, 3)), seed=5),
           "teacher_vars": variables(jt, jnp.zeros((1, *UNET_IMG, 3)), seed=8)}

    def snapshot(state):
        state = jax.tree.map(np.asarray, state)
        got = {"params": from_jax_params({"params": state.params})}
        got["buffers"] = from_jax_params({"batch_stats": state.batch_stats}) \
            if state.batch_stats else {}
        if state.loss_state is not None:
            got["loss_state"] = {k: float(getattr(state.loss_state, k))
                                 for k in ("ema_bg", "ema_fg", "ema_target", "ema_nontarget",
                                           "initialized")}
        return got

    def start(vars64, **kw):
        st = JTrainState.create(vars64, tx, jax.random.PRNGKey(1), **kw)
        # the mesh step returns its pmean'd loss state as float64 and its
        # flag as float32; start from those types so that one program serves
        # every step
        ls = st.loss_state
        st = st.replace(loss_state=ls.replace(
            **{k: jnp.asarray(getattr(ls, k), jnp.float64)
               for k in ("ema_bg", "ema_fg", "ema_target", "ema_nontarget")},
            initialized=jnp.asarray(ls.initialized, jnp.float32)))
        return replicate(mesh, st)

    batch = _batch()
    mesh = create_mesh(2)
    tx = optax.sgd(LR, momentum=0.9)
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"), \
            jax.enable_x64(True):
        mp.setattr(jheads, "Dropout2d", lambda rate, name=None: (lambda x, train=False: x))
        b64 = shard_batch(mesh, dict(batch, images=batch["images"].astype(np.float64),
                                     boxes=batch["boxes"].astype(np.float64)))
        v64 = _f64(out["train_vars"])
        evals = jsteps.make_eval_step(model, mesh=mesh)((v64["params"], v64["batch_stats"]), b64)
        out["eval"] = {k: float(v) for k, v in evals.items()}
        whole = jsteps.make_eval_step(model)((v64["params"], v64["batch_stats"]),
                                             jax.device_get(b64))
        out["eval_single_acc"] = float(whole["acc"])

        step = jsteps.make_train_step(model, tx, RefinedLossConfig(), mesh=mesh, donate=False)
        state, losses = start(v64), []
        for _ in range(STEPS):
            state, metrics = step(state, b64)
            losses.append(float(metrics["total_loss"]))
        out["train"] = {"losses": losses, **snapshot(state),
                        "metrics": {k: float(v) for k, v in metrics.items()}}

        bb = _binary_batch()
        kd_state = start(_f64(out["student_vars"]),
                         distill_state=jdl.DistillationState.create(4.0, 0.5, 0.3))
        kd_step = jdist.make_distill_train_step(js, jt, _f64(out["teacher_vars"]), tx,
                                                jdl.DistillationConfig(), mesh=mesh)
        state, metrics = kd_step(kd_state, shard_batch(
            mesh, dict(bb, images=bb["images"].astype(np.float64))))
        out["binary_kd"] = {"loss": float(metrics["total_loss"]), **snapshot(state),
                            "metrics": {k: float(v) for k, v in metrics.items()}}

        student = HierarchicalInstanceSegmenter(**TINY)
        hier = jdist.make_hierarchical_distill_step(
            student, teacher, _f64(out["kd_teacher_vars"]), tx, RefinedLossConfig(), mesh=mesh,
            **KD)
        state, metrics = hier(start(v64), b64)
        out["hier_kd"] = {"loss": float(metrics["total_loss"]), **snapshot(state),
                          "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


@pytest.fixture(scope="module")
def port(ref):
    from human_instance_segmentation_tpu_torch.parallel.launch import spawn

    refs = {k: ref[k] for k in ("train_vars", "kd_teacher_vars", "student_vars", "teacher_vars")}
    return spawn(_rank_training, 2, (refs,), timeout=SPAWN_TIMEOUT)


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=err_msg, **tol)


def _same_across_ranks(port, key):
    a, b = port[0][key], port[1][key]
    for group in ("params", "buffers"):
        for name in a[group]:
            assert np.array_equal(a[group][name], b[group][name]), (key, name)
    assert a["loss_state"] == b["loss_state"]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_init_distributed_single_host():
    """Without a process count (or with a count of 1) nothing starts and the
    local device count comes back: 1 on the CPU (JAX: its device count);
    the default device, the card, raises where there is no CUDA."""
    import torch.distributed as dist

    from human_instance_segmentation_tpu_torch.parallel.mesh import init_distributed

    assert init_distributed(device="cpu") == 1
    assert init_distributed(num_processes=1, device="cpu") == 1
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_distributed()


def test_create_mesh_raises_past_the_world_size():
    from human_instance_segmentation_tpu_torch.parallel.mesh import (batch_spec, create_mesh,
                                                                     replicated_spec)

    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        create_mesh(2)
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh()
    assert str(batch_spec()[0]) == "S(0)" and str(replicated_spec()[0]) == "R"


def test_dp_train_steps_match_jax_mesh(ref, port):
    """Three DP train steps on two Gloo ranks against JAX's mesh of 2: each
    step's loss, the parameters (the head's moved, the frozen stage 1's
    not), the running statistics (frozen: kept, as JAX's pmean of equal
    values keeps them) and the loss state after; the last step's metrics;
    the ranks bit-identical to each other."""
    from human_instance_segmentation_tpu_torch.weights import from_jax_params

    want = ref["train"]
    _same_across_ranks(port, "train")
    got = port[0]["train"]
    assert got["losses"] == port[1]["train"]["losses"]
    _close(got["losses"], want["losses"], "losses", **TOL)
    assert set(got["params"]) == set(want["params"])
    for name, p in got["params"].items():
        _close(p, want["params"][name].numpy(), name, **TOL)
    start = from_jax_params(ref["train_vars"])
    moved = [n for n, p in got["params"].items() if not np.allclose(p, start[n].numpy())]
    assert len(moved) > 10 and not any(n.startswith("pretrained_unet.") for n in moved)
    stats = {n: v for n, v in got["buffers"].items() if n.endswith(("running_mean", "running_var"))}
    assert stats and set(stats) == set(want["buffers"])
    for name, v in stats.items():
        _close(v, want["buffers"][name].numpy(), name, **TOL)
    for k, v in want["loss_state"].items():
        _close(got["loss_state"][k], v, k, **TOL)
    for k, v in want["metrics"].items():
        _close(got["metrics"][k], v, k, **TOL)


def test_dp_eval_step_matches_jax_mesh(ref, port):
    """The mesh eval step's ``iou_sum``, ``det50_sum``, ``det70_sum`` and
    ``n`` equal JAX's. ``acc`` (C16): the port's is the global pixel
    accuracy, JAX's one-device ``acc`` of the whole batch; JAX's mesh
    ``acc`` is the sum of the shards' accuracies, which the port's ranks'
    one-device accuracies add up to."""
    got, want = port[0]["eval"], ref["eval"]
    assert got == port[1]["eval"]
    for k in ("iou_sum", "det50_sum", "det70_sum", "n"):
        _close(got[k], want[k], k, rtol=1e-6, atol=1e-6)
    _close(got["acc"], ref["eval_single_acc"], "acc", rtol=1e-6, atol=1e-6)
    shard_sum = port[0]["eval_local_acc"] + port[1]["eval_local_acc"]
    _close(shard_sum, want["acc"], "JAX's mesh acc", rtol=1e-6, atol=1e-6)
    # a sum of two accuracies is not the batch's accuracy
    assert not np.isclose(want["acc"], got["acc"], rtol=0.1)


@pytest.mark.parametrize("key", ["binary_kd", "hier_kd"])
def test_dp_kd_steps_match_jax_mesh(ref, port, key):
    """One step of the binary KD step (the student's BatchNorms train) and
    of the hierarchical KD step (stage 1 frozen, the teacher at mid 24) on
    two ranks against JAX's mesh of 2: loss, metrics, parameters and
    running statistics; the ranks bit-identical."""
    from human_instance_segmentation_tpu_torch.weights import from_jax_params

    want = ref[key]
    _same_across_ranks(port, key)
    got = port[0][key]
    _close(got["loss"], want["loss"], "loss", **TOL)
    for k, v in want["metrics"].items():
        _close(got["metrics"][k], v, k, **TOL)
    for name, p in got["params"].items():
        _close(p, want["params"][name].numpy(), name, **TOL)
    for name, v in want["buffers"].items():
        _close(got["buffers"][name], v.numpy(), name, **TOL)
    if key == "binary_kd":  # the averaged statistics of the student's BatchNorms moved
        start = from_jax_params(ref["student_vars"])
        assert sum(not np.allclose(v.numpy(), start[n].numpy())
                   for n, v in want["buffers"].items()) > 10


@pytest.fixture(scope="module")
def serving(ref):
    """Both ranks' serving results, the tiny flagship (stage 1 frozen: the
    same variables) in float32."""
    from human_instance_segmentation_tpu_torch.parallel.launch import spawn

    return spawn(_rank_serving, 2, (ref["train_vars"],), timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("case", ["sharded", "replicated", "mixed"])
def test_engine_mesh_matches_single_device(serving, case):
    """``InferenceEngine(mesh=)`` on two ranks against the single-device
    engine within atol 1e-5: batch 8 x 16 ROIs (both axes shard), 3 images
    x 1 ROI (neither divides: both logged REPLICATED), and JAX's mixed case, 8
    images x 1 ROI, where the batch still shards and only the ROI bucket is
    logged (no ``batch=`` warning). Both ranks return the full outputs."""
    for rank in (0, 1):
        r = serving[rank][case]
        np.testing.assert_allclose(r["inst_m"], r["inst_1"], atol=SERVE_ATOL)
        np.testing.assert_allclose(r["bin_m"], r["bin_1"], atol=SERVE_ATOL)
        assert r["inst_m"].shape == r["inst_1"].shape
        warned = r["warnings"]
        if case == "sharded":
            assert warned == []
        elif case == "replicated":
            assert any("batch=3" in m and "REPLICATED" in m for m in warned), warned
            assert any("roi bucket=1" in m for m in warned), warned
        else:
            assert any("REPLICATED" in m and "roi bucket" in m for m in warned), warned
            assert not any("batch=" in m for m in warned), warned
    assert np.array_equal(serving[0][case]["inst_m"], serving[1][case]["inst_m"])


def test_engine_mesh_serves_other_family(serving):
    """A family without the flagship's stage-1 split (the multi-scale RGB
    model) on two ranks: every rank runs the whole batch, the bucket of 16
    ROIs shards, the engine logs that the batch serves REPLICATED, and the
    instance masks equal the single-device engine's within atol 1e-5 (no
    binary mask from this family)."""
    for rank in (0, 1):
        r = serving[rank]["other_family"]
        assert r["bin_m"] is None and r["bin_1"] is None
        assert r["inst_m"].shape == r["inst_1"].shape == (16, 16, 16, 1)
        np.testing.assert_allclose(r["inst_m"], r["inst_1"], atol=SERVE_ATOL)
        assert any("MultiScaleRGBHierarchicalModel has no stage-1 split" in m
                   and "REPLICATED" in m for m in r["warnings"]), r["warnings"]
        assert not any("roi bucket" in m for m in r["warnings"]), r["warnings"]
    assert serving[0]["other_family"]["inst_1"].any()
    assert np.array_equal(serving[0]["other_family"]["inst_m"],
                          serving[1]["other_family"]["inst_m"])


def test_roi_sharded_infer_matches_one_device(serving):
    """``make_roi_sharded_infer``: 5 ROIs padded to 6 by ``shard_rois`` (3 a
    rank); every rank gets all 6 instance masks and the binary masks, equal
    to one device's ``deployed_outputs`` on the padded ROIs within atol
    1e-5."""
    for rank in (0, 1):
        r = serving[rank]["roi_sharded"]
        assert r["n"] == 5 and r["local"] == 3 and r["inst_s"].shape[0] == 6
        np.testing.assert_allclose(r["inst_s"], r["inst_r"], atol=SERVE_ATOL)
        np.testing.assert_allclose(r["bin_s"], r["bin_r"], atol=SERVE_ATOL)
        assert not r["inst_s"][5:].any()  # the sentinel ROI's mask is zeroed
