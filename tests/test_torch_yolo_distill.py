"""The YOLO-feature path of the port against the JAX package (CPU, inputs
from a numpy seed): the feature-file contract (``data/yolo_features``), the
batch sources, the student with its projector, ``strip_projector``, one
YOLO distillation step and tiny runs of ``run_yolo_feature_distillation``.

The step is held against JAX's (the step of JAX's
``run_yolo_feature_distillation``, rebuilt here from its parts: the teacher
in eval mode, the student in train mode with ``mutable=["batch_stats"]``,
``yolo_distillation_loss``, and the ``multi_transform`` of a frozen encoder
and clip 1.0 + AdamW) in float64 on both sides: BatchNorm in train mode over
two 64 x 64 images leaves a handful of pixels a channel at the deep stages,
so a float32 BatchNorm gradient is ill-conditioned (as in
``test_torch_batch_stats.py``). Tolerances: loss terms, gradients,
parameters and statistics after the step within rtol 1e-4 / atol 1e-6;
forwards in float32 within rtol 1e-4 / atol 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.data import yolo_features as jyf
from human_instance_segmentation_tpu.losses.distillation import (
    yolo_distillation_loss as j_yolo_loss)
from human_instance_segmentation_tpu.models import multiscale as jms
from human_instance_segmentation_tpu.models import unet as junet
from human_instance_segmentation_tpu.models import yolo_distill as jyd
from human_instance_segmentation_tpu.training import yolo_distill as jtrain
from human_instance_segmentation_tpu_torch import data as pdata
from human_instance_segmentation_tpu_torch.data import yolo_features as pyf
from human_instance_segmentation_tpu_torch.inference import init_weights
from human_instance_segmentation_tpu_torch.models import multiscale as pms
from human_instance_segmentation_tpu_torch.models import yolo_distill as pyd
from human_instance_segmentation_tpu_torch.models.unet import PeopleSegmentationUNet
from human_instance_segmentation_tpu_torch.training import yolo_distill as ptrain
from human_instance_segmentation_tpu_torch.training.state import TrainState
from human_instance_segmentation_tpu_torch.training.steps import batch_to
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

DEC = (32, 24, 16, 16, 8)
TINY = dict(encoder_variant="tiny", decoder_channels=DEC, projection_hidden_dim=16,
            yolo_feature_dim=32)
IMG = (64, 64)
LR = 1e-3
T = 2.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_arrays(a: dict, b: dict):
    """Equal keys in the same order, and each array's dtype, shape and
    bytes."""
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_tensor_names_match_feature_specs():
    assert pyf.ONNX_TENSOR_NAMES == jyf.ONNX_TENSOR_NAMES
    assert pms.FEATURE_SPECS == jms.FEATURE_SPECS
    assert set(pyf.ONNX_TENSOR_NAMES) == set(pms.FEATURE_SPECS)
    for layer_id, name in pyf.ONNX_TENSOR_NAMES.items():
        assert name == f"segmentation_model_{layer_id.split('_')[1]}_Concat_output_0"
    assert pdata.ONNX_TENSOR_NAMES is pyf.ONNX_TENSOR_NAMES
    for name in ("convert_onnx_feature_dump", "write_golden_fixture", "load_feature_pyramid"):
        assert getattr(pdata, name) is getattr(pyf, name) and name in pdata.__all__


def test_converter_validates_and_transposes(tmp_path):
    """NCHW ONNX outputs -> NHWC ``feat_<layer>`` keys (unrelated outputs
    skipped, ``yolo_features`` aliased), the arrays JAX's converter writes;
    wrong channels, wrong stride, no known tensor, images not NHWC and
    masks of another shape raise, as in JAX."""
    rng = np.random.default_rng(0)
    images = rng.random((2, *IMG, 3), np.float32)
    masks = (rng.random((2, *IMG)) > 0.5).astype(np.float32)
    outputs = {pyf.ONNX_TENSOR_NAMES["layer_34"]: rng.standard_normal((2, 1024, 8, 8)),
               pyf.ONNX_TENSOR_NAMES["layer_3"]: rng.standard_normal((2, 256, 16, 16)),
               "unrelated_output": np.zeros((2, 4))}
    got = pyf.convert_onnx_feature_dump(images, outputs, str(tmp_path / "p" / "d.npz"), masks)
    want = jyf.convert_onnx_feature_dump(images, outputs, str(tmp_path / "j" / "d.npz"), masks)
    _same_arrays(_load(got), _load(want))
    feats, imgs, m = pyf.load_feature_pyramid(got)
    np.testing.assert_array_equal(feats["layer_34"],
                                  np.transpose(outputs[pyf.ONNX_TENSOR_NAMES["layer_34"]],
                                               (0, 2, 3, 1)).astype(np.float32))
    assert m.shape == (2, *IMG, 1)
    np.testing.assert_array_equal(_load(got)["yolo_features"], feats["layer_34"])
    name34 = pyf.ONNX_TENSOR_NAMES["layer_34"]
    bad = [({name34: rng.standard_normal((2, 512, 8, 8))}, "layer_34"),
           ({name34: rng.standard_normal((2, 1024, 16, 16))}, "layer_34"),
           ({"x": np.zeros((2, 4))}, "no known")]
    for out, match in bad:
        for mod in (pyf, jyf):
            with pytest.raises(ValueError, match=match):
                mod.convert_onnx_feature_dump(images, out, str(tmp_path / "bad.npz"))
    for mod in (pyf, jyf):
        with pytest.raises(ValueError, match="NHWC"):
            mod.convert_onnx_feature_dump(images[..., :2], outputs, str(tmp_path / "bad.npz"))
        with pytest.raises(ValueError, match="masks"):
            mod.convert_onnx_feature_dump(images, outputs, str(tmp_path / "bad.npz"),
                                          masks[:, :32])
    with pytest.raises(ValueError, match="unknown layer"):
        pyf.validate_feature_map("layer_99", np.zeros((1, 8, 8, 4)), IMG)


def test_golden_fixture_and_loader_match_jax(tmp_path):
    """``write_golden_fixture`` writes JAX's arrays byte for byte (keys in
    the same order), and ``load_feature_pyramid`` returns JAX's."""
    kw = dict(batch=2, image_hw=(32, 48), layers=("layer_3", "layer_19", "layer_22", "layer_34"),
              seed=4)
    got = pyf.write_golden_fixture(str(tmp_path / "p.npz"), **kw)
    want = jyf.write_golden_fixture(str(tmp_path / "j.npz"), **kw)
    _same_arrays(_load(got), _load(want))
    pf, pi, pm = pyf.load_feature_pyramid(got)
    jf, ji, jm = jyf.load_feature_pyramid(want)
    _same_arrays(pf, jf)
    _same_arrays({"i": pi, "m": pm}, {"i": ji, "m": jm})


def test_synthetic_batches_match_jax():
    p = ptrain.synthetic_yolo_batches(3, (32, 40), yolo_dim=16, seed=7)
    j = jtrain.synthetic_yolo_batches(3, (32, 40), yolo_dim=16, seed=7)
    for _ in range(3):
        _same_arrays(next(p), next(j))


def test_npz_feature_batches_rebatch_like_jax(tmp_path):
    """Files of 3, 2 and 4 samples rebatched to 2 across files and cycled
    (shuffled per pass): the same batches as JAX's for two passes."""
    rng = np.random.default_rng(0)
    for i, nb in enumerate((3, 2, 4)):
        np.savez(tmp_path / f"feat{i}.npz",
                 images=rng.random((nb, 16, 16, 3)).astype(np.float32),
                 masks=(rng.random((nb, 16, 16, 1)) > 0.5).astype(np.float32),
                 yolo_features=rng.standard_normal((nb, 2, 2, 8)).astype(np.float32))
    p = ptrain.npz_feature_batches(str(tmp_path), 2, seed=3)
    j = jtrain.npz_feature_batches(str(tmp_path), 2, seed=3)
    for _ in range(9):
        _same_arrays(next(p), next(j))
    with pytest.raises(FileNotFoundError):
        next(ptrain.npz_feature_batches(str(tmp_path / "none"), 2))


def _student_vars(seed=1):
    jm = jyd.YOLOFeatureDistillStudent(**TINY)
    return jm, jax.tree.map(np.asarray, fast_init(jm, jnp.zeros((1, *IMG, 3)), train=False,
                                                   return_features=True, seed=seed))


def test_student_forward_matches_jax():
    """Logits and the projected stride-8 feature, in eval mode (running
    statistics) and in train mode (batch statistics)."""
    jm, v = _student_vars()
    images = np.random.default_rng(2).random((2, *IMG, 3), np.float32)
    pm = load_jax_params(pyd.YOLOFeatureDistillStudent(**TINY), v)
    for train in (False, True):
        fn = jax.jit(lambda v, x: jm.apply(v, x, train=train, return_features=True,
                                           mutable=["batch_stats"] if train else False))
        with jax.default_matmul_precision("highest"):
            out = fn(v, jnp.asarray(images))
        (logits, proj) = out[0] if train else out
        pm.train(train)
        with torch.no_grad():
            got, got_proj = pm(torch.from_numpy(images).permute(0, 3, 1, 2), return_features=True)
        assert got_proj.shape == (2, 32, 8, 8)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(logits),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_proj.permute(0, 2, 3, 1).numpy(), np.asarray(proj),
                                   rtol=1e-4, atol=1e-5)
        assert torch.equal(pm(torch.zeros(1, 3, *IMG)), pm(torch.zeros(1, 3, *IMG),
                                                           return_features=True)[0])


def test_strip_projector_loads_into_the_deployed_unet():
    """The student's ``state_dict`` without ``proj_*`` loads strictly into a
    ``PeopleSegmentationUNet``, which then computes the student's logits;
    JAX's ``strip_projector`` drops the same leaves."""
    jm, v = _student_vars()
    pm = load_jax_params(pyd.YOLOFeatureDistillStudent(**TINY), v).eval()
    stripped = pyd.strip_projector(pm.state_dict())
    assert {k.split(".")[0] for k in set(pm.state_dict()) - set(stripped)} == {
        "proj_conv0", "proj_bn", "proj_conv1"}
    deploy = PeopleSegmentationUNet("tiny", DEC)
    deploy.load_state_dict(stripped, strict=True)
    assert set(from_jax_params(jyd.strip_projector(v))) == set(stripped)
    x = torch.rand(1, 3, *IMG)
    with torch.no_grad():
        assert torch.equal(deploy.eval()(x), pm(x))


def _batch(seed=5):
    return next(ptrain.synthetic_yolo_batches(2, IMG, yolo_dim=32, seed=seed))


@pytest.fixture(scope="module")
def step_ref():
    """One step of JAX's YOLO distillation in float64: the teacher (tiny
    UNet, eval), the student in train mode with ``mutable=["batch_stats"]``,
    ``yolo_distillation_loss`` at temperature ``T``, and the
    ``multi_transform`` of a frozen encoder and clip 1.0 + AdamW(lr, wd
    1e-4), as JAX's ``run_yolo_feature_distillation`` builds them."""
    jm, sv = _student_vars(seed=1)
    teacher = junet.PeopleSegmentationUNet(encoder_variant="tiny", decoder_channels=DEC)
    tv = jax.tree.map(np.asarray, fast_init(teacher, jnp.zeros((1, *IMG, 3)), train=False,
                                            seed=42))
    batch = _batch()
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        sv64, tv64 = (jax.tree.map(lambda a: np.asarray(a, np.float64), x) for x in (sv, tv))
        b = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        labels = jax.tree_util.tree_map_with_path(
            lambda path, _: "frozen" if path[0].key == "encoder" else "train", sv64["params"])
        tx = optax.multi_transform(
            {"train": optax.chain(optax.clip_by_global_norm(1.0),
                                  optax.adamw(LR, weight_decay=1e-4)),
             "frozen": optax.set_to_zero()}, labels)

        @jax.jit
        def step(params, batch_stats, opt_state, b):
            t_logits = teacher.apply(tv64, b["images"], train=False)

            def loss_fn(p):
                (s_logits, s_proj), updates = jm.apply(
                    {"params": p, "batch_stats": batch_stats}, b["images"], train=True,
                    return_features=True, mutable=["batch_stats"])
                loss, mdict = j_yolo_loss(s_logits, t_logits, b["masks"], s_proj,
                                          b["yolo_features"], temperature=T)
                return loss, (mdict, updates["batch_stats"])

            (loss, (mdict, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_stats, mdict, grads

        params, stats, mdict, grads = jax.tree.map(np.asarray, step(
            sv64["params"], sv64["batch_stats"], tx.init(sv64["params"]), b))
    return {"student": sv, "teacher": tv, "batch": batch, "metrics": mdict,
            "grads": from_jax_params({"params": grads}),
            "params": from_jax_params({"params": params}),
            "stats": from_jax_params({"batch_stats": stats})}


def _port_pair(ref):
    student = load_jax_params(pyd.YOLOFeatureDistillStudent(**TINY), ref["student"]).double()
    teacher = load_jax_params(PeopleSegmentationUNet("tiny", DEC), ref["teacher"]).double()
    return student, teacher.eval()


def test_yolo_step_matches_jax(step_ref):
    """The loss terms and every gradient (the frozen encoder's included) of
    the port's ``make_yolo_loss_fn``, then one ``make_yolo_train_step``: the
    parameters after it, the running statistics (the frozen encoder's moved
    too) and the encoder's parameters unchanged."""
    student, teacher = _port_pair(step_ref)
    student.train()
    loss, (_, metrics) = ptrain.make_yolo_loss_fn(student, teacher)(
        T, batch_to(step_ref["batch"], "cpu"))
    assert set(metrics) == set(step_ref["metrics"])
    for k, v in step_ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    named = list(student.named_parameters())
    found = torch.autograd.grad(loss, [p for _, p in named])
    assert {n for n, _ in named} == set(step_ref["grads"])
    for (name, _), g in zip(named, found):
        np.testing.assert_allclose(g.numpy(), step_ref["grads"][name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)

    student, teacher = _port_pair(step_ref)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    state = TrainState.create(student, ptrain.yolo_optimizer(student, LR))
    state, m = ptrain.make_yolo_train_step(student, teacher)(state, step_ref["batch"], T)
    assert state.step == 1
    np.testing.assert_allclose(float(m["total_loss"]), step_ref["metrics"]["total_loss"],
                               rtol=1e-4)
    after = student.state_dict()
    for name, want in {**step_ref["params"], **step_ref["stats"]}.items():
        np.testing.assert_allclose(after[name].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        if name.startswith("encoder."):
            stat = name.endswith(("running_mean", "running_var"))
            assert torch.equal(after[name], before[name]) != stat, name


def test_tiny_runs_from_synthetic_data_and_from_a_fixture(tmp_path):
    """``run_yolo_feature_distillation(tiny=True)`` on the CPU from synthetic
    batches and from a directory of feature files (3 and 2 samples, the tiny
    projector's 32 channels, the teacher loaded from a checkpoint of this
    package): the temperature ends at 1.0, the metrics are finite, the best
    student is checkpointed with its mIoU."""
    fixtures = tmp_path / "fixtures"
    fixtures.mkdir()
    rng = np.random.default_rng(0)
    for i, nb in enumerate((3, 2)):
        masks = np.zeros((nb, *IMG, 1), np.float32)
        masks[:, 16:48, 8:40] = 1.0
        np.savez(fixtures / f"feat{i}.npz", images=rng.random((nb, *IMG, 3), np.float32),
                 masks=masks, yolo_features=rng.standard_normal((nb, 8, 8, 32)).astype(np.float32))
    teacher = PeopleSegmentationUNet("tiny", DEC)
    init_weights(teacher, 7)
    (tmp_path / "teacher").mkdir()
    torch.save({"model": teacher.state_dict()}, tmp_path / "teacher" / "ckpt_3.pt")
    from_files = {"feature_dir": str(fixtures), "teacher_checkpoint": str(tmp_path / "teacher")}
    for name, kw in (("synthetic", {}), ("fixture", from_files)):
        out = tmp_path / name
        m, state = ptrain.run_yolo_feature_distillation(
            epochs=2, steps_per_epoch=2, batch=2, tiny=True, device="cpu",
            output_dir=str(out), return_state=True, **kw)
        assert m["temperature"] == pytest.approx(1.0)
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["feature_loss"] > 0 and 0.0 < m["best_student_miou"] <= 1.0
        assert state.step == 4
        metas = sorted((out / "checkpoints").glob("metadata_*.json"))
        epoch = metas[-1].stem.split("_")[1]
        assert json.loads(metas[-1].read_text()) == {"student_miou": m["best_student_miou"]}
        assert (out / "checkpoints" / f"ckpt_{epoch}.pt").exists()


def test_cli_runs_on_the_cpu_and_refuses_cuda_without_it(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["yolo_distill", "--tiny", "--synthetic", "--device", "cpu",
                                     "--epochs", "2", "--steps-per-epoch", "1",
                                     "--output_dir", str(tmp_path)])
    ptrain.main()
    assert '"temperature": 1.0' in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ptrain.run_yolo_feature_distillation(tiny=True, output_dir=str(tmp_path / "x"))
