"""The port's deployment tools (``export.py``, ``harness.py``,
``validate.py``) against the JAX package's contracts
(``tests/test_export_harness.py``), on the CPU at the tiny flagship (the
JAX loop's ``--tiny`` shapes: 64 x 64 images, 16 x 12 ROIs, 32 x 24
masks), its variables from ``helpers.fast_init`` (non-trivial running
statistics) carried across by ``weights.load_jax_params``.

Tolerances: the BatchNorm fold of the same float32 variables equal to the
JAX fold bit for bit (the same IEEE float32 operations in the same order);
folded against unfolded outputs within the JAX test's atol 2e-4 (float32
rounding of the folded affine through a few dozen layers); an exported
program against the live plain model it was traced from bit for bit (the
same ATen operations), and against the unfolded model within 2e-4 on the
person probability with at least 99.5% of instance pixels equal (the same
bound as the chip run's float32 gates).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from helpers import fast_init
from human_instance_segmentation_tpu import export as jexport
from human_instance_segmentation_tpu.models.assembly import (
    HierarchicalInstanceSegmenter as JFlagship)
from human_instance_segmentation_tpu.training.metrics import finalize_metrics as jfinalize
from human_instance_segmentation_tpu_torch import export as pexport
from human_instance_segmentation_tpu_torch import harness as pharness
from human_instance_segmentation_tpu_torch import validate as pvalidate
from human_instance_segmentation_tpu_torch.inference import (create_flagship, deployed_outputs,
                                                             pad_rois)
from human_instance_segmentation_tpu_torch.ops.norms import BatchNorm2d
from human_instance_segmentation_tpu_torch.training.metrics import (batch_metrics,
                                                                   finalize_metrics)
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

IMG, ROI, MASK = (64, 64), (16, 12), (32, 24)
TINY = dict(roi_size=ROI, mask_size=MASK, image_size=IMG, base_channels=16, depth=2,
            mid_channels=32, feature_dim=32, unet_decoder_channels=(32, 24, 16, 16, 8))
VALIDATE_CONFIG = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_"
                   "r64x48m64x48_disttrans_contdet_baware")
MIN_AGREE = 0.995


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny flagship, its variables (numpy) and the port's model
    holding them."""
    jm = JFlagship(encoder_variant="tiny", **TINY)
    variables = jax.tree.map(np.asarray, fast_init(
        jm, jnp.zeros((1, *IMG, 3)), jnp.asarray([[0.0, 0.2, 0.2, 0.8, 0.8]]), train=False))
    pm = create_flagship("tiny", device="cpu", pallas_roi_align=False, **{
        k: v for k, v in TINY.items() if k not in ("roi_size", "mask_size", "image_size")},
        roi_size=ROI, mask_size=MASK, image_size=IMG)
    load_jax_params(pm, variables)
    return jm, variables, pm


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """Two artifacts of the port's tiny model: bucket (2,) at dilation 1,
    buckets (4, 16) at dilation 0."""
    _, _, pm = tiny
    root = tmp_path_factory.mktemp("artifacts")
    return {
        "one": pexport.export_model(str(root / "one"), pm, IMG, ROI, MASK, dilation_pixels=1,
                                    roi_buckets=(2,), config_name="tiny_test"),
        "chunked": pexport.export_model(str(root / "chunked"), pm, IMG, ROI, MASK,
                                        roi_buckets=(4, 16), config_name="tiny_test"),
    }


def _request(seed=0, n=1):
    rng = np.random.default_rng(seed)
    images = rng.random((1, *IMG, 3)).astype(np.float32)
    xy = rng.random((n, 2)) * 0.4
    rois = np.concatenate([np.zeros((n, 1)), xy, xy + 0.3 + rng.random((n, 2)) * 0.2],
                          axis=1).astype(np.float32)
    return images, rois


def _live(model, images, rois, dilation, bucket):
    """The deployed outputs of ``model`` in eval mode on the padded bucket,
    cut to the real ROIs."""
    rois_p = torch.from_numpy(pad_rois(rois, bucket))
    with torch.no_grad():
        logits, aux = model.eval()(torch.from_numpy(images), rois_p)
        inst, binary = deployed_outputs(logits, aux, rois_p, dilation)
    return inst[:rois.shape[0]].numpy(), binary.numpy()


def test_detect_architecture_matches_jax():
    for name in ("best_model_b0_64x48_0.8545_dil1", "..._from_b7_enhanced", "whatever",
                 "rgb_hierarchical_unet_v2_distillation_b1_from_b3", "x_b3_y", "B7_FROM_B0"):
        assert pexport.detect_architecture_from_name(name) == \
            jexport.detect_architecture_from_name(name), name
    assert pexport.detect_architecture_from_name("best_model_b0_64x48") == "b0"
    assert pexport.detect_architecture_from_name("whatever") == "b1"


def test_collect_bn_eps(tiny):
    """Every BatchNorm with its own epsilon (the encoder's 1e-3, the
    decoder's 1e-5), the same as JAX reads from its modules, by the same
    paths."""
    jm, variables, pm = tiny
    eps = pexport.collect_bn_eps(pm)
    assert any(k.startswith("pretrained_unet/encoder") and v == 1e-3 for k, v in eps.items())
    assert any(k.startswith("pretrained_unet/decoder") and v == 1e-5 for k, v in eps.items())
    assert all(v == (1e-3 if "/encoder/" in k else 1e-5) for k, v in eps.items())
    jeps = jexport.collect_bn_eps(jm, variables, IMG)
    bn_paths = {"/".join(str(getattr(p, "key", p)) for p in path[1:-1])
                for path, _ in jax.tree_util.tree_flatten_with_path(
                    {"batch_stats": variables["batch_stats"]})[0]}
    assert set(eps) == bn_paths
    assert {k: jeps[k] for k in eps} == eps


def test_fold_equals_the_jax_fold(tiny):
    """The port's fold of the carried weights, bit for bit the carried JAX
    fold of the same variables: scales, biases and identity statistics
    (mean 0, var 1 - eps)."""
    jm, variables, pm = tiny
    want = from_jax_params(jexport.fold_batch_stats(variables,
                                                    jexport.collect_bn_eps(jm, variables, IMG)))
    folded = pexport.fold_batch_stats(pexport.plain_copy(pm), pexport.collect_bn_eps(pm))
    got = folded.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    for m in folded.modules():
        if isinstance(m, BatchNorm2d):
            assert not m.running_mean.any()
            assert torch.equal(m.running_var, torch.full_like(m.running_var, 1.0 - m.eps))


def test_folded_outputs_match_unfolded(tiny):
    """Folded against unfolded forward within atol 2e-4 (the JAX test's),
    the caller's model left unfolded; a folded model's fused stage-1
    caches follow the folded weights (they key on version counters)."""
    _, _, pm = tiny
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    images, rois = _request(1, n=3)
    ref = _live(pm, images, rois, 0, 4)
    folded = pexport.fold_batch_stats(pexport.plain_copy(pm), pexport.collect_bn_eps(pm))
    out = _live(folded, images, rois, 0, 4)
    np.testing.assert_allclose(out[1], ref[1], atol=2e-4)
    with torch.no_grad():
        lf, _ = folded(torch.from_numpy(images), torch.from_numpy(rois))
        lr, _ = pm(torch.from_numpy(images), torch.from_numpy(rois))
    np.testing.assert_allclose(lf.numpy(), lr.numpy(), atol=2e-4)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k

    fused = create_flagship("tiny", device="cpu", pallas_tail=True, encoder_fused_blocks=3,
                            pallas_roi_align=False, **TINY)
    fused.load_state_dict(pm.state_dict())
    x = torch.from_numpy(images)
    unfolded_stage1 = fused.stage1(x)  # fills the fused blocks' and the tail's caches
    pexport.fold_batch_stats(fused, pexport.collect_bn_eps(fused))
    np.testing.assert_allclose(fused.stage1(x).numpy(), unfolded_stage1.numpy(), atol=2e-4)
    np.testing.assert_allclose(fused.stage1(x).numpy(), folded.stage1(x).numpy(), atol=1e-5)


def test_fold_reads_module_eps_not_path():
    """A BatchNorm under a decoder-named module declaring eps 1e-3 folds
    with its own eps; the wrong eps is measurably different, and a fold
    without any eps raises."""

    class OddlyNamed(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(3, 8, 3, padding=1)
            self.decoder_bn = BatchNorm2d(8, eps=1e-3)

        def forward(self, x):
            return self.decoder_bn(self.conv(x))

    torch.manual_seed(0)
    model = OddlyNamed().eval()
    with torch.no_grad():
        model.decoder_bn.running_mean.fill_(0.3)
        model.decoder_bn.running_var.fill_(2.0)
    x = torch.rand(1, 3, 8, 8)
    eps = pexport.collect_bn_eps(model)
    assert eps == {"decoder_bn": 1e-3}
    with torch.no_grad():
        ref = model(x)
        good = pexport.fold_batch_stats(pexport.plain_copy(model), eps)
        np.testing.assert_allclose(good(x).numpy(), ref.numpy(), atol=1e-5)
        bad = pexport.fold_batch_stats(pexport.plain_copy(model), {}, default_eps=1e-5)
        assert float((bad(x) - ref).abs().max()) > 1e-5
    with pytest.raises(ValueError, match="no epsilon"):
        pexport.fold_batch_stats(pexport.plain_copy(model))


def test_export_round_trip(tiny, artifacts, tmp_path):
    """Bucket (2,): the files, ``metadata.json`` with the JAX artifact's
    keys (its framework named), the outputs of ``load_exported`` equal to
    the live plain model it was traced from, and close to the unfolded
    model."""
    jm, variables, pm = tiny
    d = Path(artifacts["one"])
    assert sorted(p.name for p in d.iterdir()) == ["metadata.json", "model_n2.pt2", "params.pt"]
    meta = json.loads((d / "metadata.json").read_text())
    jd = Path(jexport.export_model(str(tmp_path / "jax"), jm, variables, image_size=IMG,
                                   roi_size=ROI, mask_size=MASK, dilation_pixels=1,
                                   roi_buckets=(2,), config_name="tiny_test",
                                   serialize_executable=False))
    jmeta = json.loads((jd / "metadata.json").read_text())
    assert meta.keys() == jmeta.keys()
    for key, value in jmeta.items():
        if isinstance(value, dict):
            assert meta[key].keys() == value.keys(), key
        elif key != "framework":
            assert meta[key] == value, key
    assert meta["framework"] == "human_instance_segmentation_tpu_torch"
    assert meta["model_kwargs"] == {"encoder_variant": "tiny"}

    call, meta2 = pexport.load_exported(str(d), device="cpu")
    assert meta2 == meta
    images, rois = _request(2)
    inst, binary = call(images, rois)
    assert inst.shape == (1, *MASK, 1) and binary.shape == (1, *IMG, 1)
    assert set(np.unique(inst)) <= {0.0, 1.0}
    folded = pexport.fold_batch_stats(pexport.plain_copy(pm), pexport.collect_bn_eps(pm))
    folded.load_state_dict(torch.load(d / "params.pt", weights_only=True))
    ref_inst, ref_bin = _live(folded, images, rois, 1, 2)
    assert np.array_equal(inst, ref_inst) and np.array_equal(binary, ref_bin)
    un_inst, un_bin = _live(pm, images, rois, 1, 2)
    np.testing.assert_allclose(binary, un_bin, atol=2e-4)
    assert (inst == un_inst).mean() >= MIN_AGREE
    with pytest.raises(RuntimeError, match="CUDA"):
        pexport.load_exported(str(d))  # the card by default; there is none here


def test_load_exported_above_max_bucket(artifacts):
    """33 ROIs over buckets (4, 16): chunked through the largest bucket,
    equal chunk by chunk to the in-bucket calls; a call of 3 ROIs runs the
    bucket of 4."""
    call, _ = pexport.load_exported(artifacts["chunked"], device="cpu")
    images, rois = _request(3, n=33)
    inst, binary = call(images, rois)
    assert inst.shape == (33, *MASK, 1) and binary.shape == (1, *IMG, 1)
    for s in (0, 16, 32):
        e = min(s + 16, 33)
        ref_inst, ref_bin = call(images, rois[s:e])
        np.testing.assert_array_equal(inst[s:e], ref_inst)
        np.testing.assert_allclose(binary, ref_bin, atol=1e-6)
    small, _ = call(images, rois[:3])
    np.testing.assert_array_equal(small, inst[:3])


def test_harness_with_artifact(artifacts, tmp_path):
    """``run_harness`` on an artifact over a directory of images, with ROIs
    from COCO annotations (normalised by each image's annotated size) and
    the default box where an image has none, in both modes."""
    rng = np.random.default_rng(4)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8)).save(imgs / f"img{i}.jpg")
    ann = {"images": [{"id": 1, "file_name": "img0.jpg", "width": 64, "height": 48}],
           "annotations": [{"id": 1, "image_id": 1, "bbox": [8, 6, 32, 24], "iscrowd": 0,
                            "segmentation": [[8, 6, 40, 6, 40, 30, 8, 30]]}],
           "categories": [{"id": 1, "name": "person"}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    from human_instance_segmentation_tpu_torch.data.coco import COCOIndex

    index = COCOIndex(str(tmp_path / "ann.json"))
    np.testing.assert_allclose(pharness.rois_for_image(index, "img0.jpg"),
                               [[0.0, 0.125, 0.125, 0.625, 0.625]])
    np.testing.assert_allclose(pharness.rois_for_image(index, "img1.jpg"),
                               [[0.0, 0.15, 0.05, 0.85, 0.98]])
    assert pharness.rois_for_image(None, "img1.jpg", default=False).shape == (0, 5)
    assert pharness.load_image(imgs / "img0.jpg", IMG).shape == (*IMG, 3)
    for mode in ("instance", "binary"):
        written = pharness.run_harness(str(imgs), str(tmp_path / "out"),
                                       artifact=artifacts["chunked"],
                                       annotations_path=str(tmp_path / "ann.json"), mode=mode,
                                       device="cpu")
        assert [Path(w).name for w in written] == [f"img0_{mode}.png", f"img1_{mode}.png"]
        for w in written:
            assert Image.open(w).size == (IMG[1], IMG[0])


def test_validation_synthetic(tmp_path, capsys):
    """``run_validation --tiny --device cpu`` on two synthetic batches: the
    JAX report's keys (JAX's ``finalize_metrics`` on the same sums), values
    equal to ``batch_metrics`` / ``finalize_metrics`` of the same model on
    the same batches, the confusion-matrix PNGs, the CLI's JSON."""
    report = pvalidate.run_validation(VALIDATE_CONFIG, synthetic_batches=2, batch_size=2,
                                      tiny=True, device="cpu", cm_png_dir=str(tmp_path / "cm"))
    from human_instance_segmentation_tpu_torch import config as pcfg
    from human_instance_segmentation_tpu_torch.training.loop import TINY_MODEL
    from human_instance_segmentation_tpu_torch.training.steps import rois_from_boxes

    cfg = pcfg.ConfigManager.get_config(VALIDATE_CONFIG)
    cfg.model.image_size, cfg.model.roi_size, cfg.model.mask_size = IMG, ROI, MASK
    cfg.model.encoder_name = "tiny"
    cfg.model.hierarchical_base_channels, cfg.model.hierarchical_depth = 16, 2
    cfg.data.rois_per_image = 2
    model = pcfg.model_from_config(cfg, seed=0, device="cpu", **TINY_MODEL).eval()
    sums = None
    for b in pvalidate.synthetic_validation_batches(2, 2, cfg.data.rois_per_image, IMG, MASK):
        with torch.no_grad():
            logits, _ = model(torch.from_numpy(b["images"]),
                              rois_from_boxes(torch.from_numpy(b["boxes"])))
        n = b["valid"].size
        m = {k: v.numpy() for k, v in batch_metrics(
            logits, torch.from_numpy(b["masks"]).reshape(n, *MASK),
            torch.from_numpy(b["valid"]).reshape(n)).items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    assert report == finalize_metrics(sums)
    jreport = jfinalize(sums)
    assert report.keys() == jreport.keys()
    for k, v in jreport.items():
        np.testing.assert_allclose(np.asarray(report[k]), np.asarray(v), rtol=1e-12, err_msg=k)
    assert 0.0 <= report["target_miou"] <= 1.0 and report["num_samples"] == 8.0
    for key in ("cm3", "cm_bgfg", "cm_tnt"):
        assert (tmp_path / "cm" / f"{key}.png").exists()
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == json.loads(json.dumps(report))
    with pytest.raises(RuntimeError, match="no validation data"):
        pvalidate.run_validation(VALIDATE_CONFIG, synthetic_batches=0, tiny=True, device="cpu",
                                 annotations=str(_empty_coco(tmp_path)), image_dir=str(tmp_path))


def _empty_coco(tmp_path):
    p = tmp_path / "empty.json"
    p.write_text(json.dumps({"images": [], "annotations": [],
                             "categories": [{"id": 1, "name": "person"}]}))
    return p


def test_export_cli_reads_a_checkpoint(tmp_path, monkeypatch, capsys):
    """``python -m ...export --config ... --checkpoint ckpt --device cpu
    --no-executable`` on the deployed B0 config: ``params.pt`` is the
    checkpoint's weights folded, the metadata the config's sizes."""
    from human_instance_segmentation_tpu_torch import config as pcfg
    from human_instance_segmentation_tpu_torch.training.checkpoint import save_checkpoint
    from human_instance_segmentation_tpu_torch.training.optim import Transform, constant_schedule
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    name = pharness.DEFAULT_CONFIG
    model = pcfg.model_from_config(pcfg.ConfigManager.get_config(name), seed=5, device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), TrainState.create(
        model, Transform("sgd", constant_schedule(0.0))), 7)
    monkeypatch.setattr(sys, "argv", ["export", "--config", name, "--out", str(tmp_path / "art"),
                                      "--checkpoint", str(tmp_path / "ckpt"), "--device", "cpu",
                                      "--no-executable"])
    pexport.main()
    assert "exported to" in capsys.readouterr().out
    meta = json.loads((tmp_path / "art" / "metadata.json").read_text())
    sizes = pcfg.ConfigManager.get_config(name).model
    assert (meta["config_name"], meta["image_size"], meta["mask_size"]) == (
        name, list(sizes.image_size), list(sizes.mask_size))
    assert not list((tmp_path / "art").glob("*.pt2"))
    want = pexport.fold_batch_stats(pexport.plain_copy(model),
                                    pexport.collect_bn_eps(model)).state_dict()
    got = torch.load(tmp_path / "art" / "params.pt", weights_only=True)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
