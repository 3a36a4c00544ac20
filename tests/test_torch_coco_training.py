"""The port's training loop on COCO data (CPU, ``run_training(tiny=True,
device="cpu")``) and its validation sweep against the JAX package's eval
step.

The train tree is written by the port's ``generate_synthetic_coco``; the
val annotation JSON is written here over generated images, with 1, 2, 3
and 5 people an image (rectangles as in ``tests/test_curated_scenes.py``),
so every curated scene exists. ``--tiny`` trains at batch 1, so an epoch is
one step an image. The sweep's sums are held against JAX's
``make_eval_step`` over the same padded batches with the same weights
within rtol 1e-5 (float32 forwards of a few dozen layers, summed in another
order).
"""

import json
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu import config as jcfg
from human_instance_segmentation_tpu.training import steps as jsteps
from human_instance_segmentation_tpu_torch import config as pcfg
from human_instance_segmentation_tpu_torch.data import (COCOInstanceSegmentationDataset,
                                                        DatasetConfig, padded_batch_iterator)
from human_instance_segmentation_tpu_torch.data.synthetic import generate_synthetic_coco
from human_instance_segmentation_tpu_torch.training import steps as psteps
from human_instance_segmentation_tpu_torch.training.loop import (TINY_MODEL, run_training,
                                                                validation_sums)
from human_instance_segmentation_tpu_torch.weights import load_jax_params

FLAGSHIP = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_r64x48m128x96_"
            "disttrans_contdet_baware_from_b0")
HW = (96, 128)
PEOPLE = (2, 1, 3, 5, 2)  # people in each val image; the curated scenes are 1, 2, 3, 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread, as tests/test_torch_training.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    train_ann, train_imgs = generate_synthetic_coco(str(root / "train"), n_images=4,
                                                    image_size=HW, max_instances=3, seed=0)
    _, val_imgs = generate_synthetic_coco(str(root / "val"), n_images=len(PEOPLE), image_size=HW,
                                          max_instances=1, seed=1)
    images, annotations = [], []
    for i, n in enumerate(PEOPLE):
        images.append({"id": i + 1, "file_name": f"synthetic_{i:06d}.jpg", "width": HW[1],
                       "height": HW[0]})
        for j in range(n):
            x, y, w, h = 4 + 24 * j, 10 + 3 * i, 20, 60
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1, "category_id": 1,
                                "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                                "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]]})
    val_ann = root / "val_people.json"
    val_ann.write_text(json.dumps({"images": images, "annotations": annotations,
                                   "categories": [{"id": 1, "name": "person"}]}))
    return {"data": {"train_annotation": train_ann, "train_img_dir": train_imgs,
                     "val_annotation": str(val_ann), "val_img_dir": val_imgs,
                     "num_workers": 2}}


def _mods(tree, **training):
    return {**tree, "training": {"warmup_epochs": 0, "validate_every": 1, **training}}


def _log_rows(out):
    return [json.loads(line) for f in sorted(Path(out, "logs").glob("*.jsonl"))
            for line in f.read_text().splitlines()]


def _val_dataset(tree, size=(64, 64)):
    d = tree["data"]
    return COCOInstanceSegmentationDataset(d["val_annotation"], d["val_img_dir"], DatasetConfig(
        image_size=size, mask_size=(32, 24), rois_per_image=2))


def test_coco_loop_trains_validates_renders_and_checkpoints(tree, tmp_path):
    out = tmp_path / "run"
    threads = threading.active_count()
    metrics, state = run_training(FLAGSHIP, epochs=2, tiny=True, device="cpu",
                                  output_dir=str(out), config_modifications=_mods(tree),
                                  return_state=True)
    deadline = time.monotonic() + 10.0  # the loader's threads leave within a timeout each
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= threads
    train_len = len(COCOInstanceSegmentationDataset(
        tree["data"]["train_annotation"], tree["data"]["train_img_dir"],
        DatasetConfig(image_size=(64, 64), mask_size=(32, 24), rois_per_image=2)))
    spe = train_len // 1  # --tiny trains at batch 1
    assert state.step == 2 * spe and state.skipped == 0 and np.isfinite(metrics["total_loss"])
    rows = _log_rows(out)
    assert [r["step"] for r in rows if "val_miou" in r] == [spe, 2 * spe]
    viz = sorted(p.name for p in (out / "visualizations").iterdir())
    labels = ("1person", "2person", "3person", "5person")
    assert viz == sorted([f"epoch{e:04d}_{lab}{s}.png" for e in (0, 1) for lab in labels
                          for s in ("", "_aux")] + [f"val_step{2 * spe}.png"])
    text = "".join(f.read_text() for f in (out / "logs").glob("*.log"))
    assert "curated validation scenes: 1person=val[1], 2person=val[0], 3person=val[2], " \
           "5person=val[3]" in text and "skipped" not in text
    assert (out / "checkpoints").is_dir() and (out / "checkpoints_best").is_dir()
    # the last validation is the sweep of the trained model over the padded val batches
    sums = validation_sums(psteps.make_eval_step(state.model),
                           padded_batch_iterator(_val_dataset(tree), 1))
    assert metrics["val_miou"] == sums["iou_sum"] / sums["n"]
    assert sums["n"] == sum(min(p, 2) for p in PEOPLE)  # K = 2 slots an image


def test_validation_sweep_matches_jax_eval_step(tree):
    """The sweep's sums over padded batches of 2 (the last one padded) with
    the same weights in both packages."""
    cfg = jcfg.ConfigManager.get_config(FLAGSHIP)
    pc = pcfg.ConfigManager.get_config(FLAGSHIP)
    for c in (cfg, pc):
        c.model.image_size, c.model.roi_size, c.model.mask_size = (64, 64), (16, 12), (32, 24)
        c.model.encoder_name = "tiny"
        c.model.hierarchical_base_channels, c.model.hierarchical_depth = 16, 2
    jmodel = jcfg.model_from_config(cfg).clone(**TINY_MODEL)
    variables = fast_init(jmodel, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 5)), train=False,
                          seed=3)
    pmodel = pcfg.model_from_config(pc, seed=0, device="cpu", **TINY_MODEL)
    load_jax_params(pmodel, jax.tree.map(np.asarray, variables))
    batches = list(padded_batch_iterator(_val_dataset(tree), 2))
    assert len(batches) == 3 and batches[-1]["valid"][1].sum() == 0
    got = validation_sums(psteps.make_eval_step(pmodel), batches)
    jstep = jsteps.make_eval_step(jmodel)
    want = None
    with jax.default_matmul_precision("highest"):
        for b in batches:
            m = jax.device_get(jstep((variables["params"], variables.get("batch_stats", {})),
                                     {k: b[k] for k in ("images", "boxes", "masks", "valid")}))
            m = {k: float(v) for k, v in m.items()}
            want = m if want is None else {k: want[k] + m[k] for k in want}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["n"] == sum(min(p, 2) for p in PEOPLE)


def test_coco_resume_continues_as_the_uninterrupted_run(tree, tmp_path):
    """Stopped inside the second epoch and resumed, the run ends where the
    uninterrupted one does: the loader restarts at the restored step's
    epoch and skips the batches of it already taken."""
    kw = dict(epochs=2, tiny=True, device="cpu", config_modifications=_mods(tree),
              return_state=True)  # the schedule spans the same 2 epochs in every part
    _, whole = run_training(FLAGSHIP, output_dir=str(tmp_path / "a"), **kw)
    total = whole.step
    run_training(FLAGSHIP, steps=total // 2 + 1, output_dir=str(tmp_path / "b"), **kw)
    _, resumed = run_training(FLAGSHIP, steps=total, output_dir=str(tmp_path / "b"),
                              resume=True, **kw)
    assert resumed.step == total
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_coco_loop_refuses_a_train_set_smaller_than_a_batch(tree, tmp_path):
    """A train set with no usable image raises before any step (the JAX
    loop would wait for a batch without end; ROADMAP C11)."""
    ann = tmp_path / "no_people.json"
    ann.write_text(json.dumps({
        "images": [{"id": 1, "file_name": "synthetic_000000.jpg", "width": HW[1],
                    "height": HW[0]}],
        "annotations": [], "categories": [{"id": 1, "name": "person"}]}))
    mods = _mods(tree)
    mods["data"] = {**mods["data"], "train_annotation": str(ann)}
    with pytest.raises(ValueError, match="0 usable images, fewer than one batch of 1"):
        run_training(FLAGSHIP, epochs=1, tiny=True, device="cpu",
                     output_dir=str(tmp_path / "run"), config_modifications=mods)


def test_synthetic_loop_keeps_its_behaviour(tmp_path):
    """``--synthetic`` validates on its held-out batches, renders no curated
    scene and now writes the end-of-run picture, as the JAX loop does."""
    out = tmp_path / "run"
    metrics = run_training(FLAGSHIP, steps=2, synthetic=True, tiny=True, device="cpu",
                           output_dir=str(out))
    assert np.isfinite(metrics["total_loss"]) and 0.0 <= metrics["val_miou"] <= 1.0
    assert metrics["val_n"] == 4.0 and metrics["skipped"] == 0.0  # 2 batches x 1 x 2 rois
    assert sorted(p.name for p in (out / "visualizations").iterdir()) == ["val_step2.png"]
