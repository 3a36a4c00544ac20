"""The port's ``analyze``, ``experiments`` and ``int8_accuracy`` against the
JAX package's.

``analyze``'s numpy subcommands (stats, bboxes, roi-sizes, training,
images) equal JAX's outputs on the same annotations, through the functions
and through the CLI. ``analyze_temperature`` (torch here, jax there)
equals JAX's within rtol 1e-6, and within the unit of the fifth decimal
both round their KL to (atol 1e-5). ``analyze_complexity``'s parameter counts of
tiny configs equal JAX's variable counts exactly; its FLOPs are
``FlopCounterMode``'s, not XLA's ``cost_analysis``, and the test records
their ratio on the tiny baseline config (it asserts only that both are
positive and within a factor 2). ``run_experiments`` trains the tiny
synthetic flagship for one step and writes JAX's ``results.json`` /
``comparison.md``. ``int8_accuracy`` is the slow tier, gated on
``RUN_SLOW`` like ``tests/test_int8_accuracy.py``, with that test's gates.
"""

import json
import os

import numpy as np
import pytest

from human_instance_segmentation_tpu import analyze as janalyze
from human_instance_segmentation_tpu_torch import analyze as panalyze

def torch_cuda_available():
    import torch

    return torch.cuda.is_available()


FLAGSHIP = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_r64x48m128x96_"
            "disttrans_contdet_baware_from_b0")
ANNS = {
    "images": [
        {"id": 1, "file_name": "a.jpg", "width": 640, "height": 480},
        {"id": 2, "file_name": "b.jpg", "width": 320, "height": 240},
        {"id": 3, "file_name": "c.jpg", "width": 640, "height": 480},
    ],
    "annotations": [
        {"id": 1, "image_id": 1, "bbox": [10, 10, 100, 200], "iscrowd": 0, "category_id": 1,
         "area": 20000, "segmentation": [[10, 10, 110, 10, 110, 210, 10, 210]]},
        {"id": 2, "image_id": 1, "bbox": [60, 50, 120, 90], "iscrowd": 0, "category_id": 1,
         "area": 10800, "segmentation": [[60, 50, 180, 50, 180, 140, 60, 140]]},
        {"id": 3, "image_id": 2, "bbox": [5, 5, 100, 10], "iscrowd": 0, "category_id": 1,
         "area": 1000, "segmentation": [[5, 5, 105, 5, 105, 15, 5, 15]]},
        {"id": 4, "image_id": 2, "bbox": [5, 5, 0, 10], "iscrowd": 0, "category_id": 1,
         "area": 0, "segmentation": [[5, 5, 5, 5, 5, 15]]},
        {"id": 5, "image_id": 3, "bbox": [200, 100, 80, 300], "iscrowd": 0, "category_id": 1,
         "area": 24000, "segmentation": [[200, 100, 280, 100, 280, 400, 200, 400]]},
    ],
}


@pytest.fixture()
def ann_path(tmp_path):
    p = tmp_path / "anns.json"
    p.write_text(json.dumps(ANNS))
    return str(p)


def _same(a, b):
    """Equal after a JSON round trip (dict keys as strings, tuples as lists)."""
    assert json.loads(json.dumps(a, default=str)) == json.loads(json.dumps(b, default=str))


def test_dataset_functions_equal_jax(ann_path):
    _same(panalyze.analyze_dataset(ann_path), janalyze.analyze_dataset(ann_path))
    _same(panalyze.analyze_bboxes(ann_path), janalyze.analyze_bboxes(ann_path))
    _same(panalyze.analyze_bboxes(ann_path, 50.0, (0.5, 2.0)),
          janalyze.analyze_bboxes(ann_path, 50.0, (0.5, 2.0)))
    for size in ((640, 640), (480, 640)):
        _same(panalyze.analyze_roi_sizes(ann_path, size),
              janalyze.analyze_roi_sizes(ann_path, size))
    assert (panalyze.list_images_by_size(ann_path, (640, 480))
            == janalyze.list_images_by_size(ann_path, (640, 480)) == ["a.jpg", "c.jpg"])


def test_training_summary_equals_jax(tmp_path):
    rows = [{"step": 10, "prefix": "train", "total_loss": 2.0},
            {"step": 10, "prefix": "val", "total_loss": 1.8, "target_miou": 0.5},
            {"step": 20, "prefix": "train", "total_loss": 1.0},
            {"step": 20, "prefix": "val", "total_loss": 1.1, "target_miou": 0.72}]
    (tmp_path / "run.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    got = panalyze.analyze_training(str(tmp_path))
    _same(got, janalyze.analyze_training(str(tmp_path)))
    assert got["best"] == {"step": 20, "target_miou": 0.72}


@pytest.mark.parametrize("schedule", ["linear", "cosine", "exponential"])
def test_temperature_equals_jax(schedule):
    got = panalyze.analyze_temperature(10.0, 1.0, 12, schedule)
    want = janalyze.analyze_temperature(10.0, 1.0, 12, schedule)
    assert got["schedule"] == want["schedule"] and len(got["rows"]) == 12
    for g, w in zip(got["rows"], want["rows"]):
        assert g["epoch"] == w["epoch"]
        for k in ("temperature", "kl", "kl_t2_scaled"):
            # both round to 5 decimals (3 for T): a last digit may round apart
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("sub", ["legacy", "stats", "bboxes", "roi-sizes", "images"])
def test_cli_equals_jax(ann_path, tmp_path, capsys, sub):
    def run(main, out):
        args = {"legacy": ["--annotations", ann_path, "--out", out],
                "stats": ["stats", "--annotations", ann_path, "--out", out],
                "bboxes": ["bboxes", "--annotations", ann_path],
                "roi-sizes": ["roi-sizes", "--annotations", ann_path, "--image_size", "480",
                              "640"],
                "images": ["images", "--annotations", ann_path, "--size", "640x480"]}[sub]
        main(args)
        printed = capsys.readouterr().out
        return printed, (json.loads(open(out).read()) if sub in ("legacy", "stats") else None)

    got = run(panalyze.main, str(tmp_path / "p.json"))
    want = run(janalyze.main, str(tmp_path / "j.json"))
    assert got == want


def _jax_param_count(name):
    import jax
    import jax.numpy as jnp

    from human_instance_segmentation_tpu import config as jcfg

    cfg = jcfg.ConfigManager.get_config(name)
    cfg.model.image_size = (64, 64)
    cfg.model.roi_size = (16, 12)
    cfg.model.mask_size = (32, 24)
    cfg.model.encoder_name = "tiny"
    cfg.model.hierarchical_base_channels = 16
    cfg.model.hierarchical_depth = 2
    model = jcfg.model_from_config(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                               jnp.zeros((1, 5)), train=False))
    return int(sum(np.prod(s.shape) for s in jax.tree.leaves(shapes)))


@pytest.mark.parametrize("name", [
    FLAGSHIP, "baseline", "rgb_hierarchical_unet_v2_attention_r64m64_refined_boundaryref_contour_"
    "batchnorm", "rgb_hierarchical_unet_v2"])
def test_complexity_param_counts_equal_jax(name):
    rep = panalyze.analyze_complexity([name], tiny=True, device="cpu")[name]
    assert rep["params"] == _jax_param_count(name)
    assert rep["params_m"] == round(rep["params"] / 1e6, 2) and rep["gflops_per_image"] > 0


def test_complexity_flops_ratio_recorded():
    """FlopCounterMode (convs and matmuls) against XLA's cost analysis on the
    tiny baseline: both positive and within a factor 2; the ratio printed
    (1.04 when this test was written)."""
    got = panalyze.analyze_complexity(["baseline"], tiny=True, device="cpu")["baseline"]
    want = janalyze.analyze_complexity(["baseline"], tiny=True)["baseline"]
    assert got["params"] == want["params"]
    ratio = got["gflops_per_image"] / want["gflops_per_image"]
    print(f"FlopCounterMode / XLA cost_analysis on the tiny baseline: {ratio:.3f}")
    assert 0.5 < ratio < 2.0


@pytest.mark.skipif(torch_cuda_available(), reason="checks the refusal where CUDA is missing")
def test_complexity_defaults_to_the_card(capsys):
    """The function and the CLI build on the card unless asked for the CPU:
    without CUDA the default raises, and ``--device cpu`` prints the
    function's report."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        panalyze.analyze_complexity(["baseline"], tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        panalyze.main(["complexity", "baseline", "--tiny"])
    capsys.readouterr()
    panalyze.main(["complexity", "baseline", "--tiny", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == panalyze.analyze_complexity(["baseline"], tiny=True, device="cpu")


def test_run_experiments_tiny(tmp_path):
    """One config that trains and one that fails (the loop refuses the
    baseline, ROADMAP C15): the sweep goes on, and writes JAX's report."""
    from human_instance_segmentation_tpu_torch.experiments import run_experiments

    out = tmp_path / "cmp"
    res = run_experiments([FLAGSHIP, "baseline"], steps=1, synthetic=True, tiny=True,
                          output_dir=str(out), device="cpu")
    assert res[FLAGSHIP]["status"] == 1.0 and np.isfinite(res[FLAGSHIP]["total_loss"])
    assert res["baseline"]["status"] == 0.0 and "ROISegmentationModel" in res["baseline"]["error"]
    saved = json.loads((out / "results.json").read_text())
    assert set(saved) == {FLAGSHIP, "baseline"}
    table = (out / "comparison.md").read_text().splitlines()
    assert table[0] == "| config | total_loss | eval_miou | wall_s |" and len(table) == 4
    assert table[2].startswith(f"| {FLAGSHIP} | ")
    assert any((out / FLAGSHIP / "checkpoints").glob("ckpt_*.pt"))


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"), reason="slow tier")
def test_int8_accuracy_gates():
    """The JAX slow test's gates on the port: trained to mIoU > 0.6, the
    fused-tail form within 1e-4 of the plain one, int8 (plain and with the
    s8 tail) within 0.002."""
    from human_instance_segmentation_tpu_torch.int8_accuracy import main

    r = main(device="cpu", epochs=20, verbose=False)
    assert r["f32"] > 0.6, r
    assert abs(r["tail_f32"] - r["f32"]) < 1e-4, r
    assert abs(r["int8"] - r["f32"]) < 0.002, r
    assert abs(r["tail_int8"] - r["f32"]) < 0.002, r
