"""The port's visualize, validation metrics, profiling and transfer_weights
against the JAX package's (CPU).

visualize is numpy and PIL on both sides: every function's output is held
equal (tolerance 0) on the same seeded arrays. The metrics run on tensors:
counts (confusion matrices) are exact, float sums agree within rtol 1e-6
(float32 sums in another order). transfer_weights is held on
``tests/test_progressive.py``'s three cases against JAX's transferred tree
brought over by ``weights.from_jax_params`` (or, for the hand-made trees,
the same leaf mapping: a ``kernel`` is a ``weight``, a 4-D one transposed
HWIO -> OIHW), its report against JAX's report with those names mapped.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu import visualize as jviz
from human_instance_segmentation_tpu.models import assembly as jasm
from human_instance_segmentation_tpu.training import metrics as jmetrics
from human_instance_segmentation_tpu.training import progressive as jprog
from human_instance_segmentation_tpu_torch import visualize as pviz
from human_instance_segmentation_tpu_torch.models import assembly as pasm
from human_instance_segmentation_tpu_torch.training import metrics as pmetrics
from human_instance_segmentation_tpu_torch.training import profiling as pprof
from human_instance_segmentation_tpu_torch.training import progressive as pprog
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread, as tests/test_torch_training.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    n, mh, mw = 3, 16, 12
    return {
        "image": rng.random((40, 56, 3), dtype=np.float32),
        "boxes": np.asarray([[0.1, 0.2, 0.5, 0.9], [0.4, 0.0, 1.0, 0.6],
                             [0.0, 0.0, 0.0, 0.0]], np.float32),
        "masks": rng.random((n, mh, mw, 1), dtype=np.float32),
        "gt": rng.integers(0, 3, (n, mh, mw)).astype(np.int32),
        "logits": rng.standard_normal((n, mh, mw, 3)).astype(np.float32),
        "binary": rng.random((40, 56, 1), dtype=np.float32),
        "crops": rng.random((n, 20, 14, 3), dtype=np.float32),
        "aux": {"bg_fg_logits": rng.standard_normal((n, mh, mw, 2)).astype(np.float32),
                "target_nontarget_logits": rng.standard_normal((n, 8, 6, 2)).astype(np.float32),
                "fg_attention": rng.random((n, 8, 6, 4), dtype=np.float32),
                "contours": rng.standard_normal((n, mh, mw, 1)).astype(np.float32),
                "distance_map": rng.random((n, mh, mw, 1), dtype=np.float32),
                "distance_mask": rng.standard_normal((n, mh, mw, 1)).astype(np.float32),
                "scalar_like": np.float32(3.0)},
        "heat": rng.random((9, 7), dtype=np.float32) * 2 - 0.5,
        "cm": rng.integers(0, 500, (3, 3)),
    }


VIZ_CALLS = {
    "instance_palette": lambda v, a: v.instance_palette(7),
    "paste_mask_into_box": lambda v, a: np.stack([
        v.paste_mask_into_box(a["masks"][i], a["boxes"][i], (40, 56)) for i in range(3)]),
    "overlay_instances": lambda v, a: v.overlay_instances(a["image"], a["masks"], a["boxes"]),
    "overlay_binary": lambda v, a: v.overlay_binary(a["image"], a["binary"]),
    "colorize_classes": lambda v, a: v.colorize_classes(a["gt"][0]),
    "validation_grid": lambda v, a: v.validation_grid(a["image"], a["gt"], a["logits"],
                                                      a["boxes"]),
    "validation_grid_binary": lambda v, a: v.validation_grid(
        a["image"], a["gt"], a["logits"], a["boxes"], binary_mask=a["binary"]),
    "heatmap": lambda v, a: v.heatmap(a["heat"], vmin=-0.2, vmax=1.1),
    "auxiliary_grid": lambda v, a: v.auxiliary_grid(
        a["crops"][0], a["logits"][0], {k: x[0] for k, x in a["aux"].items() if np.ndim(x)},
        gt_mask=a["gt"][0]),
}


@pytest.mark.parametrize("name", sorted(VIZ_CALLS))
def test_visualize_matches_jax(name):
    a = _arrays()
    got, want = VIZ_CALLS[name](pviz, a), VIZ_CALLS[name](jviz, a)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype
    as_u8 = (np.clip(np.asarray(got, np.float64), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(as_u8, (np.clip(np.asarray(want, np.float64), 0, 1) * 255)
                                  .astype(np.uint8))


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_visualize_writers_match_jax(tmp_path):
    """save_image round-trips through PNG; auxiliary_report and
    confusion_matrix_png write the same pixels as JAX's."""
    a = _arrays(1)
    pviz.save_image(str(tmp_path / "p" / "img.png"), a["image"])
    np.testing.assert_array_equal(_png(tmp_path / "p" / "img.png"),
                                  (np.clip(a["image"], 0, 1) * 255).astype(np.uint8))
    grid = pviz.auxiliary_report(a["crops"], a["logits"], a["aux"],
                                 str(tmp_path / "p" / "aux.png"), gt_masks=a["gt"])
    jgrid = jviz.auxiliary_report(a["crops"], a["logits"], a["aux"],
                                  str(tmp_path / "j" / "aux.png"), gt_masks=a["gt"])
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(_png(tmp_path / "p" / "aux.png"),
                                  _png(tmp_path / "j" / "aux.png"))
    names = ["bg", "target", "other"]
    for title in ("", "epoch 3"):
        for v, d in ((pviz, "p"), (jviz, "j")):
            v.confusion_matrix_png(a["cm"], names, str(tmp_path / d / "cm.png"), title=title)
        np.testing.assert_array_equal(_png(tmp_path / "p" / "cm.png"),
                                      _png(tmp_path / "j" / "cm.png"))


def _metric_inputs(seed=0):
    """Seeded logits with argmax ties and padded rows (``valid`` 0)."""
    rng = np.random.default_rng(seed)
    n, h, w = 6, 8, 6
    logits = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    logits[0, :2] = 0.0  # three-way ties: the first class wins
    logits[1, 0, :3] = [1.0, 1.0, 0.0]
    logits[1, 1, :3] = [0.0, 2.0, 2.0]
    logits[2] = np.round(logits[2])  # many ties
    targets = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    targets[3] = 0  # no target pixel, no instance
    valid = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
    return logits, targets, valid


def _check_sums(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k.startswith("cm"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("with_valid", [True, False])
def test_batch_metrics_match_jax(with_valid):
    logits, targets, valid = _metric_inputs()
    v = valid if with_valid else None
    got = pmetrics.batch_metrics(torch.from_numpy(logits), torch.from_numpy(targets),
                                 None if v is None else torch.from_numpy(v))
    want = jmetrics.batch_metrics(jnp.asarray(logits), jnp.asarray(targets),
                                  None if v is None else jnp.asarray(v))
    _check_sums(got, want)
    if with_valid:
        assert float(got["n"]) == 4.0
    # finalize on accumulated sums (two batches)
    acc = {k: got[k] + got[k] for k in got}
    jacc = {k: want[k] + want[k] for k in want}
    f_got, f_want = pmetrics.finalize_metrics(acc), jmetrics.finalize_metrics(jacc)
    assert f_got.keys() == f_want.keys()
    for k in f_want:
        np.testing.assert_allclose(np.asarray(f_got[k]), np.asarray(f_want[k]), rtol=RTOL,
                                   err_msg=k)


def test_confusion_matrix_and_binary_miou_match_jax():
    logits, targets, valid = _metric_inputs(1)
    pred = logits.argmax(-1).astype(np.int32)
    got = pmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(targets), 3)
    want = jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(targets), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = np.broadcast_to(valid[:, None, None], targets.shape).astype(np.float32)
    got = pmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(targets), 3,
                                    weights=torch.from_numpy(w.copy()))
    want = jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(targets), 3,
                                     weights=jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32
    bl = logits[..., :1].copy()
    bl[0, 0, 0, 0] = 0.0  # sigmoid exactly 0.5: not above the threshold
    masks = (targets[..., None] > 0).astype(np.float32)
    np.testing.assert_allclose(
        float(pmetrics.binary_miou(torch.from_numpy(bl), torch.from_numpy(masks))),
        float(jmetrics.binary_miou(jnp.asarray(bl), jnp.asarray(masks))), rtol=RTOL)


def test_profiling_helpers(tmp_path):
    """``trace`` writes a Chrome trace, and turns the port's spans on for its
    block only: they appear among the profiler's events and in
    ``spans.jsonl``."""
    from human_instance_segmentation_tpu_torch import tracing

    with pprof.trace(str(tmp_path / "trace")) as prof:
        assert tracing._on
        with tracing.span("engine.call"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not tracing._on
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    assert "hiseg.engine.call" in {e.name for e in prof.events()}
    lines = (tmp_path / "trace" / "spans.jsonl").read_text().splitlines()
    assert [json.loads(line)["name"] for line in lines] == ["hiseg.engine.call"]


# --- transfer_weights: tests/test_progressive.py's three cases ---------------


def _to_port(tree, prefix=()):
    """A JAX-style nested dict as a state_dict, the leaf mapping of
    ``weights.from_jax_params`` (a ``kernel`` is a ``weight``, HWIO ->
    OIHW when 4-D; other names stay)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_to_port(v, prefix + (k,)))
            continue
        a = np.asarray(v)
        if k == "kernel":
            k, a = "weight", a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
        out[".".join(prefix + (k,))] = torch.tensor(np.ascontiguousarray(a))
    return out


def _jax_name(port_key: str) -> str:
    return "/".join(port_key.split(".")[:-1] + ["kernel" if port_key.endswith(".weight")
                                                else port_key.split(".")[-1]])


def _check_report(report, jreport, to_jax):
    assert report["_summary"] == jreport["_summary"]
    mapped = {}
    for k, v in report.items():
        if k == "_summary":
            continue
        if v.startswith("suffix:"):
            v = "suffix:" + to_jax(v[len("suffix:"):])
        mapped[to_jax(k)] = v
    assert mapped == {k: v for k, v in jreport.items() if k != "_summary"}


def _check_state(state, want):
    assert sorted(state) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(state[k].numpy(), want[k].numpy(), err_msg=k)


def _slash(port_key_with_slashes: str) -> str:
    return _jax_name(port_key_with_slashes.replace("/", "."))


def test_transfer_weights_exact_and_suffix():
    src = {"params": {
        "encoder": {"conv": {"kernel": jnp.ones((3, 3, 4, 8))}},
        "head": {"out": {"kernel": jnp.full((1, 1, 8, 2), 2.0), "bias": jnp.ones((2,))}},
        "only_src": {"w": jnp.ones((5,))},
    }}
    dst = {"params": {
        "encoder": {"conv": {"kernel": jnp.zeros((3, 3, 4, 8))}},
        "new_head": {"out": {"kernel": jnp.zeros((1, 1, 8, 2)), "bias": jnp.zeros((2,))}},
        "fresh": {"w": jnp.zeros((7,))},
    }}
    merged, jreport = jprog.transfer_weights(src, dst)
    state, report = pprog.transfer_weights(_to_port(src), _to_port(dst))
    assert list(state) == list(_to_port(dst))  # the target's key order
    _check_state(state, _to_port(merged))
    _check_report(report, jreport, _slash)
    assert report["params/head/out/weight"] == "suffix:params/new_head/out/weight"
    assert report["params/only_src/w"] == "missing"


def test_transfer_weights_shape_mismatch_and_strict():
    src = {"a": {"kernel": jnp.ones((2, 2))}, "x": {"b": {"kernel": jnp.ones((3,))}}}
    dst = {"a": {"kernel": jnp.zeros((4, 4))}, "y": {"b": {"kernel": jnp.zeros((3,))}}}
    for strict in (True, False):
        merged, jreport = jprog.transfer_weights(src, dst, strict=strict)
        state, report = pprog.transfer_weights(_to_port(src), _to_port(dst), strict=strict)
        _check_state(state, _to_port(merged))
        _check_report(report, jreport, _slash)
        assert report["a/weight"] == "shape_mismatch"
        assert report["x/b/weight"] == ("missing" if strict else "suffix:y/b/weight")


def test_transfer_between_model_families():
    """A pure-RGB model into an ROI-pretrained one, both made from the same
    JAX variables: the port's transferred state equals ``from_jax_params``
    of JAX's transferred tree, and the reports agree (a 4-D ``weight`` is a
    ``kernel``, another ``weight`` a ``scale``). The shared head is copied,
    and the suffix matches pick the leaves JAX picks, which needs the walk
    in JAX's sorted order."""
    kw = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 64), feature_dim=64)
    dkw = dict(kw, encoder_variant="tiny", unet_decoder_channels=(32, 24, 16, 16, 8))
    imgs, rois = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 5))
    sv = fast_init(jasm.PureRGBHierarchicalModel(**kw), imgs, rois, train=False, seed=0)
    dv = fast_init(jasm.ROIPretrainedHierarchicalModel(**dkw), imgs, rois, train=False, seed=1)
    merged, jreport = jprog.transfer_weights(sv["params"], dv["params"])
    ps = load_jax_params(pasm.PureRGBHierarchicalModel(**kw), sv)
    pd = load_jax_params(pasm.ROIPretrainedHierarchicalModel(**dkw), dv)
    state, report = pprog.transfer_weights(ps, pd)
    want = from_jax_params({**dv, "params": merged}, pd)
    _check_state(state, {k: want[k] for k in pd.state_dict()})
    shapes = {**ps.state_dict(), **pd.state_dict()}

    def to_jax(path):
        key = path.replace("/", ".")
        parts = key.split(".")
        if parts[-1] == "weight":
            parts[-1] = "kernel" if shapes[key].dim() == 4 else "scale"
        return "/".join(parts)

    _check_report(report, jreport, to_jax)
    assert any(k.startswith("head/") and v == "copied" for k, v in report.items())
    assert any(v.startswith("suffix:") for v in report.values())
    pd.load_state_dict(state)
    with torch.no_grad():
        logits, _ = pd.eval()(torch.zeros(1, 64, 64, 3), torch.tensor([[0.0, .2, .2, .8, .8]]))
    assert torch.isfinite(logits).all()
