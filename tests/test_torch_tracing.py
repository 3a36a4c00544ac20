"""The port's spans and counters (``tracing.py``) on a tiny int8 flagship
engine on the CPU: nothing when off; when on, the serving stages as nested
spans of one request, on the profiler's clock, with the request's counters.

    python -m pytest tests/test_torch_tracing.py -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from human_instance_segmentation_tpu_torch import tracing
from human_instance_segmentation_tpu_torch.inference import (InferenceEngine, create_flagship,
                                                             roi_bucket)
from human_instance_segmentation_tpu_torch.ops import quant

TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32)
ENGINE_SPANS = ["engine.call", "engine.pad", "engine.upload", "engine.forward",
                "model.stage1", "model.crops", "model.stage2", "model.head.bgfg_unet",
                "model.head.unread", "engine.outputs", "engine.download"]
PARENTS = {"engine.pad": "engine.call", "engine.upload": "engine.call",
           "engine.forward": "engine.call", "engine.download": "engine.call",
           "model.stage1": "engine.forward",
           "model.crops": "engine.forward", "model.stage2": "engine.forward",
           "engine.outputs": "engine.forward", "model.head.unread": "model.stage2",
           "model.head.bgfg_unet": "model.stage2"}


def _request(n_rois: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.random((2, 64, 96, 3), dtype=np.float32)
    lo = rng.uniform(0.0, 0.4, (n_rois, 2))
    rois = np.concatenate([np.arange(n_rois)[:, None] % 2, lo, lo + 0.5], axis=1)
    return images, rois.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops: intra-op threads only contend with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engine():
    """A served int8 engine after its first call (calibrated at 3 RoIs), with
    the operands that call built."""
    model = create_flagship(variant="tiny", device="cpu", seed=0, pallas_tail=True,
                            encoder_fused_blocks=6, use_contour_detection=True,
                            use_distance_transform=True, **TINY)
    eng = InferenceEngine(model, device="cpu", dilation_pixels=1, dtype=torch.bfloat16,
                          fused_head=True, quantize="int8")
    builds = quant.QConv.operand_builds
    eng(*_request(3))
    eng.first_call_builds = quant.QConv.operand_builds - builds
    return eng


@pytest.fixture(scope="module")
def traced(engine, tmp_path_factory):
    """Two requests and a counted launch under a CPU profiler with tracing
    on, written to a JSON-lines file; the entry points' counters around it."""
    path = tmp_path_factory.mktemp("spans") / "out" / "spans.jsonl"
    before, calls = tracing.launch_counts(), quant.QConv.int8_calls
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.recording(str(path)) as records:
        engine(*_request(3))
        engine(*_request(3, seed=1))
        with tracing.span("engine.call"):  # a launch counted inside a request
            quant.qconv2d.launches += 2
        tracing.count("outside", 1)  # outside every span: dropped
    return {"records": records, "events": prof.events(), "path": path, "before": before,
            "after": tracing.launch_counts(), "int8_calls": quant.QConv.int8_calls - calls}


def _names(records):
    return [r["name"][len(tracing.PREFIX):] for r in records]


def test_off_makes_no_span_and_no_profiler_range(engine):
    assert not tracing._on
    assert tracing.span("engine.call") is tracing.span("model.stage2")  # one shared no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine(*_request(3))
    assert not [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    with tracing.recording() as records:
        pass
    assert records == []


def test_on_spans_nest_in_one_request_and_reach_the_profiler(traced):
    records = traced["records"]
    assert _names(records) == ENGINE_SPANS * 2 + ["engine.call"]
    first = records[0]["request"]
    n = len(ENGINE_SPANS)
    assert [r["request"] for r in records] == [first] * n + [first + 1] * n + [first + 2]
    for r in records:
        name = r["name"][len(tracing.PREFIX):]
        if name == "engine.call":
            assert r["parent"] is None and "counters" in r
        else:
            parent = records[r["parent"]]
            assert parent["name"] == tracing.PREFIX + PARENTS[name]
            assert parent["request"] == r["request"]
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
    host = [e for e in traced["events"] if e.name.startswith(tracing.PREFIX)]
    assert sorted(e.name for e in host) == sorted(r["name"] for r in records)
    assert all(e.is_user_annotation for e in host)


def test_bgfg_unet_span_once_a_call_inside_stage2(traced):
    """``model.head.bgfg_unet`` (the head's EnhancedUNet) is recorded once a
    served call, inside that call's ``model.stage2``."""
    records = traced["records"]
    calls = [i for i, r in enumerate(records) if r["name"] == tracing.PREFIX + "engine.call"]
    unets = [r for r in records if r["name"] == tracing.PREFIX + "model.head.bgfg_unet"]
    assert len(unets) == 2 and len(calls) == 3  # two served calls and a bare span
    for r in unets:
        parent = records[r["parent"]]
        assert parent["name"] == tracing.PREFIX + "model.stage2"
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
    assert sorted(r["request"] for r in unets) == [records[i]["request"] for i in calls[:2]]


@pytest.mark.parametrize("roi,depth,resizes", [((80, 60), 4, 1), ((64, 48), 3, 0)],
                         ids=["b1_enhanced_80x60", "b0_64x48"])
def test_unet_skip_resizes_counts_odd_sizes(roi, depth, resizes):
    """``unet_skip_resizes`` counts the EnhancedUNet's up-steps resized to
    their skips: at B1's RoI 80 x 60 and depth 4 the pooled width 15 floors
    to 7 and the first up-step (20 x 14) is resized to 20 x 15, once a
    forward; at B0's 64 x 48 and depth 3 no size is odd."""
    from human_instance_segmentation_tpu_torch.models.heads import EnhancedUNet

    unet = EnhancedUNet(8, base_channels=4, depth=depth).eval()
    x = torch.randn(1, 8, *roi, generator=torch.Generator().manual_seed(0))
    with tracing.recording() as records, torch.no_grad():
        for _ in range(2):
            with tracing.span("engine.call"):
                out = unet(x)
    assert tuple(out.shape) == (1, 2, *roi)
    assert [r["counters"].get("unet_skip_resizes", 0) for r in records] == [resizes] * 2


def test_self_time_is_duration_less_children(traced):
    records = traced["records"]
    for i, r in enumerate(records):
        children = sum(c["end_ns"] - c["start_ns"] for c in records if c["parent"] == i)
        assert r["self_ns"] == r["end_ns"] - r["start_ns"] - children
        assert r["self_ns"] >= 0


@pytest.mark.parametrize("n_rois", [1, 3, 5])
def test_roi_counters_follow_the_bucket(engine, n_rois):
    images, rois = _request(n_rois)
    with tracing.recording() as records:
        engine(images, rois)
    c = records[0]["counters"]
    bucket = roi_bucket(n_rois, max_bucket=engine.max_bucket)
    assert (c["images"], c["rois"], c["rois_computed"]) == (2, n_rois, bucket)
    # bf16 images and float32 RoIs up; float32 masks and probability maps down
    assert c["h2d_bytes"] == images.size * 2 + bucket * 5 * 4
    assert c["d2h_bytes"] == n_rois * 32 * 24 * 4 + 2 * 64 * 96 * 4


def test_launch_deltas_equal_the_entry_points_counters(traced):
    requests = [r["counters"] for r in traced["records"] if r["parent"] is None]
    served, bumped = requests[:2], requests[2]
    assert sum(c["int8_calls"] for c in served) == traced["int8_calls"] > 0
    assert bumped["launches.qconv2d"] == 2
    for k, v in traced["after"].items():
        assert sum(c[k] for c in requests) == v - traced["before"][k]


def test_operand_builds_stay_still_after_the_first_call(engine, traced):
    assert engine.first_call_builds > 0  # the engine's copy builds its operands once
    served = [r["counters"] for r in traced["records"] if r["parent"] is None][:2]
    assert [c["operand_builds"] for c in served] == [0, 0]


def test_recording_writes_json_lines(traced):
    lines = [json.loads(line) for line in traced["path"].read_text().splitlines()]
    assert lines == json.loads(json.dumps(traced["records"]))
    assert all("outside" not in r.get("counters", {}) for r in lines)
    assert not tracing._on
