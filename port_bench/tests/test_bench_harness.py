"""The harness's arithmetic and files on the CPU: traffic, the work count,
the metric readers on a synthetic profile, ``BENCHMARK.json`` and the
command's refusal without CUDA.

    python -m pytest port_bench/tests -q
"""

import json
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench.lib import peaks, spec, traffic, work
from port_bench.lib.trace import Trace, name_gaps, union

BIG_SEED = 2 ** 31 + 12345  # beyond 32 signed bits, as run seeds may be
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bucket(n: int, max_bucket: int = 64) -> int:
    """The engine's power-of-two bucket (``inference.roi_bucket``)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_bucket) if n <= max_bucket else -(-n // max_bucket) * max_bucket


@pytest.mark.parametrize("mix,images,rois,buckets", [
    ("coco32", 32, {124}, {128}), ("crowdhuman2", 2, {45}, {64})])
def test_traffic_counts_buckets_and_determinism(mix, images, rois, buckets):
    mixd = spec.load_json(spec.BENCH_DIR / "traffic" / f"{mix}.json")
    size = (24, 32)  # small images: the counts do not depend on the size
    pool = traffic.pool(mixd, size, BIG_SEED)
    again = traffic.pool(mixd, size, BIG_SEED)
    other = traffic.pool(mixd, size, BIG_SEED + 1)
    assert len(pool) == mixd["pool"]
    assert {r.rois.shape[0] for r in pool} == rois
    assert {_bucket(r.rois.shape[0]) for r in pool} == buckets
    spec_ = mixd["rois_per_image"]
    for r in pool:
        assert r.images.shape == (images, *size, 3) and r.images.dtype == np.float32
        assert 0.0 <= r.images.min() and r.images.max() < 1.0
        per_image = np.bincount(r.rois[:, 0].astype(int), minlength=images)
        assert per_image.min() >= spec_["min"] and per_image.max() <= spec_["cap"]
        assert (r.rois[:, 1:] >= 0).all() and (r.rois[:, 1:] <= 1).all()
        assert (r.rois[:, 3] > r.rois[:, 1]).all() and (r.rois[:, 4] > r.rois[:, 2]).all()
    for a, b in zip(pool, again):
        assert np.array_equal(a.images, b.images) and np.array_equal(a.rois, b.rois)
    assert not np.array_equal(pool[0].images, other[0].images)
    # every seed serves the same multiset of sizes, in its own order
    assert sorted(r.rois.shape[0] for r in pool) == sorted(r.rois.shape[0] for r in other)
    assert traffic.order(mixd, BIG_SEED) == traffic.order(mixd, BIG_SEED)
    assert sorted(traffic.order(mixd, BIG_SEED)) == list(range(mixd["pool"]))
    assert len(traffic.checked(mixd, BIG_SEED)) == min(mixd["pool"], mixd["check_requests"])


def test_coco_spread_keeps_its_total_and_cap():
    gen = np.random.default_rng(0)
    for _ in range(50):
        counts = traffic.spread(124, 32, {"min": 1, "cap": 20, "mean": 3.86}, gen)
        assert counts.sum() == 124 and counts.min() >= 1 and counts.max() <= 20
    with pytest.raises(ValueError):
        traffic.spread(700, 32, {"min": 1, "cap": 20, "mean": 3.86}, gen)


def _config(name):
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def test_work_count_b0_and_b7():
    """Operations of one image's stage 1 and one RoI's stage 2 on the
    reference, split by the configuration's int8 groups."""
    b0, b7 = work.count(_config("b0_480x640_int8")), work.count(_config("b7_ultra_480x640_int8"))
    # B0 stage 1 at 480x640: about 28 GFLOP an image by XLA's count of the JAX model
    assert 20e9 < sum(b0.image_ops.values()) < 36e9
    assert b0.image_ops["int8"] > 0 and b0.image_ops["bf16"] > 0  # decoder int8, encoder not
    assert sum(b7.image_ops.values()) > 3 * sum(b0.image_ops.values())
    # stage 2 at 4x the RoI area and the same head width (256)
    assert 3.5 * sum(b0.roi_ops.values()) < sum(b7.roi_ops.values()) < 4.5 * sum(b0.roi_ops.values())
    # about 60 GFLOP a RoI at mid 256 by XLA's count of the JAX model
    assert 50e9 < sum(b0.roi_ops.values()) < 70e9
    assert b0.roi_ops["int8"] > 0.9 * sum(b0.roi_ops.values())
    assert 20e6 < b0.weight_bytes < 60e6


@pytest.mark.parametrize("name", ["b0_480x640_int8", "b7_ultra_480x640_int8"])
def test_int8_rule_matches_the_engine(name):
    """The configuration's int8 rule (``int8_groups``, ``int8_min_contraction``),
    which the work count and the control read, names exactly the reference's
    convs that the built engine serves in int8: its QConvs that run int8
    under the configuration's deny list, and the seg head inside the s8
    tail. Convs the reference lacks (branches no output reads) are no
    useful work and are left out."""
    from human_instance_segmentation_tpu_torch.models.assembly import (
        HierarchicalInstanceSegmenter)
    from human_instance_segmentation_tpu_torch.ops.quant import QConv, set_int8_serving

    config = _config(name)
    ref_mod = work.reference_module(config)
    ref = ref_mod.build(config, "meta")
    convs = {n.replace(".", "/"): m.contraction for n, m in ref.named_modules()
             if isinstance(m, ref_mod.Conv)}
    groups, least = tuple(config["int8_groups"]), config["int8_min_contraction"]
    by_rule = {p for p, c in convs.items() if p.startswith(groups) and c >= least}

    with torch.device("meta"):
        model = HierarchicalInstanceSegmenter(**config["model"])
    set_int8_serving(model, config["engine"]["quantize"] == "int8", None,
                     config["engine"]["int8_deny"])
    served = {n.replace(".", "/") for n, m in model.named_modules()
              if isinstance(m, QConv) and m.runs_int8}
    unet = model.pretrained_unet
    last = getattr(unet, f"decoder{unet.n_decoders - 1}")
    if config["model"]["pallas_tail"] and last.conv0.runs_int8 and last.conv1.runs_int8:
        served.add("pretrained_unet/seg_head")  # the s8 tail (tail_q) quantizes its input
    assert set(convs) <= {n.replace(".", "/") for n, m in model.named_modules()
                          if isinstance(m, torch.nn.Conv2d)}
    assert by_rule == served & set(convs)


def test_padded_rois_are_not_counted():
    """The work of a request is linear in its real RoIs: the bucket's padding
    (124 real of 128) adds nothing."""
    w = work.count(_config("b0_480x640_int8"))
    ops = w.ops(32, 124)
    for kind in ops:
        assert ops[kind] == pytest.approx(32 * w.image_ops.get(kind, 0.0)
                                          + 124 * w.roi_ops.get(kind, 0.0))
    ref = work.reference_module(_config("b0_480x640_int8")).build(
        _config("b0_480x640_int8"), "meta")
    seen = []
    hook = ref.head.base_head.shared_in.conv.register_forward_hook(
        lambda m, a, out: seen.append(out.shape[0]))
    with torch.no_grad():
        ref.from_crops(torch.empty(3, 3, 64, 48, device="meta"),
                       torch.empty(3, 1, 64, 48, device="meta"))
    hook.remove()
    assert seen == [3]


def _trace():
    # two kernels overlapping on two streams, a copy, a memset; window 10 s
    kernels = [("k1", 1.0, 3.0), ("k2", 2.0, 4.0)]
    copies = [("Memcpy HtoD (Pageable -> Device)", 5.0, 6.0),
              ("Memcpy DtoH (Device -> Pageable)", 8.0, 8.5), ("Memset (Device)", 8.5, 9.0)]
    busy = union([(s, e) for _, s, e in kernels + copies])
    return Trace(10.0, sum(e - s for s, e in busy), kernels, copies,
                 name_gaps([(4.0, 5.0), (6.0, 8.0)], [("aten::copy_", 3.5, 5.5),
                                                      ("aten::to", 4.2, 4.8)]))


def test_busy_union_idle_and_gaps():
    tr = _trace()
    assert union([(1.0, 3.0), (2.0, 4.0), (5.0, 6.0)]) == [(1.0, 4.0), (5.0, 6.0)]
    assert tr.busy_s == pytest.approx(3.0 + 1.0 + 1.0)
    assert tr.gaps == [("aten::to", 1.0), ("host python", 2.0)]
    assert tr.top_gaps() == [["host python", 2.0], ["aten::to", 1.0]]
    assert tr.top_ops()[0] == ["k1", 2.0]
    ctx = SimpleNamespace(trace=tr, traced=[(32, 124), (32, 124)], work=None, window=None)
    read = lambda name: spec.reader("metrics", name)(ctx)  # noqa: E731
    assert read("device_idle_pct.batch") == pytest.approx(50.0)
    assert read("h2d_d2h_ms.batch") == pytest.approx(1.5 / 2 * 1e3)
    assert read("device_roofline.batch") is None  # nothing to read without the work count


def test_mfu_and_roofline_arithmetic():
    w = work.Work({"bf16": 989e9, "int8": 1979e9}, {"int8": 1979e8}, 0.0, (480, 640), (128, 96))
    # one image: 1 ms of bf16 + 1 ms of int8 at the peaks; one RoI 0.1 ms
    win = {"images": 10, "rois": 20, "seconds": 1.0}
    tr = Trace(1.0, 0.5)
    ctx = SimpleNamespace(trace=tr, traced=[(1, 2)], work=w, window=win)
    assert spec.reader("metrics", "step_mfu.batch")(ctx) == pytest.approx((10 * 2e-3 + 20 * 1e-4)
                                                                          * 100)
    least = peaks.bound(w.request_bytes(1, 2), w.ops(1, 2))
    assert least["bound_by"] == "operations"
    assert spec.reader("metrics", "device_roofline.batch")(ctx) == pytest.approx(
        (2e-3 + 2e-4) / 0.5 * 100)
    assert peaks.bound(3.35e12, {})["bound_s"] == pytest.approx(1.0)


def test_benchmark_json_keeps_its_form():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("port_bench/")
        assert c["source"] == _config(c["name"])["source"] and c["reduced"] == []
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell = spec.cell(w["name"], b)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e
            spec.reader("metrics", m["name"])
        for m in cell["end_to_end"]:
            spec.reader("endtoend", m["name"])
    assert len(json.dumps(b)) < 64 * 1024


def test_command_fails_without_cuda():
    """Without a CUDA device the command exits non-zero and prints no
    result line (on a card machine this would run the cell, so it skips)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown here")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "b0.batch32.coco",
                        "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not [line for line in p.stdout.splitlines() if line.startswith("{")]
    assert "CUDA" in p.stderr
