"""The second traced window's reduction (``lib/spans.py``) on synthetic
profiler events, the six readers of the port's spans and counters, and the
window itself served on the CPU at the tiny variant.

    python -m pytest port_bench/tests -q
"""

import time
from types import SimpleNamespace

import pytest

from port_bench.lib import spans, spec
from port_bench.lib.spans import Event, reduce
from port_bench.lib.trace import name_gaps, union

DATA = spec.BENCH_DIR / "tests" / "data"
SEED = 2 ** 31 + 77
READERS = ["stage1_ms.batch", "stage2_ms.batch", "unread_branches_ms.batch",
           "idle_engine_ms.batch", "idle_forward_ms.batch", "roi_useful_pct.batch"]


def _cpu(name, s, e, cid=0, annotation=False):
    return Event(name, "CPU", s, e, cid, annotation)


def _dev(name, s, e, cid=0, annotation=False):
    return Event(name, "CUDA", s, e, cid, annotation)


def _plain_events():
    """One request's device ops and host calls, no program span: a launch
    (runtime call, correlation id) a kernel or copy."""
    return [
        _cpu("aten::copy_", 0.0, 2.0), _cpu("cudaMemcpyAsync", 0.5, 1.9, 1),
        _dev("Memcpy HtoD (Pageable -> Device)", 1.0, 2.0, 1),
        _cpu("cudaLaunchKernel", 2.5, 2.6, 2), _dev("k_stage1", 3.0, 5.0, 2),
        _cpu("cuLaunchKernelEx", 5.2, 5.3, 3), _dev("k_stage2", 5.5, 8.0, 3),
        _cpu("cudaLaunchKernel", 5.4, 5.45, 4), _dev("k_unread", 8.0, 9.0, 4),
        _cpu("aten::copy_", 9.0, 11.0), _cpu("cudaMemcpyAsync", 9.1, 10.9, 5),
        _dev("Memcpy DtoH (Device -> Pageable)", 10.0, 11.0, 5),
    ]


def _program_spans():
    """The port's spans over the same request, on the host and (annotations)
    on the device."""
    host = [("engine.call", 0.0, 11.5), ("engine.upload", 0.2, 2.2),
            ("engine.forward", 2.3, 8.9), ("model.stage1", 2.4, 2.7),
            ("model.stage2", 5.1, 5.5), ("model.head.unread", 5.35, 5.5),
            ("engine.download", 8.95, 11.4)]
    out = [_cpu(spans.PREFIX + n, s, e, annotation=True) for n, s, e in host]
    out += [_dev(spans.PREFIX + "model.stage1", 3.0, 5.0, annotation=True),
            _dev(spans.PREFIX + "model.stage2", 5.5, 9.0, annotation=True),
            _dev(spans.PREFIX + "engine.call", 1.0, 11.0, annotation=True)]
    return out


def test_plain_trace_reduces_as_before():
    """Without program spans: busy time, ops and named gaps as
    ``trace.profile`` computes them from the same events."""
    events = _plain_events()
    sp = reduce(events, 12.0)
    busy = union([(e.start, e.end) for e in events if e.device == "CUDA"])
    assert sp.trace.busy_s == pytest.approx(sum(e - s for s, e in busy)) == pytest.approx(7.5)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    assert sp.trace.gaps == name_gaps(gaps, [(e.name, e.start, e.end) for e in events
                                             if e.device == "CPU"])
    assert [k[0] for k in sp.trace.kernels] == ["k_stage1", "k_stage2", "k_unread"]
    assert len(sp.trace.copies) == 2 and sp.requests == 0 and sp.annotations == 0
    assert sp.stage_s == {} and sp.busy_outside_s == pytest.approx(7.5)
    assert sp.idle_s == pytest.approx({"forward": 0.0, "engine": 0.0, "outside": 2.5})


def test_annotations_stay_out_of_busy_time_and_top_ops():
    plain = reduce(_plain_events(), 12.0)
    sp = reduce(_plain_events() + _program_spans(), 12.0)
    assert sp.annotations == 3
    assert sp.trace.busy_s == plain.trace.busy_s
    assert sp.trace.top_ops() == plain.trace.top_ops()
    assert not [n for n, _ in sp.trace.top_ops() if n.startswith(spans.PREFIX)]
    # without the profiler's flag, a program span's name sets the annotation apart
    bare = [Event(e.name, e.device, e.start, e.end, e.id) for e in _program_spans()]
    assert reduce(_plain_events() + bare, 12.0).trace.busy_s == plain.trace.busy_s


def test_stages_by_launch_and_idle_by_host_span():
    sp = reduce(_plain_events() + _program_spans(), 12.0)
    assert sp.requests == 1
    assert sp.stage_s["model.stage1"] == pytest.approx(2.0)
    assert sp.stage_s["model.stage2"] == pytest.approx(3.5)  # k_stage2 and k_unread
    assert sp.stage_s["model.head.unread"] == pytest.approx(1.0)
    assert sp.stage_s["engine.upload"] == pytest.approx(1.0)
    assert sp.stage_s["engine.download"] == pytest.approx(1.0)
    assert sp.stage_s["engine.call"] == pytest.approx(sp.trace.busy_s)
    assert sp.busy_outside_s == 0.0
    # gaps 2.0-3.0 and 5.0-5.5 (middles in engine.forward), 9.0-10.0 (in the download)
    assert sp.idle_s == pytest.approx({"forward": 1.5, "engine": 1.0, "outside": 0.0})


def test_annotation_ranges_where_no_launch_is_found():
    """Without runtime calls, the device annotation ranges on the one stream
    attribute each op."""
    events = [e for e in _plain_events() + _program_spans() if not e.name.startswith("cu")]
    sp = reduce(events, 12.0)
    assert sp.stage_s["model.stage1"] == pytest.approx(2.0)
    assert sp.stage_s["model.stage2"] == pytest.approx(3.5)
    assert "model.head.unread" not in sp.stage_s  # no device range of its own here


def test_readers_arithmetic():
    sp = reduce(_plain_events() + _program_spans(), 12.0)
    sp.requests = 2  # per request: halves
    sp.counters = [{"rois": 124, "rois_computed": 128}, {"rois": 45, "rois_computed": 64}]
    ctx = SimpleNamespace(spans=sp)
    got = {name: spec.reader("metrics", name)(ctx) for name in READERS}
    assert got == pytest.approx({
        "stage1_ms.batch": 1e3, "stage2_ms.batch": 1.75e3, "unread_branches_ms.batch": 0.5e3,
        "idle_engine_ms.batch": 0.5e3, "idle_forward_ms.batch": 0.75e3,
        "roi_useful_pct.batch": 100.0 * 169 / 192})
    assert spec.reader("metrics", "roi_useful_pct.batch")(
        SimpleNamespace(spans=SimpleNamespace(counters=[{"rois": 124, "rois_computed": 128}]
                                              * 4))) == 96.875


def test_readers_find_nothing_without_a_second_window():
    """Off the command line (or on a program without spans) every reader
    returns None and raises nothing."""
    ctx = SimpleNamespace(trace=None, traced=None, window=None, work=None)
    assert [spec.reader("metrics", name)(ctx) for name in READERS] == [None] * 6
    assert spans.served(SimpleNamespace(trace=object(), traced=[(1, 1)],
                                        window={"next": 0})) is None


def test_prefix_is_the_ports():
    from human_instance_segmentation_tpu_torch import tracing

    assert spans.PREFIX == tracing.PREFIX


def test_second_window_serves_the_tiny_cell_with_spans():
    cell = {"workload": {"name": "tiny", "chips": 1},
            "config": spec.load_json(DATA / "tiny_config.json"),
            "traffic": spec.load_json(DATA / "tiny_traffic.json")}
    t0 = time.perf_counter()
    sp = spans.second_window(cell, SEED, 1, "cpu")
    n = cell["traffic"]["trace_requests"]
    assert sp.requests == n == len(sp.counters)
    assert 0 < sp.trace.window_s < time.perf_counter() - t0
    assert [c["rois"] for c in sp.counters] == [cell["traffic"]["rois"]] * n
    assert [c["rois_computed"] for c in sp.counters] == [8] * n
    assert all(c["operand_builds"] == 0 and c["int8_calls"] > 0 for c in sp.counters)
    assert sp.trace.busy_s == 0.0 and sp.annotations == 0  # no device on the CPU
