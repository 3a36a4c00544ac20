"""The engine's CUDA graphs (``InferenceEngine.__call__``): each request
shape served eagerly at its first call, captured at its second and replayed
after; the instance's ``forward`` captured, as an eager call finds it (so
the benchmark's planted faults reach the replays); eager on the CPU, under
a mesh and with tracing on; every graph dropped when the scales change; a
shape whose capture fails, or whose capture would skip a hook, eager from
then on; the model's forward hooks called after a replay on a copy of its
output.

On the CPU no engine captures. The bookkeeping is held there against a
stand-in for ``torch.cuda``'s graph API (:class:`_Recorder`): a "capture"
runs the engine's forward and keeps its outputs, a "replay" runs
``engine.forward`` again on the static inputs and writes the results into
those outputs, as a replayed graph does. The constants the forward used to copy from the host at every
call (the UNet's normalisation, ``person_prob``'s probe) are held to the
``torch.tensor`` values they replace, and a tiny flagship served call after
call to the JAX engine. The tests marked ``cuda`` skip without a card; run
them there (at each benchmark cell's request shape) with

    python -m pytest --noconftest tests/test_torch_graph.py -q -m cuda
"""

import contextlib
import copy
import json
import logging
import sys
from collections import OrderedDict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu_torch import inference, tracing
from human_instance_segmentation_tpu_torch.inference import (InferenceEngine, create_flagship,
                                                             pad_rois, roi_bucket)
from human_instance_segmentation_tpu_torch.models.unet import kept_constant
from human_instance_segmentation_tpu_torch.ops import quant

REPO = Path(__file__).resolve().parents[1]
TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32)
FLAGSHIP = dict(variant="tiny", seed=0, pallas_tail=True, encoder_fused_blocks=2,
                use_contour_detection=True, use_distance_transform=True)
COUNTERS = ("graph_captures", "graph_replays", "graph_fallbacks")
# the benchmark's cells: configuration, images and RoIs a request
CELLS = {"b0.batch32.coco": ("b0_480x640_int8", 32, 124),
         "b7.crowdhuman2": ("b7_ultra_480x640_int8", 2, 45),
         "b1.batch8.coco": ("b1_enhanced_480x640_int8", 8, 31)}


def _request(n_rois: int = 3, batch: int = 2, size=(64, 96), seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.random((batch, *size, 3), dtype=np.float32)
    lo = rng.uniform(0.0, 0.4, (n_rois, 2))
    rois = np.concatenate([np.arange(n_rois)[:, None] % batch, lo, lo + 0.5], axis=1)
    return images, rois.astype(np.float32)


def _direct(engine, images, rois, forward=None):
    """The request through ``engine.forward`` (always eager; ``forward`` in
    its place where given): tensors made with ``torch.as_tensor(...).to(...)``,
    outputs read back with ``.cpu()``."""
    n = rois.shape[0]
    bucket = roi_bucket(max(n, 1), max_bucket=engine.max_bucket)
    images_t = torch.as_tensor(images).to(engine.device, engine.dtype)
    rois_t = torch.as_tensor(pad_rois(rois, bucket)).to(engine.device)
    inst, binary, _ = (forward or engine.forward)(images_t, rois_t)
    return inst[:n].float().cpu().numpy(), binary.float().cpu().numpy()


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _counters(engine):
    return tuple(getattr(engine, c) for c in COUNTERS)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops: intra-op threads only contend with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return create_flagship(device="cpu", **FLAGSHIP, **TINY)


def _engine(model, device="cpu"):
    return InferenceEngine(model, device=device, dilation_pixels=1, dtype=torch.bfloat16,
                           fused_head=True, quantize="int8")


# --------------------------------------------------------------------- CPU


def test_cpu_engine_never_captures(model):
    """A CPU engine serves every call eagerly: no graph is kept and the
    three counters stay 0, whatever the shape and however often it comes;
    every call equals ``forward``."""
    engine = _engine(model)
    for seed, n in ((0, 3), (1, 3), (2, 3), (3, 5), (4, 5), (5, 3)):
        images, rois = _request(n, seed=seed)
        _assert_same(engine(images, rois), _direct(engine, images, rois))
    assert _counters(engine) == (0, 0, 0)
    assert not engine._graphs and engine._pool is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=["f32", "bf16", "f64"])
def test_kept_constants_equal_the_tensors_they_replace(model, dtype):
    """The UNet's mean and std and ``person_prob``'s probe, kept once per
    dtype and device, equal ``torch.tensor`` of the same values bit for bit
    (bf16 and float64 too), are made once (the next forward gets the same
    tensor) and are no inference tensors, though first asked for inside
    ``torch.inference_mode``."""
    model = copy.deepcopy(model).to(dtype)
    with torch.no_grad():  # a trained-looking wrapper, bias included
        model.unet_wrapper.output_conv.weight.copy_(torch.tensor([0.9, -0.4]).reshape(2, 1, 1, 1))
        model.unet_wrapper.output_conv.bias.copy_(torch.tensor([0.3, -0.2]))
    unet = model.pretrained_unet
    x = torch.rand((1, 3, 8, 8), dtype=torch.float32).to(dtype)
    with torch.inference_mode():
        got = unet.normalize(x)
        prob = model.person_prob(x[:, 0])
    mean = torch.tensor(unet.normalize_mean, dtype=dtype)
    std = torch.tensor(unet.normalize_std, dtype=dtype)
    assert torch.equal(got, (x - mean[:, None, None]) / std[:, None, None])
    kept = unet._kept
    assert torch.equal(kept[("mean", dtype, x.device)], mean)
    assert torch.equal(kept[("std", dtype, x.device)], std)
    probe = model._kept[("probe", dtype, x.device)]
    old_probe = torch.tensor([0.0, 1.0], dtype=dtype).reshape(2, 1, 1, 1)
    assert torch.equal(probe, old_probe) and probe.shape == old_probe.shape
    assert not any(t.is_inference() for t in (*kept.values(), probe))
    with torch.no_grad():  # person_prob on the probe it made before
        w = model.unet_wrapper(old_probe)
        bias = w[0, :, 0, 0]
        wvec = w[1, :, 0, 0] - bias
        want = torch.sigmoid(x[:, 0] * (wvec[0] - wvec[1]) + (bias[0] - bias[1]))
    assert torch.equal(prob, want)
    before = dict(kept)
    unet.normalize(x)
    assert all(kept[k] is before[k] for k in before)


def test_kept_constant_keeps_nothing_while_tracing(monkeypatch):
    """Under ``torch.export`` / ``torch.compile`` tracing the constant is
    made and handed over, not kept."""
    kept = {}
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    t = kept_constant(kept, "c", [1.5, 2.5], torch.zeros(1))
    assert torch.equal(t, torch.tensor([1.5, 2.5])) and not kept


def test_served_calls_match_the_jax_engine():
    """The tiny flagship (fused head) served on the CPU call after call, the
    same request three times and a second shape twice, against the JAX
    engine on the same weights under ``test_torch_flagship``'s gates: the
    logit-derived binary masks within 1e-5, instance agreement >= 0.999."""
    import jax
    import jax.numpy as jnp

    from helpers import fast_init
    from human_instance_segmentation_tpu.inference import InferenceEngine as JaxEngine
    from human_instance_segmentation_tpu.models.assembly import (
        HierarchicalInstanceSegmenter as JaxSegmenter)
    from human_instance_segmentation_tpu_torch.weights import load_jax_params

    tiny = dict(TINY, base_channels=64)
    jmodel = JaxSegmenter(encoder_variant="tiny", **tiny)
    variables = fast_init(jmodel, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 5)), train=False,
                          seed=3)
    port = create_flagship(variant="tiny", device="cpu", seed=0, **tiny)
    load_jax_params(port, jax.tree.map(np.asarray, variables))
    engine = InferenceEngine(port, device="cpu", dilation_pixels=1, fused_head=True)
    jengine = JaxEngine(jmodel, variables, dilation_pixels=1, fused_head=True)
    want = {}
    for seed, n in ((7, 3), (8, 5)):
        with jax.default_matmul_precision("highest"):
            want[seed] = jengine(*_request(n, seed=seed))
    for seed, n in ((7, 3), (7, 3), (7, 3), (8, 5), (8, 5)):
        images, rois = _request(n, seed=seed)
        jinst, jbinary = want[seed]
        inst, binary = engine(images, rois)
        assert inst.shape == (n, 32, 24, 1) and binary.shape == (2, 64, 96, 1)
        np.testing.assert_allclose(binary, np.asarray(jbinary), atol=1e-5)
        assert float((inst == np.asarray(jinst)).mean()) >= 0.999
    assert _counters(engine) == (0, 0, 0)


class _Recorder:
    """``torch.cuda``'s graph API on the CPU, for the engine's bookkeeping:
    inside :meth:`graph` the engine's forward runs as usual, and the class's
    ``forward`` notes what the capture ran: itself, or the instance's own
    ``forward`` that called it. A replay runs that again on the shape's
    static inputs, the model's own forward hooks held back, and copies the
    results into the captured outputs and the model's output, as a replayed
    graph writes its own. ``fail`` makes the next capture raise, as an op a
    graph cannot hold does; ``build`` makes it build a kept operand."""

    def __init__(self, monkeypatch):
        self.capturing = None
        self.fail = self.build = False
        self.forwards = 0  # the class's forward calls, captures and replays included
        real = InferenceEngine.forward
        recorder = self

        class Graph:
            def __init__(self):
                self.engine = self.run = None

            def replay(self):
                engine = self.engine
                entry = next(g for g in engine._graphs.values() if g and g.graph is self)
                model, held = engine.model, {}
                hooks = model._forward_hooks
                model._forward_hooks = OrderedDict(
                    [(-1, lambda m, args, out: held.__setitem__("out", out))])
                try:  # no Python of the forward runs in a replay: no hook either
                    with torch.inference_mode():
                        again = self.run(entry.images, entry.rois)
                        for kept, new in zip(_tensors((entry.out, entry.model_out)),
                                             _tensors((again, held["out"]))):
                            kept.copy_(new)
                finally:
                    model._forward_hooks = hooks

        def forward(engine, images, rois):
            recorder.forwards += 1
            graph = recorder.capturing
            if graph is not None and graph.engine is None:
                own = vars(engine).get("forward")
                called_by_own = getattr(own, "__code__", None) is sys._getframe(1).f_code
                graph.engine = engine
                graph.run = own if called_by_own else (lambda i, r: forward(engine, i, r))
                if recorder.fail:
                    raise RuntimeError("operation not permitted when stream is capturing")
                if recorder.build:
                    quant.QConv.operand_builds += 1
            return real(engine, images, rois)

        @contextlib.contextmanager
        def graph(g, pool=None):
            self.capturing = g
            try:
                yield
            finally:
                self.capturing = None

        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "graph", graph)
        monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
        self.stream = SimpleNamespace(device_index=0)
        self.streams = []  # streams set back after a failed capture
        self.ended = []  # pools whose recording a failed capture's clean-up ended
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: self.stream)
        monkeypatch.setattr(torch.cuda, "set_stream", self.streams.append)
        monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool",
                            lambda device, pool: self.ended.append(pool), raising=False)
        monkeypatch.setattr(InferenceEngine, "forward", forward)
        monkeypatch.setattr(InferenceEngine, "_graphs_on", lambda e: not tracing.enabled())


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


@pytest.fixture()
def recorder(monkeypatch):
    return _Recorder(monkeypatch)


def test_second_call_captures_and_later_calls_replay(model, recorder):
    """Per shape: the first call eager, the second captures (1 capture, no
    replay), every later one replays (1 replay each, no capture); a new
    shape captures anew. Each call's arrays equal ``forward``'s on its own
    request and stay the caller's own across later calls."""
    engine = _engine(model)
    engine.calibrate(*_request(3))
    seen, kept = [], []
    for seed, n in ((1, 3), (2, 3), (3, 3), (4, 3), (5, 5), (6, 5), (7, 5), (8, 3)):
        images, rois = _request(n, seed=seed)
        got = engine(images, rois)
        kept.append((got, [a.copy() for a in got]))
        _assert_same(got, _direct(engine, images, rois))
        seen.append(_counters(engine))
    assert seen == [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 2, 0),
                    (1, 2, 0), (2, 2, 0), (2, 3, 0), (2, 4, 0)]
    for got, copies in kept:
        _assert_same(got, copies)
    assert len(engine._graphs) == 2 and engine.graph_fallbacks == 0


def test_replays_run_one_forward_a_call(model, recorder):
    """A replayed call runs the graph once and no eager forward."""
    engine = _engine(model)
    engine.calibrate(*_request(3))
    for seed in range(3):
        engine(*_request(3, seed=seed))
    before = recorder.forwards
    engine(*_request(3, seed=9))
    assert recorder.forwards == before + 1 and engine.graph_replays == 2


def test_every_shape_keeps_its_graph(model, recorder):
    """No shape pushes another out: six shapes (RoI buckets and batch
    sizes) captured in turn all replay when they come again."""
    engine = _engine(model)
    engine.calibrate(*_request(3))
    shapes = [(1, 2), (2, 2), (3, 2), (5, 2), (9, 2), (3, 3)]
    for n, b in shapes:
        for _ in range(2):
            engine(*_request(n, batch=b))
    assert _counters(engine) == (6, 0, 0)
    for n, b in shapes:
        images, rois = _request(n, batch=b, seed=4)
        _assert_same(engine(images, rois), _direct(engine, images, rois))
    assert _counters(engine) == (6, 6, 0) and len(engine._graphs) == 6


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
def test_planted_faults_reach_the_replays(model, recorder, monkeypatch, fault):
    """The benchmark's faults (``port_bench/lib/faults.py``) replace the
    engine's ``forward`` on the instance; the graph captures that one, so
    every replayed call returns the broken answer an eager call gives, not
    the served model's."""
    from port_bench.lib import faults

    engine = _engine(model)
    engine.calibrate(*_request(3))
    monkeypatch.setattr(faults, "port_system", lambda *args: engine)
    broken = faults.FAULTS[fault](None, None, None, "cpu")
    assert broken is engine and "forward" in vars(engine)
    unbroken = InferenceEngine.forward.__get__(engine)
    for seed in range(5):
        images, rois = _request(3, seed=seed)
        got = engine(images, rois)
        _assert_same(got, _direct(engine, images, rois))
        want = _direct(engine, images, rois, unbroken)
        assert any(not np.array_equal(g, w) for g, w in zip(got, want))
    assert _counters(engine) == (1, 3, 0)


@pytest.mark.parametrize("where", ["submodule", "pre_hook", "global"])
def test_hooks_a_replay_would_skip_keep_the_shape_eager(model, recorder, caplog, where):
    """Python that would run inside the model's forward, which a replay
    skips (a submodule's forward hook, a forward pre-hook, a global module
    hook), leaves the shape eager at its capture point: logged once,
    counted as a fallback, the hook called at every call. Once it is gone,
    setting the scales lets the shape capture again."""
    engine = _engine(model)
    images, rois = _request(3)
    engine.calibrate(images, rois)
    seen = []
    if where == "submodule":
        handle = engine.model.rgb_extractor.register_forward_hook(
            lambda m, args, out: seen.append(1))
    elif where == "pre_hook":
        handle = engine.model.register_forward_pre_hook(lambda m, args: seen.append(1))
    else:
        handle = torch.nn.modules.module.register_module_forward_hook(
            lambda m, args, out: seen.append(1) if m is engine.model else None)
    try:
        with caplog.at_level(logging.WARNING, logger=inference.__name__):
            for _ in range(4):
                _assert_same(engine(images, rois), _direct(engine, images, rois))
    finally:
        handle.remove()
    assert _counters(engine) == (0, 0, 1) and len(seen) == 8
    assert len([r for r in caplog.records if "serves eagerly" in r.getMessage()]) == 1
    engine(images, rois)
    assert _counters(engine) == (0, 0, 1)
    engine.scales = engine.scales
    for _ in range(3):
        engine(images, rois)
    assert _counters(engine) == (1, 1, 1)


@pytest.mark.parametrize("change", ["scales", "calibrate"])
def test_new_scales_drop_every_graph(model, recorder, change):
    """Setting ``scales`` or calling ``calibrate`` drops every graph (and
    the pool): the next call of a shape serves eagerly, the one after
    captures again, on the new scales."""
    engine = _engine(model)
    images, rois = _request(3)
    engine.calibrate(images, rois)
    for _ in range(3):
        engine(images, rois)
    assert _counters(engine) == (1, 1, 0) and engine._pool is not None
    if change == "scales":
        engine.scales = {k: 2.0 * v for k, v in engine.scales.items()}
    else:
        engine.calibrate(*_request(3, seed=11))
    assert not engine._graphs and engine._pool is None
    got = engine(images, rois)
    assert _counters(engine) == (1, 1, 0)
    _assert_same(got, _direct(engine, images, rois))
    engine(images, rois)
    assert _counters(engine) == (2, 1, 0)


def test_tracing_serves_eagerly(model, recorder):
    """Under ``tracing.recording()`` a shape that has a graph serves
    eagerly: the counters stay, and the call's spans and launch counters
    are those of an engine that never captured."""
    engine, fresh = _engine(model), _engine(model)
    images, rois = _request(3)
    for e in (engine, fresh):
        e.calibrate(images, rois)
    for _ in range(3):
        engine(images, rois)
    fresh(images, rois)
    counted = _counters(engine)
    records = {}
    for name, e in (("graphed", engine), ("fresh", fresh)):
        with tracing.recording() as records[name]:
            got = e(images, rois)
        _assert_same(got, _direct(e, images, rois))
    assert _counters(engine) == counted
    names = {k: [r["name"] for r in v] for k, v in records.items()}
    assert names["graphed"] == names["fresh"] and "hiseg.engine.forward" in names["fresh"]
    counters = {k: v[0]["counters"] for k, v in records.items()}
    assert counters["graphed"] == counters["fresh"]


def test_failed_capture_serves_eagerly_from_then_on(model, recorder, caplog):
    """A capture that raises (an op a graph cannot hold) serves that call
    eagerly, is logged once and counted, and the shape stays eager: its
    later calls capture nothing. The caller's stream is set back, the
    allocator's recording into the pool ended and the pool left behind;
    other shapes still capture, into a new pool."""
    engine = _engine(model)
    images, rois = _request(3)
    engine.calibrate(images, rois)
    engine(images, rois)
    recorder.fail = True
    with caplog.at_level(logging.WARNING, logger=inference.__name__):
        got = engine(images, rois)
    recorder.fail = False
    _assert_same(got, _direct(engine, images, rois))
    assert _counters(engine) == (0, 0, 1)
    assert recorder.streams == [recorder.stream] and len(recorder.ended) == 1
    assert engine._pool is None
    assert len([r for r in caplog.records if "capture" in r.getMessage()]) == 1
    for _ in range(2):
        engine(images, rois)
    assert _counters(engine) == (0, 0, 1)
    other = _request(5)
    for _ in range(3):
        engine(*other)
    assert _counters(engine) == (1, 1, 1)
    assert engine._pool is not None and engine._pool is not recorder.ended[0]


def test_operand_built_during_capture_raises(model, recorder):
    """A kept operand built while a graph is captured raises: the shape's
    eager call should have built it, and one built in a capture holds
    values the capture never computed."""
    engine = _engine(model)
    images, rois = _request(3)
    engine.calibrate(images, rois)
    engine(images, rois)
    recorder.build = True
    with pytest.raises(RuntimeError, match="built kept operands"):
        engine(images, rois)


def test_forward_hooks_see_each_call_once_on_a_copy(model, recorder):
    """The served model's forward hooks run once a call, never inside a
    capture, and after a replay on a copy of the model's output: each call
    hands them tensors of their own, equal to that call's eager logits."""
    engine = _engine(model)
    engine.calibrate(*_request(3))
    seen = []
    handle = engine.model.register_forward_hook(
        lambda m, args, out: seen.append((recorder.capturing is None, out[0])))
    logits = []
    for seed in range(4):
        images, rois = _request(3, seed=seed)
        engine(images, rois)
        bucket = roi_bucket(3, max_bucket=engine.max_bucket)
        _, _, want = engine.forward(torch.as_tensor(images).to(engine.dtype),
                                    torch.as_tensor(pad_rois(rois, bucket)))
        logits.append(want)
        seen.pop()  # the hook's call from the eager forward just made
    handle.remove()
    assert len(seen) == 4 and all(outside for outside, _ in seen)
    assert _counters(engine) == (1, 2, 0)
    for (_, got), want in zip(seen, logits):
        assert torch.equal(got, want)
    ptrs = {t.data_ptr() for _, t in seen}
    assert len(ptrs) == 4


# -------------------------------------------------------------------- card


def _cell_engine(cell: str):
    """The cell's configuration (model and engine keywords of
    ``port_bench/configs``) on the card with seed-7 weights, calibrated on a
    seed-7 request of the cell's shape; that request and a second one."""
    config, batch, n = CELLS[cell]
    cfg = json.loads((REPO / "port_bench" / "configs" / f"{config}.json").read_text())
    kw = dict(cfg["model"])
    variant = kw.pop("encoder_variant")
    for key in ("roi_size", "mask_size", "image_size"):
        kw[key] = tuple(kw[key])
    model = create_flagship(variant=variant, seed=7, device="cuda", **kw)
    e = dict(cfg["engine"])
    e["dtype"] = getattr(torch, e["dtype"])
    engine = InferenceEngine(model, **e)
    size = kw["image_size"]
    requests = [_request(n, batch=batch, size=size, seed=s) for s in (7, 8)]
    engine.calibrate(*requests[0])
    return engine, requests


@pytest.fixture(scope="module", params=list(CELLS))
def cell(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    engine, requests = _cell_engine(request.param)
    yield engine, requests
    del engine
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_replays_equal_the_eager_forward_on_the_card(cell):
    """At each cell's request shape: calls 1-5 (two requests in turn) equal
    the eager ``forward`` bit for bit, 1 capture at the second call and 1
    replay at each later one, no fallback; a new shape (half the RoIs, its
    own bucket) captures anew."""
    engine, (first, second) = cell
    start = _counters(engine)
    seen = []
    for images, rois in (first, second, first, second, first):
        got = engine(images, rois)
        _assert_same(got, _direct(engine, images, rois))
        seen.append(tuple(a - b for a, b in zip(_counters(engine), start)))
    assert seen == [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 2, 0), (1, 3, 0)]
    images, rois = first
    half = rois[: max(1, rois.shape[0] // 2)]
    assert roi_bucket(half.shape[0], max_bucket=engine.max_bucket) != roi_bucket(
        rois.shape[0], max_bucket=engine.max_bucket)
    for _ in range(3):
        got = engine(images, half)
    _assert_same(got, _direct(engine, images, half))
    assert tuple(a - b for a, b in zip(_counters(engine), start)) == (2, 4, 0)


@pytest.mark.cuda
def test_new_scales_drop_the_graphs_on_the_card(cell):
    """Setting the scales, or calibrating, drops every graph: the next call
    serves eagerly and equals ``forward`` on the new scales, the one after
    captures again and also equals it."""
    engine, (first, second) = cell
    for _ in range(2):
        engine(*first)
    for change in ("scales", "calibrate"):
        if change == "scales":
            engine.scales = dict(engine.scales)
        else:
            engine.calibrate(*second)
        assert not engine._graphs
        before = _counters(engine)
        for step in range(3):
            got = engine(*first)
            _assert_same(got, _direct(engine, *first))
            captures = _counters(engine)[0] - before[0]
            assert captures == (0, 1, 1)[step]
    assert engine.graph_fallbacks == 0


@pytest.mark.cuda
def test_tracing_serves_eagerly_on_the_card(cell):
    """Under ``tracing.recording()`` a graphed shape serves eagerly: the
    counters stay; the request's spans and its ``launches.*`` counters
    equal those of an eager call of the same request on an engine with the
    same scales that never captured, and its arrays equal them."""
    engine, (first, _) = cell
    for _ in range(3):
        engine(*first)
    counted = _counters(engine)
    twin = InferenceEngine(engine.model, dilation_pixels=engine.dilation_pixels,
                           max_bucket=engine.max_bucket, dtype=engine.dtype,
                           fused_head=engine.fused_head, quantize=engine.quantize,
                           int8_deny=engine.int8_deny)
    twin.scales = engine.scales
    twin(*first)
    records, out = {}, {}
    for name, e in (("graphed", engine), ("eager", twin)):
        with tracing.recording() as records[name]:
            out[name] = e(*first)
    assert _counters(engine) == counted and _counters(twin) == (0, 0, 0)
    _assert_same(out["graphed"], out["eager"])
    names = {k: [r["name"] for r in v] for k, v in records.items()}
    assert names["graphed"] == names["eager"]
    counters = {k: {c: n for c, n in v[0]["counters"].items() if c.startswith("launches.")}
                for k, v in records.items()}
    assert counters["graphed"] == counters["eager"] and any(counters["eager"].values())
    del twin


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
def test_planted_faults_reach_the_replays_on_the_card(cell, monkeypatch, fault):
    """Each fault of ``port_bench/lib/faults.py`` applied to the cell's
    engine (the factory's own code, on the engine this file built): the
    graph captures the broken ``forward``, so the third and later calls,
    replays, return the broken answer bit for bit and differ from the
    served model's."""
    from port_bench.lib import faults

    engine, (first, second) = cell
    monkeypatch.setattr(faults, "port_system", lambda *args: engine)
    engine.scales = engine.scales  # no graph of the unbroken forward is left
    start = _counters(engine)
    broken = faults.FAULTS[fault](None, None, None, "cuda")
    unbroken = InferenceEngine.forward.__get__(engine)
    try:
        for step, (images, rois) in enumerate((first, second, first, second, first)):
            got = engine(images, rois)
            _assert_same(got, _direct(engine, images, rois))
            if step >= 2:
                want = _direct(engine, images, rois, unbroken)
                assert any(not np.array_equal(g, w) for g, w in zip(got, want))
        assert tuple(a - b for a, b in zip(_counters(engine), start)) == (1, 3, 0)
    finally:
        del broken.forward
        engine.scales = engine.scales


@pytest.mark.cuda
def test_failed_capture_serves_eagerly_on_the_card():
    """A ``forward`` that reads a value back to the host cannot be
    captured: the capture fails, that call and every later call of the
    shape serve eagerly and equal ``forward``, and the engine keeps serving
    other shapes from graphs. A forward hook on a submodule leaves its
    shape eager before any capture and is called at every call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    engine = _engine(create_flagship(device="cuda", **FLAGSHIP, **TINY), device="cuda")
    images, rois = _request(3)
    engine.calibrate(images, rois)
    served, read = engine.forward, []

    def reading(images_t, rois_t):
        out = served(images_t, rois_t)
        read.append(float(out[0].float().abs().max()))
        return out

    engine.forward = reading
    for _ in range(3):
        got = engine(images, rois)
        _assert_same(got, _direct(engine, images, rois))
    assert _counters(engine) == (0, 0, 1) and len(read) >= 6  # each call's forward and _direct
    del engine.forward
    other = _request(5)
    for _ in range(3):
        got = engine(*other)
    _assert_same(got, _direct(engine, *other))
    assert _counters(engine) == (1, 1, 1)
    seen = []
    handle = engine.model.rgb_extractor.register_forward_hook(lambda m, a, o: seen.append(1))
    third = _request(9)
    for _ in range(3):
        got = engine(*third)
    handle.remove()
    _assert_same(got, _direct(engine, *third))
    assert _counters(engine) == (1, 1, 2) and len(seen) == 3
