"""The engine's host staging (``InferenceEngine._stage`` / ``_download``):
each request's images and RoIs cast into a staging tensor kept for their
shape and sent without blocking, the outputs copied without blocking into
new host tensors, page-locked on a CUDA device.

Every engine serves through the staging tensors (page-locking only on a
CUDA device). On the tiny int8 flagship, ``__call__`` is held bit for bit
against ``forward`` on the same request, its tensors made and read back
directly. The tests marked ``cuda`` skip without a card; run them there
with

    python -m pytest --noconftest tests/test_torch_host_transfer.py -q
"""

import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu_torch import tracing
from human_instance_segmentation_tpu_torch.inference import (InferenceEngine, create_flagship,
                                                             pad_rois, roi_bucket)

TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32)
FLAGSHIP = dict(variant="tiny", seed=0, pallas_tail=True, encoder_fused_blocks=6,
                use_contour_detection=True, use_distance_transform=True)


def _request(n_rois: int, batch: int = 2, size=(64, 96), seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.random((batch, *size, 3), dtype=np.float32)
    lo = rng.uniform(0.0, 0.4, (n_rois, 2))
    rois = np.concatenate([np.arange(n_rois)[:, None] % batch, lo, lo + 0.5], axis=1)
    return images, rois.astype(np.float32)


def _engine(device: str, dtype: torch.dtype, **model) -> InferenceEngine:
    """A tiny int8 flagship engine, calibrated on its first request."""
    kwargs = {**FLAGSHIP, **TINY, **model}
    eng = InferenceEngine(create_flagship(device=device, **kwargs), device=device,
                          dilation_pixels=1, dtype=dtype, fused_head=True, quantize="int8")
    eng.calibrate(*_request(3, size=kwargs["image_size"]))
    return eng


def _direct(engine, images, rois):
    """The request through ``forward``: its tensors made on the device with
    ``torch.as_tensor(...).to(...)`` and the outputs read back with
    ``.cpu()``, no staging tensor and nothing page-locked."""
    n = rois.shape[0]
    bucket = roi_bucket(max(n, 1), max_bucket=engine.max_bucket)
    images_t = torch.as_tensor(np.asarray(images, np.float32)).to(engine.device, engine.dtype)
    rois_t = torch.as_tensor(pad_rois(np.asarray(rois, np.float32), bucket)).to(engine.device)
    inst, binary, _ = engine.forward(images_t, rois_t)
    return inst[:n].float().cpu().numpy(), binary.float().cpu().numpy()


def _direct_nchw(engine, images, rois):
    """:func:`_direct` behind ``predict_nchw``'s transposes."""
    inst, binary = _direct(engine, np.transpose(images, (0, 2, 3, 1)), rois)
    return np.transpose(inst, (0, 3, 1, 2)), np.transpose(binary, (0, 3, 1, 2))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert g.flags["C_CONTIGUOUS"] == w.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops: intra-op threads only contend with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def engine(request):
    return _engine("cpu", request.param)


@pytest.mark.parametrize("n_rois", [3, 4], ids=["n_below_bucket", "n_at_bucket"])
def test_staged_outputs_equal_the_direct_path(engine, n_rois):
    images, rois = _request(n_rois, seed=n_rois)
    direct = _direct(engine, images, rois)
    staged = engine(images, rois)
    assert staged[0].shape[0] == n_rois and staged[1].shape[0] == 2
    _assert_same(staged, direct)


def test_staged_nchw_entry_keeps_the_layout(engine):
    """``predict_nchw`` hands the engine transposed (strided) images: the
    staging tensor takes their layout, as a direct upload does."""
    images, rois = _request(3, seed=5)
    nchw = np.ascontiguousarray(np.transpose(images, (0, 3, 1, 2)))
    direct = _direct_nchw(engine, nchw, rois)
    staged = engine.predict_nchw(nchw, rois)
    _assert_same(staged, direct)
    strided = torch.from_numpy(np.transpose(nchw, (0, 2, 3, 1))).stride()
    assert any(stride == strided for _, stride, _ in engine._staging)
    assert all(t.stride() == stride for (_, stride, _), t in engine._staging.items())


def test_staged_arrays_outlive_the_next_call(engine):
    first = engine(*_request(3, seed=1))
    kept = [a.copy() for a in first]
    second = engine(*_request(3, seed=2))
    assert not np.array_equal(second[1], kept[1])  # the staging tensor was refilled
    _assert_same(first, kept)


def test_staging_builds_once_a_shape(engine):
    """Each request shape builds its staging tensors once: images and RoIs
    at the first request, nothing when the shape repeats, one tensor for a
    new RoI bucket and one for a new image batch."""
    engine._staging.clear()
    requests = [_request(3), _request(3, seed=1), _request(5), _request(5, batch=3)]
    with tracing.recording() as records:
        for images, rois in requests:
            engine(images, rois)
    calls = [r["counters"] for r in records if r["parent"] is None]
    assert [c["staging_builds"] for c in calls] == [2, 0, 1, 1]
    assert [c["pinned_bytes"] for c in calls] == [0] * 4  # nothing page-locked on the CPU
    assert len(engine._staging) == 4


def test_cpu_engine_serves_the_direct_path(engine):
    """A CPU engine's direct path is the CUDA engine's path without the
    page-locking: the same staging tensors (the images' and the RoIs', built
    at its first request), nothing pinned."""
    engine._staging.clear()
    with tracing.recording() as records:
        engine(*_request(3))
    c = records[0]["counters"]
    assert (c["staging_builds"], c["pinned_bytes"]) == (2, 0)
    assert c["h2d_bytes"] > 0 and c["d2h_bytes"] > 0
    assert len(engine._staging) == 2
    assert not any(t.is_pinned() for t in engine._staging.values())


@pytest.fixture(scope="module")
def cuda_engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {dtype: _engine("cuda", dtype) for dtype in (torch.float32, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_rois", [3, 4], ids=["n_below_bucket", "n_at_bucket"])
def test_pinned_outputs_equal_a_pageable_call(cuda_engines, dtype, n_rois):
    engine = cuda_engines[dtype]
    images, rois = _request(n_rois, seed=n_rois)
    pageable = _direct(engine, images, rois)
    with tracing.recording() as records:
        pinned = engine(images, rois)
    _assert_same(pinned, pageable)
    assert all(isinstance(a.base, torch.Tensor) and a.base.is_pinned() for a in pinned)
    assert all(t.is_pinned() for t in engine._staging.values())
    c = records[0]["counters"]
    assert c["pinned_bytes"] == c["h2d_bytes"] + c["d2h_bytes"] > 0


@pytest.mark.cuda
def test_pinned_transfer_at_the_served_shape():
    """32 images at 480 x 640 and 124 RoIs (bucket 128), bf16: the served
    request's bytes through page-locked memory, equal to a pageable call,
    and each call's arrays its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    engine = _engine("cuda", torch.bfloat16, image_size=(480, 640))
    first = _request(124, batch=32, size=(480, 640), seed=1)
    second = _request(124, batch=32, size=(480, 640), seed=2)
    pageable = _direct(engine, *first)
    with tracing.recording() as records:
        pinned = engine(*first)
        kept = [a.copy() for a in pinned]
        engine(*second)
    _assert_same(pinned, pageable)
    _assert_same(pinned, kept)
    c = [r["counters"] for r in records if r["parent"] is None]
    assert c[0]["h2d_bytes"] == 32 * 480 * 640 * 3 * 2 + 128 * 5 * 4
    assert c[0]["d2h_bytes"] == 124 * 32 * 24 * 4 + 32 * 480 * 640 * 4
    assert [x["pinned_bytes"] for x in c] == [x["h2d_bytes"] + x["d2h_bytes"] for x in c]
    assert [x["staging_builds"] for x in c] == [2, 0]
