"""The serving route: one predicate decides kernel or plain twin
(``ops/_build.takes_kernel`` and the ``plain()`` context), and the engine
sets its serving state when it changes, not at every forward.

On the CPU: the predicate and ``plain()``; an engine with ``kernels=False``
runs its forward and its calibration inside ``plain()``; after calibration
a served call sets nothing and walks no module tree, and serves what the
switches set by hand serve. The test marked ``cuda`` skips without a card;
run it there with

    python -m pytest --noconftest tests/test_torch_route.py -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from human_instance_segmentation_tpu_torch import inference, tracing
from human_instance_segmentation_tpu_torch.inference import (InferenceEngine, create_flagship,
                                                             deployed_outputs, pad_rois,
                                                             roi_bucket)
from human_instance_segmentation_tpu_torch.models import blocks
from human_instance_segmentation_tpu_torch.models.efficientnet import MBConv
from human_instance_segmentation_tpu_torch.ops import _build, quant

TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32)
FLAGSHIP = dict(variant="tiny", seed=0, pallas_tail=True, encoder_fused_blocks=2,
                use_contour_detection=True, use_distance_transform=True)


def _request(n_rois: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    images = rng.random((2, 64, 96, 3), dtype=np.float32)
    lo = rng.uniform(0.0, 0.4, (n_rois, 2))
    rois = np.concatenate([np.arange(n_rois)[:, None] % 2, lo, lo + 0.5], axis=1)
    return images, rois.astype(np.float32)


def _tensors(engine, images, rois):
    bucket = roi_bucket(rois.shape[0], max_bucket=engine.max_bucket)
    return (torch.as_tensor(images).to(engine.device),
            torch.as_tensor(pad_rois(rois, bucket)).to(engine.device))


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


def _engine(model, **kw):
    return InferenceEngine(model, device="cpu", dilation_pixels=1, dtype=torch.bfloat16,
                           fused_head=True, quantize="int8", **kw)


def test_plain_nests_and_restores():
    """CPU tensors take the twin, CUDA ones the kernel outside ``plain()``,
    any other device raises outside it; ``plain()`` nests, and every exit,
    by an exception too, restores the value it found."""
    cpu, cuda = torch.zeros(1), SimpleNamespace(device=torch.device("cuda", 0))
    meta = torch.empty(1, device="meta")
    assert not _build.takes_kernel(cpu, "probe") and _build.takes_kernel(cuda, "probe")
    with pytest.raises(RuntimeError, match="probe: no kernel for device meta"):
        _build.takes_kernel(meta, "probe")
    with _build.plain():
        assert not _build.takes_kernel(cuda, "probe") and not _build.takes_kernel(meta, "probe")
        with _build.plain():
            assert not _build.takes_kernel(cuda, "probe")
        assert not _build.takes_kernel(cuda, "probe")
    assert _build.takes_kernel(cuda, "probe")
    with pytest.raises(ValueError, match="inside"):
        with _build.plain():
            raise ValueError("inside")
    assert _build.takes_kernel(cuda, "probe")


@pytest.mark.parametrize("kernels", [True, False])
def test_engine_runs_forward_and_calibration_on_its_route(model, monkeypatch, kernels):
    """Every question an engine's calibration and forward put to the
    predicate is asked inside ``plain()`` exactly when ``kernels`` is
    False, the LayerNorm2d pair's and the crops' among them."""
    asked = []
    takes_kernel = _build.takes_kernel

    def spy(t, name):
        asked.append((name, _build._PLAIN.get()))
        return takes_kernel(t, name)

    monkeypatch.setattr(_build, "takes_kernel", spy)
    engine = _engine(model, kernels=kernels)
    images, rois = _request()
    engine.calibrate(images, rois)
    calibrating, asked[:] = list(asked), []
    engine.forward(*_tensors(engine, images, rois))
    for questions in (calibrating, asked):
        names = {name for name, _ in questions}
        assert {"ln_act", "roi_align_pair", "mbconv_sums", "qconv2d", "tail_q"} & names
        assert {inside for _, inside in questions} == {not kernels}
    assert {"ln_act", "roi_align_pair", "tail_q", "qconv2d"} <= {name for name, _ in asked}
    assert not _build._PLAIN.get()


def test_served_call_sets_nothing_and_walks_no_tree(model, monkeypatch):
    """After calibration a served call calls neither setter and walks no
    module tree (the fused encoder blocks fold their own parameters, and
    nothing else is walked), and ``forward`` serves exactly what the model
    serves with the switches set by hand, as every forward set them
    before."""
    engine = _engine(model)
    images, rois = _request()
    engine(images, rois)  # calibrates, then serves
    assert engine.scales
    images_t, rois_t = _tensors(engine, images, rois)

    def refuse(*args, **kwargs):
        raise AssertionError("a serving setter ran inside a served call")

    walked = []
    named_modules = nn.Module.named_modules

    def spy(self, *args, **kwargs):
        if (args[0] if args else kwargs.get("memo")) is None:  # a walk's root, not its recursion
            walked.append(self)
        return named_modules(self, *args, **kwargs)

    with monkeypatch.context() as m:
        for module, name in ((inference, "set_head_fusion"), (inference, "set_int8_serving"),
                             (blocks, "set_head_fusion"), (quant, "set_int8_serving")):
            m.setattr(module, name, refuse)
        m.setattr(nn.Module, "named_modules", spy)
        engine(images, rois)
        got = engine.forward(images_t, rois_t)
    assert walked and all(isinstance(root, MBConv) for root in walked)

    blocks.set_head_fusion(engine.model, True)
    quant.set_int8_serving(engine.model, True, engine.scales, engine.int8_deny)
    with torch.inference_mode():
        logits, aux = engine.model(images_t.to(engine.dtype), rois_t)
        want = (*deployed_outputs(logits, aux, rois_t, engine.dilation_pixels), logits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_calibration_failure_restores_the_serving_state(model, monkeypatch):
    """A calibration that raises leaves the head fusion and int8 serving
    on, with the scales the engine had."""
    engine = _engine(model)
    images, rois = _request()
    engine.calibrate(images, rois)
    scales = dict(engine.scales)

    def broken(self, x):
        raise RuntimeError("calibration forward")

    monkeypatch.setattr(quant.QConv, "forward", broken)
    with pytest.raises(RuntimeError, match="calibration forward"):
        engine.calibrate(images, rois)
    assert engine.scales == scales
    fusables = [m for m in engine.model.modules() if isinstance(m, blocks._Fusable)]
    qconvs = [m for m in engine.model.modules() if isinstance(m, quant.QConv)]
    assert fusables and all(m.fused_head for m in fusables)
    assert qconvs and all(m.serving for m in qconvs)
    assert any(m.static_scale is not None for m in qconvs)
    assert engine.model.pretrained_unet.tail_scales is not None


@pytest.mark.cuda
def test_engine_without_kernels_launches_nothing_on_the_card():
    """C17: over a ``kernels=False`` call on the card (its calibration and
    its forward) no entry point's launch counter moves, ``ln_act``'s and
    ``roi_align``'s included; the same request through ``kernels=True``
    moves them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = create_flagship(device="cuda", **FLAGSHIP, **TINY)
    images, rois = _request()
    engines = {}
    moved = {}
    for kernels in (False, True):
        engines[kernels] = InferenceEngine(cuda, dilation_pixels=1, dtype=torch.bfloat16,
                                           fused_head=True, quantize="int8", kernels=kernels)
        before = tracing.launch_counts()
        out = engines[kernels](images, rois)
        torch.cuda.synchronize()
        after = tracing.launch_counts()
        moved[kernels] = {k: after[k] - before[k] for k in after if k.startswith("launches.")}
        assert all(np.isfinite(a).all() for a in out)
    assert not any(moved[False].values()), moved[False]
    for name in ("ln_act", "roi_align", "tail_q", "mbconv_sums", "mbconv_apply", "qconv2d"):
        assert moved[True][f"launches.{name}"] > 0, moved[True]
