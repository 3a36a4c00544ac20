"""The LayerNorm2d kernel pair's plain chain and routing (ops/cuda_norm.py).

``ln_act_plain`` is held bit for bit to the chain the modules ran before
the kernel existed (written out below), at every (C, H, W) that the served
B0 and B7 stage 2 normalises; the modules that route through ``norm_act``
are held to their unrouted outputs on the CPU, with the kernel's route
forced (``_build.takes_kernel`` answering yes for ``ln_act``, which then
computes the plain chain) and counted. The CUDA kernels run only on a GPU:
``chip_smoke.py`` phase 21 holds them against ``ln_act_plain`` there, and
``tests/test_torch_ln_twin.py`` against their twin.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from human_instance_segmentation_tpu_torch import tracing
from human_instance_segmentation_tpu_torch.inference import InferenceEngine, create_flagship
from human_instance_segmentation_tpu_torch.models.blocks import (ConvNormAct, ResidualBlock,
                                                                 set_head_fusion)
from human_instance_segmentation_tpu_torch.models.heads import HierarchicalHeadV2
from human_instance_segmentation_tpu_torch.ops import _build, cuda_norm
from human_instance_segmentation_tpu_torch.ops.activations import get_activation
from human_instance_segmentation_tpu_torch.ops.norms import GroupNorm2d, LayerNorm2d
from human_instance_segmentation_tpu_torch.ops.quant import (calibration, collect_scales,
                                                             set_int8_serving)

# (C, H, W) of every LayerNorm2d of a served forward (57 calls), by configuration
B0_SHAPES = [(32, 128, 96), (48, 64, 48), (64, 64, 48), (96, 32, 24), (96, 64, 48),
             (128, 64, 48), (128, 128, 96), (192, 16, 12), (192, 32, 24), (256, 64, 48),
             (384, 16, 12)]
B7_SHAPES = [(32, 256, 192), (48, 128, 96), (64, 128, 96), (96, 64, 48), (96, 128, 96),
             (128, 128, 96), (128, 256, 192), (192, 32, 24), (192, 64, 48), (256, 128, 96),
             (384, 32, 24)]
SHAPES = sorted(set(B0_SHAPES) | set(B7_SHAPES))
# (residual, relu, int8 out, channels-last): each way of each switch in four cases
CASES = [(False, True, False, True), (True, True, True, True), (True, False, False, False),
         (False, False, True, False)]
QSCALE = 3.0 / 127


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _todays_chain(x, weight, bias, eps, residual, relu, qscale):
    """LayerNorm2d -> + residual -> F.relu -> quantize_static, as the
    modules wrote them before the kernel pair."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    y = y * weight[:, None, None] + bias[:, None, None]
    if residual is not None:
        y = y + residual
    if relu:
        y = F.relu(y)
    if qscale is None:
        return y
    inv = torch.full((1,), 1.0 / qscale, dtype=torch.float32)
    return torch.round(y.to(torch.float32) * inv).clamp(-127.0, 127.0).to(torch.int8)


def _operands(shape, n, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[0]
    x = torch.randn((n, *shape), generator=g) * 2.0 + 0.5
    res = torch.randn((n, *shape), generator=g)
    weight = 1.0 + 0.2 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x, res = (t.to(dtype).contiguous(memory_format=fmt) for t in (x, res))
    return x, res, weight.to(dtype), bias.to(dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ln_act_plain_is_todays_chain(shape, dtype):
    n = 1 if np.prod(shape) > 1_000_000 else 2
    for residual, relu, int8, cl in CASES:
        x, res, weight, bias = _operands(shape, n, dtype, cl)
        args = (x, weight, bias, 1e-5, res if residual else None, relu, QSCALE if int8 else None)
        got, want = cuda_norm.ln_act_plain(*args), _todays_chain(*args)
        assert got.dtype == (torch.int8 if int8 else dtype)
        assert torch.equal(got, want), (residual, relu, int8, cl)


@pytest.mark.parametrize("residual,relu,int8,cl", list(itertools.product([False, True], repeat=4)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ln_act_on_the_cpu_is_the_plain_chain(dtype, residual, relu, int8, cl):
    x, res, weight, bias = _operands((48, 6, 4), 2, dtype, cl, seed=1)
    args = (x, weight, bias, 1e-5, res if residual else None, relu, QSCALE if int8 else None)
    before = cuda_norm.ln_act.launches
    got = cuda_norm.ln_act(*args)
    assert cuda_norm.ln_act.launches == before  # CPU tensors launch nothing
    assert torch.equal(got, _todays_chain(*args))


def test_ln_act_refuses_a_device_without_kernel():
    x = torch.empty((1, 8, 2, 2), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        cuda_norm.ln_act(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


@pytest.mark.parametrize("n,shape", [(64, s) for s in B7_SHAPES] + [(128, s) for s in B0_SHAPES]
                         + [(1, (8, 2, 3)), (3, (7, 5, 3)), (1, (384, 256, 192))])
@pytest.mark.parametrize("vec", [True, False])
def test_plan_covers_each_sample_once(n, shape, vec):
    per_sample = int(np.prod(shape))
    p, chunk = cuda_norm.plan(n, per_sample, vec)
    assert 1 <= p <= cuda_norm._MAX_SLICES
    assert p * chunk >= per_sample > (p - 1) * chunk  # no block empty, none left out
    if vec:
        assert chunk % 8 == 0
    if p > 1:  # blocks of at least 4,096 values, about two waves of the card
        assert chunk >= cuda_norm._MIN_BLOCK
        assert n * p <= 2 * 2 * 132 * 8 or p <= 2


class _Norm(torch.nn.Module):
    def forward(self, x):
        return x


def request_route(monkeypatch):
    """norm_act's kernel route on CPU tensors (the predicate answers yes for
    ``ln_act``, every other family keeps its CPU twin; ``ln_act`` computes
    the plain chain), each call recorded as (x's shape, qscale)."""
    calls = []
    takes_kernel = _build.takes_kernel

    def counted(x, weight, bias, eps, residual, relu, qscale):
        calls.append((tuple(x.shape), qscale))
        return cuda_norm.ln_act_plain(x, weight, bias, eps, residual, relu, qscale)

    monkeypatch.setattr(_build, "takes_kernel",
                        lambda t, name: name == "ln_act" or takes_kernel(t, name))
    monkeypatch.setattr(cuda_norm, "ln_act", counted)
    return calls


@pytest.fixture()
def kernel_route(monkeypatch):
    return request_route(monkeypatch)


def test_routing_gate(kernel_route):
    relu, ident, silu = (get_activation(a) for a in ("relu", "identity", "silu"))
    ln = LayerNorm2d(8).eval()
    x = torch.randn(2, 8, 4, 4)
    with torch.no_grad():
        assert cuda_norm.engages(x, ln, relu) and cuda_norm.engages(x, ln, ident)
        assert cuda_norm.engages(x, ln, relu, residual=x.clone())
        assert not cuda_norm.engages(x, GroupNorm2d(8, 4), relu)  # not a LayerNorm2d
        assert not cuda_norm.engages(x, _Norm(), relu)
        assert not cuda_norm.engages(x, ln, silu)  # not ReLU or the identity
        assert not cuda_norm.engages(x.double(), ln.double(), relu)  # float64
        assert not cuda_norm.engages(x.bfloat16(), ln, relu)  # norm not in x's dtype
        assert not cuda_norm.engages(x, ln, relu, residual=x.bfloat16())
    assert not cuda_norm.engages(x, ln, relu)  # autograd records the parameters
    assert not cuda_norm.engages(x.requires_grad_(), ln.requires_grad_(False), relu)
    with torch.inference_mode():
        assert cuda_norm.engages(torch.randn(2, 8, 4, 4), LayerNorm2d(8), relu)
    assert kernel_route == []


def test_export_traces_the_modules_chain(kernel_route):
    """A tracer cannot see into the ctypes kernels: under ``torch.export``
    the route keeps the modules' chain even where it would engage."""
    cna = ConvNormAct(8, 8).eval()
    with torch.no_grad():
        torch.export.export(cna, (torch.randn(1, 8, 4, 4),))
        assert cna(torch.randn(1, 8, 4, 4)) is not None
    assert len(kernel_route) == 1  # the eager call only


def test_routing_sends_cpu_tensors_to_the_modules(monkeypatch):
    """CPU tensors take no kernel, however eligible: norm_act runs the
    modules' chain and never reaches ln_act."""
    ln = LayerNorm2d(8)
    x = torch.randn(2, 8, 4, 4)
    monkeypatch.setattr(cuda_norm, "ln_act", None)  # reaching it would raise
    with torch.no_grad():
        assert cuda_norm.engages(x, ln, F.relu) and not _build.takes_kernel(x, "ln_act")
        assert torch.equal(cuda_norm.norm_act(x, ln, F.relu), F.relu(ln(x)))


def _old_conv_norm_act(m, x):
    return m.act(m.norm(m.conv(x)))


def _old_residual_block(m, x):
    h = m.act(m.norm1(m.conv1(x)))
    scale = m.conv2.static_scale
    if m.conv2.serving and scale is not None and not m.conv2.denied:
        inv = torch.full((1,), 1.0 / scale, dtype=torch.float32)
        h = torch.round(h.to(torch.float32) * inv).clamp(-127.0, 127.0).to(torch.int8)
    return m.act(m.norm2(m.conv2(h)) + x)


def _randomise(module, seed):
    """Conv weights N(0, 0.2^2), norm scales 1 + N(0, 0.2^2), biases N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() > 1:
                p.copy_(0.2 * r)
            elif name.endswith("norm.weight") or name.endswith(("norm1.weight", "norm2.weight")):
                p.copy_(1.0 + 0.2 * r)
            else:
                p.copy_(0.1 * r)


def _int8(module, *inputs):
    with torch.inference_mode(), calibration(module) as calib:
        module(*inputs)
    set_int8_serving(module, True, collect_scales(calib))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("route", ["modules", "kernel"])
def test_blocks_unchanged_on_the_cpu(request, int8, route):
    calls = request.getfixturevalue("kernel_route") if route == "kernel" else None
    x = torch.randn(2, 16, 12, 8, generator=torch.Generator().manual_seed(3))
    cna, rb = ConvNormAct(16, 24).eval(), ResidualBlock(16).eval()
    for i, m in enumerate((cna, rb)):
        _randomise(m, i)
        if int8:
            _int8(m, x)
    assert (rb.conv2.static_scale is not None) == int8
    if calls is not None:
        calls.clear()  # the calibration forwards'
    with torch.inference_mode():
        assert torch.equal(cna(x), _old_conv_norm_act(cna, x))
        assert torch.equal(rb(x), _old_residual_block(rb, x))
    if calls is not None:  # ConvNormAct, then norm1 (int8 codes for conv2) and norm2
        want = rb.conv2.static_scale if int8 else None
        assert calls == [((2, 24, 12, 8), None), ((2, 16, 12, 8), want), ((2, 16, 12, 8), None)]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_head_v2_unchanged_by_the_kernel_route(monkeypatch, int8):
    head = HierarchicalHeadV2(32, 64, (32, 24), base_channels=16, depth=3).eval()
    _randomise(head, 5)
    feats = torch.randn(2, 32, 16, 12, generator=torch.Generator().manual_seed(4))
    if int8:
        _int8(head, feats)
    with torch.inference_mode():
        want, want_aux = head(feats)
    calls = request_route(monkeypatch)
    with torch.inference_mode():
        got, got_aux = head(feats)
    assert torch.equal(got, want)
    for k in want_aux:
        assert torch.equal(got_aux[k], want_aux[k]), k
    # shared_in 1 + 2 x 2 shared residual blocks, EnhancedUNet(depth 3) 31,
    # upsample_norm 1, tnt_res0 2, tnt_norm 1, tnt_res1 2
    assert len(calls) == 42
    shapes = [s[1:] for s, _ in calls]
    assert (32, 32, 24) in shapes and (32, 64, 48) not in shapes  # tnt_norm, upsample_norm
    assert any(q is not None for _, q in calls) == int8


def test_training_keeps_the_plain_chain(kernel_route):
    rb = ResidualBlock(16).train()
    x = torch.randn(2, 16, 6, 4)
    rb(x).sum().backward()
    assert kernel_route == [] and rb.conv1.weight.grad is not None


@pytest.mark.parametrize("fused,count", [(False, 57), (True, 52)], ids=["unfused", "fused"])
def test_served_b0_forward_routes_every_layernorm(monkeypatch, kernel_route, fused, count):
    """A served B0 forward (head width 256, contour and distance branches)
    takes the kernel route at every LayerNorm2d: 57, or 52 beside the fused
    unit's five bottleneck units; the outputs are the unrouted ones."""
    model = create_flagship(variant="b0", image_size=(64, 64), device="cpu", mid_channels=256,
                            use_contour_detection=True, use_distance_transform=True)
    set_head_fusion(model, fused)
    images = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    rois = torch.tensor([[0.0, 0.1, 0.1, 0.6, 0.9]])
    with torch.inference_mode():
        got = model(images, rois)[0]
    assert len(kernel_route) == count
    kernel_route.clear()
    monkeypatch.undo()  # the modules' route
    with torch.inference_mode():
        want = model(images, rois)[0]
    assert kernel_route == [] and torch.equal(got, want)


def test_int8_engine_unchanged_by_the_kernel_route(monkeypatch):
    """The int8 engine on the CPU (tiny flagship) serves the same masks and
    logits with the kernel route forced; the route writes int8 codes inside
    each ResidualBlock."""
    model = create_flagship(variant="b0", roi_size=(16, 12), mask_size=(32, 24),
                            image_size=(64, 64), device="cpu", mid_channels=64,
                            use_contour_detection=True, use_distance_transform=True)
    rng = np.random.default_rng(0)
    images = rng.random((1, 64, 64, 3), dtype=np.float32)
    rois = np.array([[0, 0.1, 0.1, 0.6, 0.9], [0, 0.3, 0.2, 0.9, 0.7]], np.float32)
    engine = InferenceEngine(model, dilation_pixels=1, fused_head=True, quantize="int8",
                             device="cpu")
    engine.calibrate(images, rois)
    modules = []
    forward = LayerNorm2d.forward
    monkeypatch.setattr(LayerNorm2d, "forward", lambda m, x: modules.append(m) or forward(m, x))
    want = engine(images, rois)
    calls, routed = request_route(monkeypatch), len(modules)
    got = engine(images, rois)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert len(modules) == routed and len(calls) == routed > 40  # every unfused LayerNorm2d
    assert any(q is not None for _, q in calls)


def test_launch_counts_list_ln_act():
    counts = tracing.launch_counts()
    assert "launches.ln_act" in counts
    assert counts["launches.ln_act"] == cuda_norm.ln_act.launches == 0  # no launch on the CPU
