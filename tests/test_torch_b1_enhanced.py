"""The B1 enhanced flagship's head shape on the CPU, scaled down: a depth-4
EnhancedUNet over RoI 40 x 30 crops (pooled 20 x 15, 10 x 7 and 5 x 3, so
``max_pool_2x`` floors odd widths and two up-steps are resized to their
skips), mask 80 x 60, tiny encoder, float32.

The port served through ``InferenceEngine`` (plain crops, ``kernels=False``)
is held against the benchmark's plain reference (``port_bench/reference/
flagship.py``) on seeded random weights, at the tolerances of
``port_bench/tests/test_bench_reference.py``; with ``fused_head`` the fused
unit's plain version (``conv_ln_act_plain``) serves the 5 x 3 x 256 level,
which base 32 reaches (base 16 stays under the unit's 256 channels). The
port's depth-4 head is also held against the JAX package's at those sizes.

The benchmark's files for the configuration ``b1_enhanced_480x640_int8``
and the cell ``b1.batch8.coco``, the UNet's work count and the two readers
of the ``model.head.bgfg_unet`` span are checked here too.

    python -m pytest tests/test_torch_b1_enhanced.py -q
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from test_torch_norms_attention import _perturbed
from human_instance_segmentation_tpu.models import heads as jheads
from human_instance_segmentation_tpu_torch.inference import InferenceEngine
from human_instance_segmentation_tpu_torch.models import heads as pheads
from human_instance_segmentation_tpu_torch.models.assembly import HierarchicalInstanceSegmenter
from human_instance_segmentation_tpu_torch.ops import cuda_head
from human_instance_segmentation_tpu_torch.weights import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.lib import spans, spec, traffic, unet_work, weights, work  # noqa: E402
from port_bench.lib.system import parameter_shapes  # noqa: E402
from port_bench.reference import flagship  # noqa: E402

BENCH = ROOT / "port_bench"
TINY = spec.load_json(BENCH / "tests" / "data" / "tiny_config.json")
ENHANCED = dict(roi_size=[40, 30], mask_size=[80, 60], depth=4, pallas_roi_align=False,
                encoder_fused_blocks=0)
HEAD_KW = dict(norm="layernorm2d", norm_groups=8, activation="relu", activation_beta=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(base: int) -> dict:
    return dict(TINY, model=dict(TINY["model"], base_channels=base, **ENHANCED))


def _weights(cfg: dict) -> dict:
    w = weights.draw(parameter_shapes(cfg), 2 ** 31 + 20, "cpu")
    # non-trivial norms and biases, so a mis-mapped affine or statistic shows
    gen = torch.Generator().manual_seed(7)
    for name, t in w.items():
        if t.dim() == 1 and not name.startswith("unet_wrapper"):
            w[name] = t + 0.1 * torch.rand(t.shape, generator=gen)
    return w


@pytest.mark.parametrize("fused,base", [(False, 16), (False, 32), (True, 32)],
                         ids=["plain_base16", "plain_base32", "fused_head_base32"])
def test_enhanced_shape_matches_reference(fused, base, monkeypatch):
    """Class logits, binary masks and instance masks of the port against the
    reference; with ``fused_head`` the fused unit's plain version runs the
    bottleneck's five units (two ResidualBlocks and a ConvNormAct)."""
    cfg = _config(base)
    w = _weights(cfg)
    model = HierarchicalInstanceSegmenter(**cfg["model"])
    model.load_state_dict(w)
    engine = InferenceEngine(model.eval(), device="cpu", dilation_pixels=1, kernels=False,
                             fused_head=fused)
    calls = []
    plain = cuda_head.conv_ln_act_plain

    def counted(x, *args, **kwargs):
        calls.append(tuple(x.shape[1:]))
        return plain(x, *args, **kwargs)

    monkeypatch.setattr(cuda_head, "conv_ln_act_plain", counted)
    req = traffic.request(spec.load_json(BENCH / "tests" / "data" / "tiny_traffic.json"), 8,
                          tuple(cfg["model"]["image_size"]), traffic.rng(9, 0))
    images, rois = torch.as_tensor(req.images), torch.as_tensor(req.rois)
    inst, binary, logits = engine.forward(images, rois)
    assert calls == ([(5, 3, 256)] * 5 if fused else [])

    ref = flagship.build(cfg, "cpu")
    flagship.load(ref, w)
    with torch.no_grad():
        dense, rbinary = ref.stage1(images)
        rlogits, rinst = ref.stage2(images, dense, rois)
    assert tuple(rlogits.shape) == (8, 3, 80, 60)
    np.testing.assert_allclose(logits.permute(0, 3, 1, 2).numpy(), rlogits.numpy(),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(binary.numpy(), rbinary.numpy(), atol=1e-5)
    assert (inst.numpy() != rinst.numpy()).mean() < 1e-3


def test_depth4_head_at_odd_sizes_matches_jax():
    """``HierarchicalHeadV2`` at depth 4 on 40 x 30 features (the pooled
    widths 15 and 7 are odd, so two up-steps are resized to their skips)
    against the JAX head: final logits and every aux map within rtol 1e-4 /
    atol 1e-5 (the head tests' tolerance, JAX at the highest matmul
    precision)."""
    kw = dict(mid_channels=32, mask_size=(80, 60), base_channels=8, depth=4, dropout_rate=0.0,
              **HEAD_KW)
    jm, pm = jheads.HierarchicalHeadV2(**kw), pheads.HierarchicalHeadV2(16, **kw)
    x = (np.random.default_rng(4).standard_normal((2, 40, 30, 16)) + 0.3).astype(np.float32)
    v = _perturbed(jax.tree.map(np.asarray, fast_init(jm, jnp.zeros(x.shape), seed=5)))
    load_jax_params(pm, v)
    with jax.default_matmul_precision("highest"):
        want_logits, want_aux = jax.tree.map(np.asarray, jm.apply(v, jnp.asarray(x),
                                                                  train=False))
    pm.eval()
    with torch.no_grad():
        got_logits, got_aux = pm(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))

    def nhwc(t):
        return np.transpose(t.numpy(), (0, 2, 3, 1))

    assert got_aux["bg_fg_logits_low"].shape[2:] == (40, 30)
    assert set(got_aux) == set(want_aux)
    for k, want in want_aux.items():
        np.testing.assert_allclose(nhwc(got_aux[k]), want, rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(nhwc(got_logits), want_logits, rtol=1e-4, atol=1e-5)


def _bench_config(name: str) -> dict:
    return spec.load_json(BENCH / "configs" / f"{name}.json")


def test_b1_configuration_and_cell():
    """Every keyword of the B0 configuration given, at B1 enhanced's
    published values; its source is the reference's registry file, which no
    other configuration names; the cell's mix is coco32's at 8 images and
    31 RoIs (bucket 32); the cell reports the two UNet metrics."""
    b0, b1 = _bench_config("b0_480x640_int8"), _bench_config("b1_enhanced_480x640_int8")
    assert set(b1) == set(b0) and b1["reduced"] == []
    assert b1["source"].startswith(b0["source"] + "/") and b1["source"].endswith(
        "/experiments/config_manager.py")
    others = [c for c in spec.benchmark()["configs"] if c["name"] != b1["name"]]
    assert all(c["source"] != b1["source"] for c in others)
    changed = {k for k in b0["model"] if b0["model"][k] != b1["model"][k]}
    assert set(b1["model"]) == set(b0["model"])
    assert changed == {"encoder_variant", "roi_size", "mask_size", "base_channels", "depth"}
    assert (b1["model"]["encoder_variant"], b1["model"]["roi_size"], b1["model"]["mask_size"],
            b1["model"]["base_channels"], b1["model"]["depth"]) == ("b1", [80, 60], [160, 120],
                                                                     128, 4)
    assert b1["engine"] == b0["engine"] and b1["int8_groups"] == b0["int8_groups"]
    assert "image_size" in b1["assumed"] and "weights" in b1["assumed"]
    cell = spec.cell("b1.batch8.coco")
    assert cell["config"] == b1 and cell["workload"]["chips"] == 1
    coco8, coco32 = cell["traffic"], spec.load_json(BENCH / "traffic" / "coco32.json")
    assert {k: v for k, v in coco8.items() if k not in ("images", "rois")} == {
        k: v for k, v in coco32.items() if k not in ("images", "rois")}
    assert (coco8["images"], coco8["rois"]) == (8, round(8 * 3.86))
    pool = traffic.pool(coco8, (24, 32), 2 ** 31 + 5)
    assert {r.rois.shape[0] for r in pool} == {31}
    reported = {m["name"] for m in cell["per_layer"]}
    assert {"bgfg_unet_ms.batch", "bgfg_unet_roofline.batch", "stage2_ms.batch"} <= reported
    for name in ("b0.batch32.coco", "b7.crowdhuman2"):
        assert {"bgfg_unet_ms.batch", "bgfg_unet_roofline.batch"} <= {
            m["name"] for m in spec.cell(name)["per_layer"]}


def test_b1_int8_rule_matches_the_engine():
    """The configuration's int8 rule names exactly the reference's convs the
    engine serves in int8 (its QConvs that run int8, and the seg head
    inside the s8 tail), the 1024-channel bottleneck convs among them."""
    from human_instance_segmentation_tpu_torch.ops.quant import QConv, set_int8_serving

    config = _bench_config("b1_enhanced_480x640_int8")
    ref = flagship.build(config, "meta")
    convs = {n.replace(".", "/"): m.contraction for n, m in ref.named_modules()
             if isinstance(m, flagship.Conv)}
    groups, least = tuple(config["int8_groups"]), config["int8_min_contraction"]
    by_rule = {p for p, c in convs.items() if p.startswith(groups) and c >= least}
    with torch.device("meta"):
        model = HierarchicalInstanceSegmenter(**config["model"])
    set_int8_serving(model, True, None, config["engine"]["int8_deny"])
    served = {n.replace(".", "/") for n, m in model.named_modules()
              if isinstance(m, QConv) and m.runs_int8}
    served.add("pretrained_unet/seg_head")  # the s8 tail (tail_q) quantizes its input
    assert by_rule == served & set(convs)
    unet = "head/base_head/bg_vs_fg_unet/"
    assert {unet + "bott_att", unet + "bott_conv", unet + "bott_res0/conv1"} <= by_rule
    assert convs[unet + "bott_conv"] == 9 * 1024


def test_unet_work_count(monkeypatch):
    """The UNet's operations a RoI, by the work count's int8/bf16 rule: B1
    enhanced about 49.9 GOP (41% of stage 2), B0 about 14.6; with no prefix
    the count is the whole of stage 2 and every weight."""
    b1, b0 = _bench_config("b1_enhanced_480x640_int8"), _bench_config("b0_480x640_int8")
    u1, u0 = unet_work.count(b1), unet_work.count(b0)
    assert 49e9 < sum(u1.roi_ops.values()) < 51e9 and 14e9 < sum(u0.roi_ops.values()) < 15e9
    assert u1.roi_ops["int8"] > 0.95 * sum(u1.roi_ops.values())
    w1 = work.count(b1)
    assert 0.39 < sum(u1.roi_ops.values()) / sum(w1.roi_ops.values()) < 0.43
    assert 95e6 < u1.weight_bytes < w1.weight_bytes
    monkeypatch.setattr(unet_work, "UNET", "")
    whole = unet_work.count(b1)
    assert whole.roi_ops == pytest.approx(w1.roi_ops)
    assert whole.weight_bytes == pytest.approx(w1.weight_bytes)
    assert u1.ops(31) == pytest.approx({k: 31 * v for k, v in u1.roi_ops.items()})


def _cpu(name, s, e, cid=0, annotation=False):
    return spans.Event(name, "CPU", s, e, cid, annotation)


def _window(with_unet: bool):
    """Two requests' worth of one request's events (halved by ``requests``):
    stage 2's kernels from 5.5 to 8.0 s, 1.5 s of them launched inside the
    UNet's span when the program has it."""
    ev = [_cpu(spans.PREFIX + "engine.call", 0.0, 9.0, annotation=True),
          _cpu(spans.PREFIX + "model.stage2", 5.0, 5.6, annotation=True),
          _cpu("cudaLaunchKernel", 5.1, 5.15, 1), spans.Event("k_unet", "CUDA", 5.5, 7.0, 1),
          _cpu("cudaLaunchKernel", 5.5, 5.55, 2), spans.Event("k_rest", "CUDA", 7.0, 8.0, 2)]
    if with_unet:
        ev.append(_cpu(spans.PREFIX + "model.head.bgfg_unet", 5.05, 5.2, annotation=True))
    sp = spans.reduce(ev, 10.0)
    sp.requests = 2
    return sp


@pytest.mark.parametrize("with_unet", [True, False], ids=["span", "parent_without_span"])
def test_bgfg_unet_readers(with_unet, monkeypatch):
    """``bgfg_unet_ms.batch``: the span's device ms a request;
    ``bgfg_unet_roofline.batch``: the UNet's least time on the traced
    requests' real RoIs over that device time. Both None (not 0) where the
    program records no such span, and without a second window."""
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "b1.batch8.coco", "--seed", "5"])
    ctx = SimpleNamespace(spans=_window(with_unet), traced=[(8, 31), (8, 31)])
    ms = spec.reader("metrics", "bgfg_unet_ms.batch")(ctx)
    roof = spec.reader("metrics", "bgfg_unet_roofline.batch")(ctx)
    if not with_unet:
        assert ms is None and roof is None
        return
    assert ms == pytest.approx(0.75e3)
    from port_bench.lib.peaks import bound

    u = unet_work.count(_bench_config("b1_enhanced_480x640_int8"))
    least = 2 * bound(u.weight_bytes, u.ops(31))["bound_s"]
    assert roof == pytest.approx(least / 1.5 * 100.0)
    off = SimpleNamespace(trace=None, traced=None, window=None, work=None)
    assert spec.reader("metrics", "bgfg_unet_ms.batch")(off) is None
    assert spec.reader("metrics", "bgfg_unet_roofline.batch")(off) is None
