"""Where the time of the port's tensor-core kernels goes: the fused stage-1
tail (``csrc/tail.cu``), the fused MBConv (``csrc/mbconv.cu``) and the int8
tail (``csrc/tail_q.cu``), timed at the served shapes with parts of each
kernel switched off; where the host time of a served ``tail_q`` and
bf16 ``conv_ln_act`` call goes; and the crops, the bilateral filter
(``crops``) and the edge smoothing (``edge``) timed alone.

    python3 scripts/profile_torch_kernels.py [bf16] [tail_q] [host] [conv_tile] [crops] [edge]

(all six groups without arguments). ``conv_tile`` times the bf16
``conv_ln_act`` at ``chip_smoke.HEAD_SHAPE`` with each wgmma tile forced
(``-DHIST_BF16_TILE=<BN * 10 + warpgroups>``; 0 is the launch's own pick).

Needs one CUDA card and ``nvcc``. Each variant is a separate build of the
kernels with ``-DHIST_SKIP=<mask>`` (``csrc/mma_bf16.cuh`` lists the bits);
a part switched off still runs its loads and stores of shared memory, so the
drop in time is what that part costs. The results are device times (ten
launches in a row between CUDA events, median of 20) on the same seeded
inputs: the tail at ``chip_smoke.TAIL_SHAPE`` in the served layout (NCHW
memory viewed as NHWC, weights packed once), both MBConv passes summed over
``chip_smoke.MBCONV_SHAPES`` (channels-last), the int8 tail as the tail
(bf16 output, operands packed once). A variant computes wrong values; only
its time means something. ``host``: wall time per call of 200 calls in a
row against their device time, and ``cProfile``'s largest entries. Prints
one line per variant, then all of them as one JSON object on the last line.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (name, HIST_SKIP mask): the tail's bits 1-16 and the MBConv's 32-512 are
# independent kernels, so one build switches a part of each off
VARIANTS = [
    ("all on", 0),
    ("no global loads (tail source cells, MBConv input tile)", 1 | 32),
    ("no upsample arithmetic / no expand product", 2 | 64),
    ("no tail products (conv0, conv1, head) / no depthwise taps", 4 | 8 | 16 | 128),
    ("no project product", 256),
    ("no SiLU", 512),
    ("skeleton: staging stores, epilogues and barriers only", 1023),
]
# conv_ln_act's wgmma tiles (s8igemm::pick_wide_tile's six), BN * 10 + warpgroups
CONV_TILES = [0, 641, 961, 1281, 642, 962, 1282]
# the int8 tail's bits (csrc/tail_q.cu)
VARIANTS_Q = [
    ("all on", 0),
    ("no input staging (global loads and quantizer)", 1024),
    ("no conv0 products", 2048),
    ("no conv1 products", 4096),
    ("no head products", 8192),
    ("no float border", 16384),
    ("no requantizing epilogues", 32768),
    ("epilogues on values that do not wait for the products", 65536),
    ("skeleton: barriers, stores and the head's epilogue only", 1024 | 2048 | 4096 | 8192 | 16384
     | 32768),
]


def host_profile(name, fn, card, reps=200):
    """Wall ms per call of ``reps`` calls in a row (the host's time when it is
    the slower side) beside the device ms of the same calls, and the largest
    ``cProfile`` entries of the host side."""
    import cProfile
    import io
    import pstats

    import torch

    import chip_smoke as cs

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    device = sum(cs.device_ms_by_kernel(fn).values())
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
    print(f"host {name}: {wall:.4f} ms wall per call ({reps} in a row), device {device:.4f} ms "
          f"per call [{card}]")
    print(out.getvalue())
    return {"kernel": name, "wall_ms": wall, "device_ms": device}


def kernels_around(fn, name: str, before: int = 2):
    """One call of ``fn`` under ``torch.profiler``: each launch of a kernel
    whose name holds ``name``, with its device ms and the ``before`` kernels
    that ran just before it on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seq = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                 key=lambda e: e.time_range.start)
    out = []
    for i, e in enumerate(seq):
        if name in e.name:
            out.append({"ms": e.time_range.elapsed_us() / 1e3,
                        "before": [p.name[:200] for p in seq[max(0, i - before):i]]})
    return out


def crops_and_bilateral(card, rng):
    """``roi_align`` and ``bilateral_filter`` at the served shapes: one call
    between CUDA events, ten in a row, device ms by kernel (profiler); for the
    crops also ``F.grid_sample`` on the same inputs and, in a served forward
    with and without ``pallas_tail``, each crop launch's device ms, the
    kernels just before it, and whether the logit map the model crops is a
    contiguous NHWC tensor (else the crop before the pair entry point copied
    it). Measures whichever crop entry points the package has
    (``roi_align``; ``roi_align_pair`` where it exists), so the same script
    times a parent commit beside this one."""
    import torch

    import chip_smoke as cs
    from human_instance_segmentation_tpu_torch.inference import (InferenceEngine,
                                                                 create_flagship, pad_rois)
    from human_instance_segmentation_tpu_torch.ops import cuda_kernels, cuda_roi_align

    b, (h, w), (oh, ow) = 32, cs.IMAGE_HW, cs.ROI_HW
    scale = (float(h), float(w))

    def t(shape):
        return torch.tensor(rng.random(shape), dtype=torch.bfloat16, device="cuda")

    rgb = t((b, h, w, 3))
    logit2 = t((b, 2, h, w)).permute(0, 2, 3, 1)  # the wrapper's NCHW output, viewed NHWC
    logit1 = t((b, h, w))[..., None]  # the fused tail's map
    rois = cs.served_crop_rois(b)
    single = cuda_roi_align.roi_align
    pair = getattr(cuda_roi_align, "roi_align_pair", None)
    calls = {
        "roi_align rgb (32,480,640,3)": lambda: single(rgb, rois, oh, ow, scale, True),
        "roi_align logit (32,480,640,2), .contiguous() first as the parent's model did":
            lambda: single(logit2.contiguous(), rois, oh, ow, scale, True),
        "roi_align logit (32,480,640,1)": lambda: single(logit1, rois, oh, ow, scale, True),
    }
    if pair is not None:
        calls["roi_align_pair rgb + logit C=2 (strided view)"] = lambda: pair(
            rgb, logit2, rois, oh, ow, scale, True)
        calls["roi_align_pair rgb + logit C=1"] = lambda: pair(rgb, logit1, rois, oh, ow, scale,
                                                                True)
    calls["F.grid_sample rgb + logit C=2 (library, two calls)"] = cs.grid_sample_crops(
        rois, (rgb, logit2))
    x = torch.tensor(rng.random(cs.BINARY_SHAPE), dtype=torch.float32, device="cuda")
    calls["bilateral_filter (32,480,640,1) k=7 sigma (1.5, 0.2)"] = lambda: (
        cuda_kernels.bilateral_filter(x, 7, 1.5, 0.2))
    results = []
    for name, fn in calls.items():
        one = cs.median_ms(fn)
        ten = cs.median_ms(fn, calls=10)
        dev = cs.device_ms_by_kernel(fn)
        results.append({"call": name, "ms": one, "ms_10": ten, "device_ms": dev})
        print(f"{name}: {one:.4f} ms one call, {ten:.4f} ms ten in a row, device ms by kernel "
              f"{ {k: round(v, 4) for k, v in dev.items()} } [{card}]")

    images, rois_np = cs.make_request(rng, b, b)
    images_t = torch.tensor(images, device="cuda", dtype=torch.bfloat16)
    rois_t = torch.tensor(pad_rois(rois_np, b), device="cuda")
    for tail in (False, True):
        model = create_flagship(variant="b0", roi_size=cs.ROI_HW, mask_size=cs.MASK_HW,
                                image_size=cs.IMAGE_HW, mid_channels=128, seed=0,
                                pallas_tail=tail)
        engine = InferenceEngine(model, dilation_pixels=1, dtype=torch.bfloat16, fused_head=True)
        del model
        nhwc = []
        hook = engine.model.unet_wrapper.register_forward_hook(
            lambda m, i, o: nhwc.append(o.permute(0, 2, 3, 1).is_contiguous()))
        seen = kernels_around(lambda: engine.forward(images_t, rois_t), "roi_align")
        hook.remove()
        results.append({"forward": f"pallas_tail={tail}", "roi_align_launches": seen,
                        "wrapper_output_nhwc_contiguous": nhwc[-2:]})
        print(f"served bf16 forward, batch {b} x 1 roi, pallas_tail={tail}: "
              f"{len(seen)} roi_align launches: "
              + "; ".join(f"{s['ms']:.4f} ms after {s['before']}" for s in seen)
              + f"; the wrapper's outputs contiguous as NHWC: {nhwc[-2:]} [{card}]")
        del engine
        torch.cuda.empty_cache()
    return results


def edge_smooth_times(card, rng):
    """``edge_smooth`` at the served binary-mode shape (``chip_smoke.BINARY_SHAPE``)
    on a blob mask: equal to its plain version, then one call between CUDA
    events, ten in a row and device ms by kernel (profiler), beside the plain
    version. Run it alone in a process (``edge``), since later profiler
    sessions of a long process miss kernel events. Runs unchanged in an
    unpacked parent commit (copy this script there), so the parent's kernel
    and this one are timed in one call, in turns."""
    import torch

    import chip_smoke as cs
    from human_instance_segmentation_tpu_torch.ops import _build, cuda_kernels

    mask = cs.blob_mask(rng, cs.BINARY_SHAPE, "cuda")
    _build.library()

    def fn():
        return cuda_kernels.edge_smooth(mask)

    ndiff = int((fn() != cuda_kernels.edge_smooth_plain(mask)).sum())
    if ndiff:
        raise AssertionError(f"edge_smooth: {ndiff} pixels differ")
    entry = None
    for line in _build.build_log.splitlines():  # ptxas -v: registers and spills
        if "entry function" in line:
            entry = "edge_smooth_kernel" in line and line.split("'")[1][-12:]
        elif entry and ("Used" in line or "spill" in line):
            print(f"  ptxas {entry}: {line.strip()}")
    one, ten = cs.median_ms(fn), cs.median_ms(fn, calls=10)
    dev = cs.device_ms_by_kernel(fn)
    plain = cs.median_ms(lambda: cuda_kernels.edge_smooth_plain(mask))
    row = {"ms": one, "ms_10": ten, "device_ms": dev, "plain_ms": plain}
    print(f"edge_smooth {cs.BINARY_SHAPE}: {one:.4f} ms one call, {ten:.4f} ms "
          f"ten in a row, device ms by kernel { {k: round(v, 4) for k, v in dev.items()} }, 0 "
          f"differing pixels; plain {plain:.4f} ms [{card}]")
    torch.cuda.synchronize()
    return row


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from human_instance_segmentation_tpu_torch.ops import _build, cuda_mbconv, cuda_tail

    groups = set(sys.argv[1:]) or {"bf16", "tail_q", "host", "conv_tile", "crops", "edge"}
    card = cs.card_line()
    print(card)
    if groups == {"crops"}:
        print(json.dumps({"card": card, "crops": crops_and_bilateral(card,
                                                                     np.random.default_rng(0))}))
        return
    if groups == {"edge"}:
        print(json.dumps({"card": card, "edge": edge_smooth_times(
            card, np.random.default_rng(0))}))
        return
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, h, w, ci, c = cs.TAIL_SHAPE
    tops = cs.tail_operands(rng, ci, c, torch.bfloat16, dev)
    x = torch.tensor(rng.standard_normal((b, h, w, ci)), dtype=torch.bfloat16, device=dev)
    x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    packed = cuda_tail.pack_tail_weights(*tops)
    blocks = []
    for shape, expand, k, stride, co in cs.MBCONV_SHAPES:
        xm = torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                          device=dev).contiguous(memory_format=torch.channels_last)
        ops = cs.mbconv_operands(rng, shape[1], expand, k, co, torch.bfloat16, dev)
        we, be, wdw, bdw, wr, br, ws, bs, wp, bp = ops
        count = (shape[2] // stride) * (shape[3] // stride)
        sums = cuda_mbconv.mbconv_sums_plain(xm, we, be, wdw, bdw, k, stride)
        se = cuda_mbconv.squeeze_excite(sums, count, wr, br, ws, bs, torch.bfloat16)
        blocks.append((xm, ops, se, k, stride, stride == 1 and shape[1] == co))

    from human_instance_segmentation_tpu_torch.ops import cuda_head

    qops = cs.tail_operands(rng, ci, c, torch.bfloat16, dev)
    sx, sm, sh = cs.tail_q_scales(x, qops)
    qpacked = cuda_tail.pack_tail_weights_q(cuda_tail.build_tail_weights_q(*qops, sx, sm, sh),
                                            qops, torch.bfloat16)

    def tail_q():
        return cuda_tail.tail_q(x, *qops, sx, sm, sh, packed=qpacked)

    n, hh, ww, cc = cs.HEAD_SHAPE
    xh = torch.tensor(rng.standard_normal(cs.HEAD_SHAPE), dtype=torch.bfloat16, device=dev)
    wh = torch.tensor(rng.standard_normal((3, 3, cc, cc)) / (9 * cc) ** 0.5, dtype=torch.bfloat16,
                      device=dev)
    hb, hg, hbe = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (
        rng.standard_normal(cc) * 0.1, 1 + rng.standard_normal(cc) * 0.2,
        rng.standard_normal(cc) * 0.1))
    hops = cuda_head.prepare_bf16(wh, hb, hg, hbe)

    def conv_ln_act():
        return cuda_head.conv_ln_act(xh, wh, hb, hg, hbe, height=hh, width=ww, prepared=hops)

    results = []
    if "host" in groups:
        _build.DEFINES = ()
        _build.library()
        results.append(host_profile("tail_q", tail_q, card))
        results.append(host_profile("conv_ln_act bf16", conv_ln_act, card))
    for tile in CONV_TILES if "conv_tile" in groups else []:
        _build.DEFINES = (f"HIST_BF16_TILE={tile}",) if tile else ()
        _build.library()
        ms = cs.median_ms(conv_ln_act, calls=10)
        split = cs.device_ms_by_kernel(conv_ln_act)
        results.append({"conv_ln_act_tile": tile, "ms_10": ms, "device_ms": split})
        print(f"HIST_BF16_TILE={tile:4d}: conv_ln_act bf16 {ms:.4f} ms (ten launches in a row), "
              f"device ms by kernel { {k: round(v, 4) for k, v in split.items()} } [{card}]")
    for name, mask in VARIANTS_Q if "tail_q" in groups else []:
        _build.DEFINES = (f"HIST_SKIP={mask}",) if mask else ()
        t0 = time.perf_counter()
        _build.library()
        built = time.perf_counter() - t0
        ms = cs.median_ms(tail_q, calls=10)
        results.append({"variant": name, "HIST_SKIP": mask, "tail_q_ms": ms, "build_s": built})
        print(f"HIST_SKIP={mask:5d} {name}: tail_q {ms:.4f} ms (build {built:.1f} s) [{card}]")
    for name, mask in VARIANTS if "bf16" in groups else []:
        _build.DEFINES = (f"HIST_SKIP={mask}",) if mask else ()
        t0 = time.perf_counter()
        _build.library()
        built = time.perf_counter() - t0
        tail_ms = cs.median_ms(lambda: cuda_tail.tail(x, *tops, packed=packed), calls=10)
        sums_ms = apply_ms = 0.0
        for xm, ops, se, k, stride, res in blocks:
            we, be, wdw, bdw, _, _, _, _, wp, bp = ops
            sums_ms += cs.median_ms(lambda: cuda_mbconv.mbconv_sums(
                xm, we, be, wdw, bdw, kernel=k, stride=stride), calls=10)
            apply_ms += cs.median_ms(lambda: cuda_mbconv.mbconv_apply(
                xm, se, we, be, wdw, bdw, wp, bp, kernel=k, stride=stride, residual=res),
                calls=10)
        row = {"variant": name, "HIST_SKIP": mask, "tail_ms": tail_ms, "mbconv_sums_ms": sums_ms,
               "mbconv_apply_ms": apply_ms, "build_s": built}
        results.append(row)
        print(f"HIST_SKIP={mask:4d} {name}: tail {tail_ms:.4f} ms, MBConv sums {sums_ms:.4f} ms, "
              f"apply {apply_ms:.4f} ms (six blocks; build {built:.1f} s) [{card}]")
    _build.DEFINES = ()
    if "crops" in groups:
        results.append({"crops": crops_and_bilateral(card, rng)})
    if "edge" in groups:
        results.append({"edge": edge_smooth_times(card, rng)})
    print(json.dumps({"card": card, "tail_shape": cs.TAIL_SHAPE, "head_shape": cs.HEAD_SHAPE,
                      "mbconv_shapes": cs.MBCONV_SHAPES, "results": results}))


if __name__ == "__main__":
    main()
