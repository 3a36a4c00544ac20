"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs CUDA, ``nvcc`` and this repository's ``human_instance_segmentation_tpu_torch``
package beside the script; it imports nothing of JAX. Phases:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels (``ops/_build.py``) and time it;
3. kernels: each kernel against its plain PyTorch version at main-path
   shapes (TF32 off), with the stated tolerances, and timed;
4. slice: the B0 flagship served through ``InferenceEngine(bf16,
   fused_head=True)`` for three request shapes, launch counts asserted per
   forward, outputs held against the same weights served with
   ``fused_head=False`` and ``pallas_roi_align=False`` (the plain path) in
   float32 and in bf16 (see :func:`serve_and_compare`); repeated at
   ``mid_channels=256``;
5. timing: batch 32 x 1 ROI forwards, kernel path vs plain path;
6. int8 kernels (:func:`check_int8_kernels`): (a) the s8 conv (qconv2d)
   against its plain version at the slice's shapes, max abs error 0; (b)
   s8_matmul: the 256x256 all-ones probe and a 4096^3 GEMM, exact, timed
   against the card's int8 peak; (c) conv_ln_act's int8 form against its
   plain version at ``HEAD_SHAPE``;
7. int8 slice (:func:`serve_int8`): (d) the flagship served with
   ``quantize="int8", fused_head=True`` in bf16 at mid 128 and 256, launch
   counts asserted per forward; (e) held against its plain path (the same
   graph, weights and scales with ``kernels=False`` and
   ``pallas_roi_align=False``) in float32 and bf16;
8. (f) batch 32 x 1 ROI forwards, bf16 kernel path vs int8 kernel path,
   and the int8 QConvs' share of stage-2 device time (``torch.profiler``,
   with the 12 kernels that take the most device time).

``python3 chip_smoke.py --phases 1,2,6`` runs a subset (for bring-up); the
contract run takes no arguments.

It prints a JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# conv_ln_act at the EnhancedUNet bottleneck of the flagship: 16x12 pixels at
# 384 channels (base 96, depth 3), one map per ROI; bench.py's batch is 32.
HEAD_SHAPE = (32, 16, 12, 384)
IMAGE_HW = (480, 640)
ROI_HW = (64, 48)
MASK_HW = (128, 96)
# conv_ln_act: |kernel - plain| <= atol + rtol * |plain|. The kernel and the
# plain version both normalise in float32; in bf16 the output is rounded
# once at the end, so where the residual lifts |y| to 4-8 the two can land
# one bf16 ulp (2^-7 relative) apart on top of the 3e-2 on the LN part.
TOL_CONV = {"float32": (1e-4, 0.0), "bfloat16": (3e-2, 2.0 ** -7)}
TOL_ROI_F32 = 1e-5
ROI_BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the output, relative
TIMING_REPS = 20
# s8 conv shapes of the served int8 slice (batch 32 x 1 ROI): N, H, W, Ci,
# Co, k. bott_conv (3x3 at 384 on the 16x12 bottleneck); feature_combiner
# (1x1, 258 = 256 RGB features + 2 logit channels); final_out (1x1, 48 -> 2
# on the 64x48 ROI map); decoder4/conv0 (3x3, 32 -> 16 at 480x640).
QCONV_SHAPES = {
    "bott_conv": (32, 16, 12, 384, 384, 3),
    "feature_combiner": (32, 64, 48, 258, 256, 1),
    "final_out": (32, 64, 48, 48, 2, 1),
    "decoder4/conv0": (32, 480, 640, 32, 16, 3),
}
# float32 kernel path vs plain path end to end: least instance agreement
MIN_AGREE = 0.995
INT8_PEAK_TOPS = 1979.0  # H100 SXM dense int8 (NVIDIA data sheet, at 700 W)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def unfused_chain(x, w, b, gamma, beta):
    """What the model runs with ``fused_head=False``, as a zero-argument
    callable: a bf16 conv, then LayerNorm2d and ReLU as separate ops."""
    import torch
    import torch.nn.functional as F

    from human_instance_segmentation_tpu_torch.ops.norms import LayerNorm2d

    ln = LayerNorm2d(x.shape[-1]).to(device=x.device, dtype=x.dtype)
    with torch.no_grad():
        ln.weight.copy_(gamma)
        ln.bias.copy_(beta)
    xc, wc, bc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b.to(x.dtype)
    k = w.shape[0]
    return lambda: torch.relu(ln(F.conv2d(xc, wc, bc, padding=k // 2)))


def check_kernels(card: str, rng) -> list:
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align

    dev = torch.device("cuda")
    results = []

    # ---- conv_ln_act ----------------------------------------------------
    n, h, w, c = HEAD_SHAPE
    worst = 0.0
    timing = None
    # the served shape, plus a ragged one (channels not divisible by 8, a
    # partial pixel tile) for the scalar-staged fallback
    cases = [((n, h, w, c), k, res, dt) for dt in (torch.float32, torch.bfloat16)
             for k, res in ((3, False), (3, True), (1, False))]
    cases += [((3, 5, 7, 260), 3, True, dt) for dt in (torch.float32, torch.bfloat16)]
    for shape, k, res, dt in cases:
        cn, ch, cw, cc = shape
        x = torch.tensor(rng.standard_normal(shape), dtype=dt, device=dev)
        wt = torch.tensor(rng.standard_normal((k, k, cc, cc)) / (k * k * cc) ** 0.5,
                          dtype=dt, device=dev)
        b = torch.tensor(rng.standard_normal(cc) * 0.1, dtype=torch.float32, device=dev)
        g = torch.tensor(1 + rng.standard_normal(cc) * 0.2, dtype=torch.float32, device=dev)
        be = torch.tensor(rng.standard_normal(cc) * 0.1, dtype=torch.float32, device=dev)
        r = torch.tensor(rng.standard_normal(shape), dtype=dt, device=dev) if res else None
        got = cuda_head.conv_ln_act(x, wt, b, g, be, r, height=ch, width=cw, kernel=k)
        torch.cuda.synchronize()
        ref = cuda_head.conv_ln_act_plain(x, wt, b, g, be, r, kernel=k)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"conv_ln_act k={k} res={res} {dt}: non-finite output")
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        atol, rtol = TOL_CONV[str(dt).split(".")[1]]
        ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        print(f"conv_ln_act {tuple(x.shape)} k={k} residual={res} {dt}: "
              f"max_abs_err={err:.3e} (atol {atol}, rtol {rtol})")
        if not ok:
            raise AssertionError(f"conv_ln_act k={k} res={res} {dt}: {err}")
        worst = max(worst, err)
        if (shape, k, res, dt) == (HEAD_SHAPE, 3, False, torch.bfloat16):  # the served form
            kms = median_ms(lambda: cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w))
            pms = median_ms(lambda: cuda_head.conv_ln_act_plain(x, wt, b, g, be))
            cms = median_ms(unfused_chain(x, wt, b, g, be))
            timing = (kms, pms)
            print(f"conv_ln_act bf16 k=3 {HEAD_SHAPE}->{c}: kernel {kms:.4f} ms, plain "
                  f"{pms:.4f} ms, unfused bf16 chain {cms:.4f} ms (median of {TIMING_REPS}, "
                  f"CUDA events) [{card}]")
    results.append({"name": "conv_ln_act", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/conv_ln_act.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_head.py:243",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]})

    # ---- roi_align ------------------------------------------------------
    nroi = n
    rois = rng.random((nroi, 5)).astype("float32")
    rois[:, 0] = rng.integers(0, n, nroi)
    lo = rng.random((nroi, 2)) * 0.5
    rois[:, 1:3] = lo
    rois[:, 3:5] = lo + 0.1 + rng.random((nroi, 2)) * 0.4
    rois[0] = [-1.0, 0.1, 0.1, 0.5, 0.5]         # sentinel
    rois[1] = [1.0, 0.5, 0.25, 1.0, 1.0]         # right/bottom edge at exactly 1.0
    rois[2] = [2.0, 0.3, 0.4, 0.3, 0.4]          # degenerate box
    rois[3] = [3.0, -0.1, -0.05, 0.2, 0.3]       # hangs past the top-left corner
    rois_t = torch.tensor(rois, device=dev)
    worst = 0.0
    timing = None
    scale = (float(IMAGE_HW[0]), float(IMAGE_HW[1]))
    for ch in (3, 2):
        feats32 = torch.tensor(rng.standard_normal((n, *IMAGE_HW, ch)), dtype=torch.float32,
                               device=dev)
        for dt in (torch.float32, torch.bfloat16):
            feats = feats32.to(dt)
            for aligned in (True, False):
                args = (feats, rois_t, ROI_HW[0], ROI_HW[1])
                got = cuda_roi_align.roi_align(*args, spatial_scale=scale, aligned=aligned)
                torch.cuda.synchronize()
                ref = cuda_roi_align.roi_align_plain(*args, spatial_scale=scale, aligned=aligned)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                err = diff.max().item()
                if dt == torch.float32:
                    ok = err <= TOL_ROI_F32
                    tol = f"atol {TOL_ROI_F32}"
                    worst = max(worst, err)
                else:
                    ok = bool((diff <= 1e-6 + ROI_BF16_RTOL * ref.float().abs()).all())
                    tol = "1 bf16 ulp (rtol 2^-7)"
                print(f"roi_align {tuple(feats.shape)} -> {ROI_HW} {dt} aligned={aligned}: "
                      f"max_abs_err={err:.3e} ({tol})")
                if not ok:
                    raise AssertionError(f"roi_align C={ch} {dt} aligned={aligned}: {err}")
                if ch == 3 and dt == torch.bfloat16 and aligned:  # the served RGB crop
                    kms = median_ms(lambda: cuda_roi_align.roi_align(
                        *args, spatial_scale=scale, aligned=True))
                    pms = median_ms(lambda: cuda_roi_align.roi_align_plain(
                        *args, spatial_scale=scale, aligned=True))
                    timing = (kms, pms)
                    print(f"roi_align bf16 {tuple(feats.shape)} x {nroi} rois -> {ROI_HW}: "
                          f"kernel {kms:.4f} ms, plain {pms:.4f} ms (median of {TIMING_REPS}, "
                          f"CUDA events) [{card}]")
    results.append({"name": "roi_align", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/roi_align.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_roi_align.py:128",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]})
    return results


def make_request(rng, batch: int, nrois: int):
    import numpy as np

    images = rng.random((batch, *IMAGE_HW, 3), dtype=np.float32)
    rois = np.zeros((nrois, 5), np.float32)
    rois[:, 0] = np.arange(nrois) % batch
    lo = rng.random((nrois, 2)) * 0.5
    rois[:, 1:3] = lo
    rois[:, 3:5] = lo + 0.2 + rng.random((nrois, 2)) * 0.3
    return images, rois


def _agreement(a, b) -> float:
    return float((a == b).mean())


def serve_and_compare(mid: int, rng):
    """Serve three request shapes through the kernel path (the main path:
    bf16, fused_head, gather RoIAlign) and check it.

    Launch counts are asserted per forward. With random weights many
    logits sit near a tie and the dilation boost turns bf16 rounding into
    flipped pixels: the plain path in bf16 agrees with itself in float32
    on only ~0.988 of the instance pixels. So the slice is held to its
    plain path (same weights, ``fused_head=False``,
    ``pallas_roi_align=False``) twice: in float32 with binary max-abs
    <= 1e-2 and instance agreement >= 0.995, and in bf16 with binary
    max-abs <= 1e-2 and an instance agreement with the float32 plain path
    no more than 0.002 below the bf16 plain path's own (the kernels add no
    error beyond bf16's). Returns (launch counts, served engine, bf16 plain
    engine)."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.inference import InferenceEngine, create_flagship
    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align

    def engine(dtype, kernels: bool):
        model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                                image_size=IMAGE_HW, mid_channels=mid, seed=0, device="cuda",
                                pallas_roi_align=kernels)
        return InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=kernels)

    served = engine(torch.bfloat16, True)
    requests = [make_request(rng, 4, 3), make_request(rng, 8, 8), make_request(rng, 32, 32)]

    outs = []
    cuda_head.conv_ln_act.launches = 0
    cuda_roi_align.roi_align.launches = 0
    for images, rois in requests:
        c0, r0 = cuda_head.conv_ln_act.launches, cuda_roi_align.roi_align.launches
        outs.append(served(images, rois))
        dc = cuda_head.conv_ln_act.launches - c0
        dr = cuda_roi_align.roi_align.launches - r0
        print(f"mid{mid} batch {images.shape[0]} x {rois.shape[0]} rois: conv_ln_act launches "
              f"{dc}, roi_align launches {dr} (one forward)")
        if (dc, dr) != (5, 2):
            raise AssertionError(f"expected 5 conv_ln_act and 2 roi_align launches, got {dc}, {dr}")
    launches = {"conv_ln_act": cuda_head.conv_ln_act.launches,
                "roi_align": cuda_roi_align.roi_align.launches}

    plain_bf16 = engine(torch.bfloat16, False)
    others = {"plain bf16": plain_bf16, "served f32": engine(torch.float32, True),
              "plain f32": engine(torch.float32, False)}
    for (images, rois), (inst, binary) in zip(requests, outs):
        b, n = images.shape[0], rois.shape[0]
        if inst.shape != (n, *MASK_HW, 1) or binary.shape != (b, *IMAGE_HW, 1):
            raise AssertionError(f"bad output shapes {inst.shape}, {binary.shape}")
        if not (np.isfinite(inst).all() and np.isfinite(binary).all()):
            raise AssertionError("non-finite outputs")
        if not set(np.unique(inst)) <= {0.0, 1.0}:
            raise AssertionError("instance masks are not binary")
        c0 = cuda_head.conv_ln_act.launches
        o = {name: e(images, rois) for name, e in others.items()}
        if cuda_head.conv_ln_act.launches == c0:
            raise AssertionError("the float32 served path launched no conv_ln_act")
        o["served bf16"] = (inst, binary)
        tag = f"mid{mid} batch {b} x {n} rois"
        bin_f32 = float(np.abs(o["served f32"][1] - o["plain f32"][1]).max())
        agree_f32 = _agreement(o["served f32"][0], o["plain f32"][0])
        print(f"{tag} f32 served vs plain: binary max_abs_err {bin_f32:.3e} (tol 1e-2), "
              f"instance agreement {agree_f32:.6f} (min {MIN_AGREE})")
        bin_bf16 = float(np.abs(binary - o["plain bf16"][1]).max())
        agree_bf16 = _agreement(inst, o["plain bf16"][0])
        agree_k = _agreement(inst, o["plain f32"][0])
        agree_p = _agreement(o["plain bf16"][0], o["plain f32"][0])
        print(f"{tag} bf16 served vs plain: binary max_abs_err {bin_bf16:.3e} (tol 1e-2), "
              f"instance agreement {agree_bf16:.6f}; vs f32 plain: served {agree_k:.6f}, "
              f"plain bf16 {agree_p:.6f} (served >= plain - 0.002); fg share {inst.mean():.4f}")
        if not (bin_f32 <= 1e-2 and agree_f32 >= MIN_AGREE):
            raise AssertionError(f"{tag}: f32 slice disagrees with its plain path")
        if not (bin_bf16 <= 1e-2 and agree_k >= agree_p - 0.002):
            raise AssertionError(f"{tag}: bf16 slice is further from f32 than its plain path")
    return launches, served, plain_bf16


def time_forwards(served, plain, card: str, rng) -> None:
    import torch

    from human_instance_segmentation_tpu_torch.inference import pad_rois

    batch = 32
    images, rois = make_request(rng, batch, batch)
    images_t = torch.tensor(images, device="cuda", dtype=torch.bfloat16)
    rois_t = torch.tensor(pad_rois(rois, batch), device="cuda")
    times = {"kernel": [], "plain": []}
    engines = {"kernel": served, "plain": plain}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(median_ms(lambda: engines[name].forward(images_t, rois_t),
                                     reps=TIMING_REPS // 2))
    for name, ms in times.items():
        med = statistics.median(ms)
        print(f"forward batch {batch} x 1 roi, bf16, {name} path: {med:.3f} ms/batch, "
              f"{batch / med * 1e3:.1f} img/s (median of per-round medians {ms}, "
              f"{TIMING_REPS // 2} forwards each, CUDA events) [{card}]")


def unaligned(t):
    """A contiguous copy of t that starts one element past an aligned
    address (the s8 kernel's staging pass then reads it value by value)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_int8_kernels(card: str, rng) -> list:
    """Phases (a)-(c): the s8 conv (qconv2d, s8_matmul) and conv_ln_act's
    int8 form against their plain versions on the card."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_head, quant

    dev = torch.device("cuda")
    results = []

    # ---- (a) qconv2d at the slice's shapes: bitwise equal ---------------
    timing, worst = None, 0.0
    for name, (n, h, w, ci, co, k) in QCONV_SHAPES.items():
        x32 = torch.tensor(rng.standard_normal((n, h, w, ci)), dtype=torch.float32, device=dev)
        w32 = torch.tensor(rng.standard_normal((k, k, ci, co)) / (k * k * ci) ** 0.5,
                           dtype=torch.float32, device=dev)
        sx = float(x32.abs().max()) / 127.0 * 0.8  # some activations clip
        xq = quant.quantize_symmetric(x32, sx)
        cases = [(torch.float32, "static", x32), (torch.bfloat16, "static", x32),
                 (torch.bfloat16, "int8 input", xq), (torch.float32, "dynamic", x32),
                 (torch.bfloat16, "int8 input, unaligned", unaligned(xq)),
                 (torch.bfloat16, "static, unaligned", unaligned(x32.to(torch.bfloat16)))]
        for dt, mode, xin in cases:
            xin = xin if xin.dtype in (torch.int8, dt) else xin.to(dt)
            wt = w32.to(dt)
            scale = None if mode == "dynamic" else sx
            got = quant.qconv2d(xin, wt, 1, k // 2, scale)
            torch.cuda.synchronize()
            ref = quant.qconv2d_plain(xin, wt, 1, k // 2, scale)
            err = (got.float() - ref.float()).abs().max().item()
            print(f"qconv2d {name} {tuple(xin.shape)}->{co} k={k} {dt} {mode}: "
                  f"max_abs_err={err:.3e} (tol 0)")
            if got.dtype != ref.dtype or err != 0.0 or not torch.isfinite(got.float()).all():
                raise AssertionError(f"qconv2d {name} {dt} {mode}: {err}")
            worst = max(worst, err)
            del got, ref
        xb = x32.to(torch.bfloat16)
        wb = w32.to(torch.bfloat16)
        kms = median_ms(lambda: quant.qconv2d(xb, wb, 1, k // 2, sx))
        pms = median_ms(lambda: quant.qconv2d_plain(xb, wb, 1, k // 2, sx), reps=5, warmup=1)
        xc, wc = xb.permute(0, 3, 1, 2).contiguous(), wb.permute(3, 2, 0, 1).contiguous()
        cms = median_ms(lambda: torch.nn.functional.conv2d(xc, wc, padding=k // 2))
        perm = median_ms(lambda: xc.permute(0, 2, 3, 1).contiguous())
        print(f"qconv2d {name} bf16 {tuple(xb.shape)}->{co} k={k}: kernel {kms:.4f} ms, plain "
              f"(float64) {pms:.4f} ms, bf16 cuDNN conv (NCHW) {cms:.4f} ms, NCHW->NHWC "
              f"permute of the input {perm:.4f} ms [{card}]")
        if name == "decoder4/conv0":
            timing = (kms, pms)
        del x32, w32, xq, xb, wb, xc, wc
        torch.cuda.empty_cache()

    # ---- (b) s8_matmul: the probe and a 4096^3 GEMM ----------------------
    ones = torch.ones((256, 256), dtype=torch.int8, device=dev)
    probe = quant.s8_matmul(ones, ones)
    torch.cuda.synchronize()
    if not bool((probe == 256).all()):
        raise AssertionError("s8_matmul 256x256 all-ones probe: not every entry is 256")
    print("s8_matmul 256x256 all-ones probe: every entry 256")
    m = 4096
    a = torch.randint(-127, 128, (m, m), dtype=torch.int8, device=dev)
    b = torch.randint(-127, 128, (m, m), dtype=torch.int8, device=dev)
    got = quant.s8_matmul(a, b)
    torch.cuda.synchronize()
    err = (got.to(torch.float64) - quant.s8_matmul_plain(a, b).to(torch.float64)).abs().max().item()
    print(f"s8_matmul {m}^3: max_abs_err={err} (tol 0)")
    if err != 0.0:
        raise AssertionError(f"s8_matmul {m}^3: {err}")
    worst = max(worst, err)
    gms = median_ms(lambda: quant.s8_matmul(a, b))
    gpms = median_ms(lambda: quant.s8_matmul_plain(a, b), reps=5, warmup=1)
    tops = 2 * m ** 3 / (gms * 1e-3) / 1e12
    print(f"s8_matmul {m}^3: kernel {gms:.4f} ms = {tops:.1f} TOPS "
          f"({100 * tops / INT8_PEAK_TOPS:.1f}% of the {INT8_PEAK_TOPS:.0f} TOPS dense int8 "
          f"peak), plain (float64 GEMM) {gpms:.4f} ms [{card}]")
    del a, b, got
    results.append({"name": "qconv", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/qconv.cu",
                    "replaces": "scripts/exp_r4_probe.py:86",
                    "also_replaces": "scripts/exp_r4_probe.py:59",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    "s8_matmul_4096_ms": gms, "s8_matmul_4096_tops": tops})

    # ---- (c) conv_ln_act, int8 form --------------------------------------
    n, h, w, c = HEAD_SHAPE
    worst, timing = 0.0, None
    cases = [((n, h, w, c), k, res, dt) for dt in (torch.float32, torch.bfloat16)
             for k, res in ((3, False), (3, True), (1, False))]
    cases += [((3, 5, 7, 260), 3, True, dt) for dt in (torch.float32, torch.bfloat16)]
    for shape, k, res, dt in cases:
        cn, ch, cw, cc = shape
        x = torch.tensor(rng.standard_normal(shape), dtype=dt, device=dev)
        wt = torch.tensor(rng.standard_normal((k, k, cc, cc)) / (k * k * cc) ** 0.5,
                          dtype=dt, device=dev)
        b = torch.tensor(rng.standard_normal(cc) * 0.1, dtype=torch.float32, device=dev)
        g = torch.tensor(1 + rng.standard_normal(cc) * 0.2, dtype=torch.float32, device=dev)
        be = torch.tensor(rng.standard_normal(cc) * 0.1, dtype=torch.float32, device=dev)
        r = torch.tensor(rng.standard_normal(shape), dtype=dt, device=dev) if res else None
        xs = float(x.float().abs().max()) / 127.0 * 0.9
        got = cuda_head.conv_ln_act(x, wt, b, g, be, r, height=ch, width=cw, kernel=k, xscale=xs)
        torch.cuda.synchronize()
        ref = cuda_head.conv_ln_act_plain(x, wt, b, g, be, r, kernel=k, xscale=xs)
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        atol, rtol = TOL_CONV[str(dt).split(".")[1]]
        print(f"conv_ln_act s8 {tuple(x.shape)} k={k} residual={res} {dt}: "
              f"max_abs_err={err:.3e} (atol {atol}, rtol {rtol})")
        if not (bool((diff <= atol + rtol * ref.float().abs()).all())
                and torch.isfinite(got.float()).all()):
            raise AssertionError(f"conv_ln_act s8 k={k} res={res} {dt}: {err}")
        worst = max(worst, err)
        if (shape, k, res, dt) == (HEAD_SHAPE, 3, False, torch.bfloat16):  # the served form
            kms = median_ms(lambda: cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w,
                                                          xscale=xs))
            pms = median_ms(lambda: cuda_head.conv_ln_act_plain(x, wt, b, g, be, xscale=xs))
            bms = median_ms(lambda: cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w))
            timing = (kms, pms)
            print(f"conv_ln_act s8 bf16 k=3 {HEAD_SHAPE}->{c}: kernel {kms:.4f} ms, plain "
                  f"{pms:.4f} ms, bf16 conv_ln_act kernel {bms:.4f} ms (median of "
                  f"{TIMING_REPS}, CUDA events) [{card}]")
    results.append({"name": "conv_ln_act_s8", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/conv_ln_act.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_head.py:243",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]})
    return results


def int8_engine(mid: int, dtype, kernels: bool, scales=None):
    """The B0 flagship served with ``quantize="int8", fused_head=True``: the
    kernel path, or (``kernels=False``) the same graph computed by the
    plain versions (plain fused unit and s8 conv, plain crops)."""
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine, create_flagship

    model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                            image_size=IMAGE_HW, mid_channels=mid, seed=0, device="cuda",
                            pallas_roi_align=kernels)
    engine = InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=True,
                             quantize="int8", kernels=kernels)
    engine.scales = dict(scales) if scales is not None else None
    return engine


def check_int8_calls(engine, images, rois) -> dict:
    """Serve one request and hold every s8 kernel call of that forward
    against its plain version on the very inputs the forward gave it:
    qconv2d exactly, conv_ln_act's int8 form within ``TOL_CONV``. Returns
    {kernel: (calls checked, max abs error)}."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_head, quant

    real_q, real_c = quant.qconv2d, cuda_head.conv_ln_act
    seen = {"qconv": [0, 0.0], "conv_ln_act_s8": [0, 0.0]}

    def qconv(x, w, stride=1, padding=0, static_scale=None, wq=None):
        y = real_q(x, w, stride, padding, static_scale, wq)
        ref = quant.qconv2d_plain(x, w, stride, padding, static_scale)  # weights quantized anew
        err = (y.float() - ref.float()).abs().max().item()
        if y.dtype != ref.dtype or err != 0.0:
            raise AssertionError(f"qconv2d {tuple(x.shape)}x{tuple(w.shape)} in the forward: {err}")
        seen["qconv"][0] += 1
        return y

    def fused(*args, **kwargs):
        y = real_c(*args, **kwargs)
        if kwargs.get("xscale") is not None:
            plain_kw = {k: v for k, v in kwargs.items() if k not in ("height", "width")}
            ref = cuda_head.conv_ln_act_plain(*args, **plain_kw)
            diff = (y.float() - ref.float()).abs()
            atol, rtol = TOL_CONV[str(y.dtype).split(".")[1]]
            if not bool((diff <= atol + rtol * ref.float().abs()).all()):
                raise AssertionError(f"conv_ln_act s8 in the forward: {diff.max().item()}")
            seen["conv_ln_act_s8"][0] += 1
            seen["conv_ln_act_s8"][1] = max(seen["conv_ln_act_s8"][1], diff.max().item())
        return y

    # the wrappers' own launch counters resolve to these names while patched
    qconv.launches = fused.launches = 0
    quant.qconv2d, cuda_head.conv_ln_act = qconv, fused
    try:
        engine(images, rois)
    finally:
        quant.qconv2d, cuda_head.conv_ln_act = real_q, real_c
    torch.cuda.synchronize()
    return {k: tuple(v) for k, v in seen.items()}


def serve_int8(mid: int, rng):
    """Phases (d) and (e) at one head width. Returns (launch counts of the
    served forwards, the served engine).

    The int8 graph amplifies float32 rounding: a value moved by one ulp
    can cross a quantizer's rounding boundary, that whole code moves the
    next layer's inputs further, and with random weights the dilation boost
    turns the near-ties into flipped pixels. So the kernel path and the
    plain path must compute the same float32 values: the s8 convs are
    exact, conv_ln_act sums its LayerNorm statistics in float64 in both
    versions, and the plain versions return the kernels' NHWC layout. The
    float32 kernel path is held end to end (binary max-abs <= 1e-2,
    instance agreement >= MIN_AGREE) and call by call
    (:func:`check_int8_calls`: each s8 kernel call of the forward against
    its plain version on the forward's own inputs); bf16 is gated as in
    :func:`serve_and_compare`."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align, quant

    served = int8_engine(mid, torch.bfloat16, True)
    requests = [make_request(rng, 4, 3), make_request(rng, 8, 8)]
    served.calibrate(*requests[0])
    qconvs = [m for m in served.model.modules() if isinstance(m, quant.QConv)]

    counters = {"conv_ln_act": cuda_head.conv_ln_act, "conv_ln_act_s8": cuda_head.conv_ln_act_s8,
                "qconv": quant.qconv2d, "roi_align": cuda_roi_align.roi_align}
    for f in counters.values():
        f.launches = 0
    outs = []
    for images, rois in requests:
        c0 = {k: f.launches for k, f in counters.items()}
        q0 = quant.QConv.int8_calls
        outs.append(served(images, rois))
        d = {k: f.launches - c0[k] for k, f in counters.items()}
        marked = sum(m.runs_int8 for m in qconvs)
        ran = quant.QConv.int8_calls - q0
        print(f"int8 mid{mid} batch {images.shape[0]} x {rois.shape[0]} rois: launches {d}; "
              f"QConvs marked int8 {marked}, int8 QConv forwards {ran} (one forward)")
        if (d["conv_ln_act"], d["conv_ln_act_s8"], d["roi_align"]) != (0, 5, 2):
            raise AssertionError(f"expected 0 bf16 + 5 s8 conv_ln_act and 2 roi_align, got {d}")
        if d["qconv"] + d["conv_ln_act_s8"] != marked or ran != d["qconv"]:
            raise AssertionError("an int8 QConv bypassed the qconv kernel")
    launches = {k: f.launches for k, f in counters.items()}

    scales = served.scales
    plain_bf16 = int8_engine(mid, torch.bfloat16, False, scales)
    others = {"plain bf16": plain_bf16, "served f32": int8_engine(mid, torch.float32, True, scales),
              "plain f32": int8_engine(mid, torch.float32, False, scales)}
    for (images, rois), (inst, binary) in zip(requests, outs):
        b, n = images.shape[0], rois.shape[0]
        if inst.shape != (n, *MASK_HW, 1) or binary.shape != (b, *IMAGE_HW, 1):
            raise AssertionError(f"bad output shapes {inst.shape}, {binary.shape}")
        if not (np.isfinite(inst).all() and np.isfinite(binary).all()):
            raise AssertionError("non-finite outputs")
        if not set(np.unique(inst)) <= {0.0, 1.0}:
            raise AssertionError("instance masks are not binary")
        o = {name: e(images, rois) for name, e in others.items()}
        o["served bf16"] = (inst, binary)
        tag = f"int8 mid{mid} batch {b} x {n} rois"
        for name in ("served f32", "served bf16"):
            e = others[name] if name in others else served
            calls = check_int8_calls(e, images, rois)
            print(f"{tag} {name.split()[1]} kernel calls vs plain on the forward's own inputs: "
                  f"qconv {calls['qconv'][0]} calls, max_abs_err 0; conv_ln_act s8 "
                  f"{calls['conv_ln_act_s8'][0]} calls, max_abs_err "
                  f"{calls['conv_ln_act_s8'][1]:.3e} (TOL_CONV)")
            if calls["qconv"][0] + calls["conv_ln_act_s8"][0] == 0:
                raise AssertionError(f"{tag} {name}: no s8 kernel call was checked")
        bin_f32 = float(np.abs(o["served f32"][1] - o["plain f32"][1]).max())
        agree_f32 = _agreement(o["served f32"][0], o["plain f32"][0])
        print(f"{tag} f32 kernels vs plain, end to end: binary max_abs_err {bin_f32:.3e} "
              f"(tol 1e-2); instance agreement {agree_f32:.6f} (min {MIN_AGREE})")
        bin_bf16 = float(np.abs(binary - o["plain bf16"][1]).max())
        agree_k = _agreement(inst, o["plain f32"][0])
        agree_p = _agreement(o["plain bf16"][0], o["plain f32"][0])
        print(f"{tag} bf16 kernels vs plain: binary max_abs_err {bin_bf16:.3e} (tol 1e-2), "
              f"instance agreement {_agreement(inst, o['plain bf16'][0]):.6f}; vs f32 plain: "
              f"kernels {agree_k:.6f}, plain bf16 {agree_p:.6f} (kernels >= plain - 0.002); "
              f"fg share {inst.mean():.4f}")
        if not (bin_f32 <= 1e-2 and agree_f32 >= MIN_AGREE):
            raise AssertionError(f"{tag}: f32 int8 slice disagrees with its plain path")
        if not (bin_bf16 <= 1e-2 and agree_k >= agree_p - 0.002):
            raise AssertionError(f"{tag}: bf16 int8 slice is further from f32 than its plain path")
    return launches, served


def time_int8(served_bf16, served_int8, card: str, rng) -> None:
    """Phase (f): batch 32 x 1 ROI forwards and stage-2 calls, bf16 kernel
    path vs int8 kernel path in turns, and a profile of int8 stage 2."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from human_instance_segmentation_tpu_torch.inference import pad_rois
    from human_instance_segmentation_tpu_torch.models.blocks import set_head_fusion
    from human_instance_segmentation_tpu_torch.ops.quant import set_int8_serving

    batch = 32
    images, rois = make_request(rng, batch, batch)
    images_t = torch.tensor(images, device="cuda", dtype=torch.bfloat16)
    rois_t = torch.tensor(pad_rois(rois, batch), device="cuda")
    engines = {"bf16": served_bf16, "int8": served_int8}
    served_int8.calibrate(images, rois)
    crops = {}
    for name, e in engines.items():
        e.forward(images_t, rois_t)  # sets the engine's serving switches on its model
        with torch.inference_mode():
            _, aux = e.model(images_t, rois_t)
        crops[name] = (aux["roi_patches"], aux["roi_bg_fg"])

    def stage2(name):
        e = engines[name]
        set_head_fusion(e.model, e.fused_head, e.kernels)
        set_int8_serving(e.model, e.quantize == "int8", e.scales, e.int8_deny, e.kernels)
        with torch.inference_mode():
            return e.model.stage2(*crops[name])

    fwd = {"bf16": [], "int8": []}
    st2 = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        fwd[name].append(median_ms(lambda: engines[name].forward(images_t, rois_t),
                                   reps=TIMING_REPS // 2))
        st2[name].append(median_ms(lambda: stage2(name), reps=TIMING_REPS // 2))
    for name in ("bf16", "int8"):
        med = statistics.median(fwd[name])
        print(f"forward batch {batch} x 1 roi, {name} kernel path: {med:.3f} ms/batch, "
              f"{batch / med * 1e3:.1f} img/s (median of per-round medians {fwd[name]}, "
              f"{TIMING_REPS // 2} forwards each, CUDA events) [{card}]")
        print(f"stage 2 batch {batch} rois, {name} kernel path: "
              f"{statistics.median(st2[name]):.3f} ms (per-round medians {st2[name]}) [{card}]")

    stage2("int8")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            stage2("int8")
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    qconv = sum(e.self_device_time_total for e in events
                if "conv_kernel" in e.key and ", 0>" in e.key)
    fused = sum(e.self_device_time_total for e in events
                if ("conv_kernel" in e.key and ", 1>" in e.key) or "ln_act_kernel" in e.key)
    print(f"int8 stage 2 profile (3 calls): device total {total / 3e3:.3f} ms per call; qconv "
          f"kernel {qconv / 3e3:.3f} ms ({100 * qconv / max(total, 1):.1f}%), conv_ln_act s8 "
          f"{fused / 3e3:.3f} ms ({100 * fused / max(total, 1):.1f}%) [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 3e3:8.3f} ms/call  {e.count // 3:4d}x  {e.key[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from human_instance_segmentation_tpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    rng = np.random.default_rng(0)
    phases = set(range(1, 9))
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        phases = {int(p) for p in sys.argv[2].split(",")}
    kernels, launches = [], {}
    if 3 in phases:
        kernels += check_kernels(card, rng)
    if 6 in phases:
        kernels += check_int8_kernels(card, rng)
    served = None
    if phases & {4, 5, 8}:
        bf16_launches, served, plain = serve_and_compare(128, rng)
        launches.update(bf16_launches)
        if 5 in phases:
            time_forwards(served, plain, card, rng)
        del plain
        torch.cuda.empty_cache()
    if phases & {7, 8}:
        int8_launches, served_int8 = serve_int8(128, rng)
        launches["conv_ln_act_s8"] = int8_launches["conv_ln_act_s8"]
        launches["qconv"] = int8_launches["qconv"]
        if 8 in phases:
            time_int8(served, served_int8, card, rng)
        del served_int8
    del served
    torch.cuda.empty_cache()
    if 4 in phases:
        serve_and_compare(256, rng)
    if 7 in phases:
        serve_int8(256, rng)

    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    if any(k["launches"] == 0 for k in kernels) and phases >= {3, 4, 6, 7}:
        raise AssertionError(f"a kernel of the main path was never launched: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
