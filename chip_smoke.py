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
5. timing: batch 32 x 1 ROI forwards, kernel path vs plain path.

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
              f"instance agreement {agree_f32:.6f} (min 0.995)")
        bin_bf16 = float(np.abs(binary - o["plain bf16"][1]).max())
        agree_bf16 = _agreement(inst, o["plain bf16"][0])
        agree_k = _agreement(inst, o["plain f32"][0])
        agree_p = _agreement(o["plain bf16"][0], o["plain f32"][0])
        print(f"{tag} bf16 served vs plain: binary max_abs_err {bin_bf16:.3e} (tol 1e-2), "
              f"instance agreement {agree_bf16:.6f}; vs f32 plain: served {agree_k:.6f}, "
              f"plain bf16 {agree_p:.6f} (served >= plain - 0.002); fg share {inst.mean():.4f}")
        if not (bin_f32 <= 1e-2 and agree_f32 >= 0.995):
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
    kernels = check_kernels(card, rng)
    launches, served, plain = serve_and_compare(128, rng)
    time_forwards(served, plain, card, rng)
    del served, plain
    torch.cuda.empty_cache()
    serve_and_compare(256, rng)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
