"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs CUDA, ``nvcc`` and this repository's ``human_instance_segmentation_tpu_torch``
package beside the script; it imports nothing of JAX. Phases:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels (``ops/_build.py``) and time it;
3. kernels: each kernel against its plain PyTorch version at main-path
   shapes (TF32 off), with the stated tolerances, and timed (the bf16
   ``conv_ln_act`` as one call and ten in a row, split by kernel, and it
   must run on wgmma at the served shape); RoIAlign through its pair entry
   point (both served crops in one launch) and its single-map entry against
   two plain calls, timed at the served shapes beside ``F.grid_sample``
   (:func:`check_roi_align`);
4. slice: the B0 flagship served through ``InferenceEngine(bf16,
   fused_head=True)`` for three request shapes, launch counts asserted per
   forward, outputs held against the same weights served with
   ``fused_head=False`` and ``pallas_roi_align=False`` (the plain path) in
   float32 and in bf16 (see :func:`serve_and_compare`); repeated at
   ``mid_channels=256``;
5. timing: batch 32 x 1 ROI forwards, kernel path vs plain path, each
   engine warmed by ``InferenceEngine.warmup`` at the timed shape;
6. int8 kernels (:func:`check_int8_kernels`): (a) the s8 conv (qconv2d)
   against its plain version at ten shapes of the slice (both regimes of
   the kernel, every ragged channel count; float, int8, unaligned, NCHW-memory
   and strided inputs, with and without bias), max abs error 0, each timed
   beside its bound and cuDNN's bf16 conv; (b) s8_matmul: the 256x256
   all-ones probe and a 4096^3 GEMM, exact, timed against the card's int8
   peak and ``torch._int_mm``; (c) conv_ln_act's int8 form against its plain
   version at ``HEAD_SHAPE``, with its device time split by kernel;
7. int8 slice (:func:`serve_int8`): (d) the flagship served with
   ``quantize="int8", fused_head=True`` in bf16 at mid 128 and 256, launch
   counts asserted per forward; (e) held against its plain path (the same
   graph, weights and scales with ``kernels=False`` and
   ``pallas_roi_align=False``) in float32 and bf16;
8. (f) batch 32 x 1 ROI forwards, bf16 kernel path vs int8 kernel path,
   the s8 convs' share of stage-2 device time (``torch.profiler``, with the
   12 kernels that take the most device time), and for the int8 forward its
   device time, kernels, idle share and launches per forward;
9. tail and filters (:func:`check_tail_and_filters`): the fused stage-1
   tail, the bilateral filter and the edge smoothing against their plain
   versions at the slice's shapes (B0, 480x640, batch 32) and at ragged
   ones (the bilateral filter at every unrolled k and a generic one, on
   planes narrower than a tile and on bf16 input; the edge smoothing in its
   four-column and one-column forms, at widths around a warp's edge lanes,
   strips cut short, several planes and a plane off 16-byte alignment),
   timed beside the plain version (the filters also ten in a row and by
   device time) and, for the tail, beside the unfused bf16 chain the model
   runs with ``pallas_tail=False``;
10. flagship with the tail (:func:`serve_with_tail`):
    ``create_flagship(pallas_tail=True)`` served in bf16 and float32, 1 tail
    + 5 conv_ln_act + 1 roi_align launch per forward, held against the
    same weights with ``pallas_tail=False``;
11. binary-mask mode (:func:`binary_mask_mode`): ``postprocess.binary_mode``
    (UNet with the tail -> person probability -> ``binary_mask_bilateral`` ->
    edge smoothing -> 1 px dilation), and the exact bilateral filter on the
    same probability,
    at batch 32, one launch of each of the three kernels per batch, held
    against the plain versions, ms per batch;
12. fused MBConv and the int8 tail (:func:`check_mbconv_and_tail_q`): both
    passes of ``fused_mbconv`` against their plain versions at the six block
    shapes the B0 encoder gives them at batch 32 and at ragged ones, and
    ``tail_q`` against ``tail_q_plain`` (interior equal, float border within
    the float tail's tolerance) for float and int8 inputs, timed beside the
    plain versions and the chains the model would run without them; a served
    ``tail_q`` call must allocate only its output and launch only its own
    kernel (profiler listing), with the SM clock and power sampled;
13. the slice that runs both (:func:`serve_fused_encoder_and_tail_q`):
    ``create_flagship(pallas_tail=True, encoder_fused_blocks=N)`` for N = 3
    and 6, served in bf16 without quantization and with ``quantize="int8"``,
    launch counts asserted per forward, outputs held against
    ``kernels=False`` and (unquantized, float32) against the model without
    either flag, forward times beside N = 0 and a device-time profile;
14. training (:func:`train_entry_point`, :func:`train_step_kernels`,
    :func:`time_train_steps`): (a) ``run_training`` on the deployed B0
    config at 480 x 640, synthetic, bf16, 5 steps, with ``pallas_tail`` and
    ``encoder_fused_blocks=6`` (every step finite, launches of the run
    asserted: a stage-1 forward a step, a validation batch and the
    end-of-run picture, the checkpoint restored to an equal state, the trained model
    served against its plain path with phase 4's gates); (b) the train step
    with both stage-1 kernels against the same weights without them in
    float32 and bf16 (6 + 6 ``fused_mbconv`` and 1 ``tail`` launch a step;
    bounds in ``TOL_STAGE1_F32``'s comment), and again after a step that
    decays the frozen weights; (c) ms per bf16 step and images per second,
    kernels and plain stage 1, device busy time, idle share and the
    largest kernels, peak memory;
15. the other families and the refinement flags (:func:`serve_rgb_family`,
    :func:`train_roi_family`, :func:`train_and_serve_a3_flagship`): (a) the
    pure-RGB config ``rgb_hierarchical_unet_v2_attention_r64m64`` at its
    sizes (640 x 640, 64 x 64 ROIs and masks, head mid 256) served at
    batch 8 x 8 and 8 x 64 ROIs with the fused unit (5 ``conv_ln_act``
    launches a forward) against it off, phase 4's gates on the logits in
    float32 and bf16, ms per forward; its group- and batch-norm ablations
    one eval forward each; (b) ``run_training`` on the ROI-pretrained
    config (B3 stage 1 unfrozen, 640 x 640, batch 8 x 8, bf16), 3 steps:
    finite, stage 1's running statistics moved, checkpoint restored equal,
    no fused stage-1 launch; ms per step; (c) the B0 flagship with the
    attention module, the boundary refinement and stage 1 unfrozen, built
    with ``pallas_tail`` and ``encoder_fused_blocks=6``: 3 bf16 steps with
    no stage-1 kernel launched, its stage 1 then served through the kept
    fused caches against a model without the kernels on the trained
    weights, and the trained model served (bf16 and float32) against its
    plain path under phase 4's gates with launches per forward; ms per step;
16. training on COCO data, the deployed config of phase 14 (:func:`coco_tree`,
    :func:`loader_alone`, :func:`train_on_coco`, :func:`fed_step_times`,
    :func:`learnability`): (a) synthetic COCO trees written by the port's
    generator at 480 x 640 (64 train, 16 val images), the native mask
    codec required; (b) ``ThreadedLoader`` alone for one epoch with the
    config's workers and augmentation, images per second, the batch
    contract, and ``prefetch_to_device`` equal to the host batches; (c)
    ``run_training`` on that tree, 2 epochs of 8 steps: finite, validation
    and the curated 1/2/3/5-person renders at both epochs, the end-of-run
    picture, last and best checkpoints restored, the fused stage-1 launches
    equal to the run's stage-1 forwards, ``training.metrics`` on the card
    equal to the CPU's; (d) ms per train step fed by the loader, by batches
    already on the card and by the loader through ``prefetch_to_device``,
    in turns, with the host's wait for a batch and the device idle share,
    a difference of medians called resolved only where it exceeds the
    spread between quartiles of both feeds; (e) the JAX package's learnability test on the port (tiny model, 64 x
    64, Adam, 15 epochs): the loss falls below 0.7 x its first value and
    target mIoU passes 0.25.
17. the deployment tools on the deployed B0 flagship at 480 x 640, head mid
    128 (:func:`deployment_tools`): (a) ``export.fold_batch_stats``, the
    folded model served with the kernels (bf16 and float32, ``fused_head``,
    the fused tail, six fused blocks) against the unfolded one on its plain
    path under phase 4's gates, launches per forward asserted; (b)
    ``export_model`` with buckets (1, 2, 4, 8, 16) on the card, timed; (c)
    ``load_exported`` against the live float32 plain path (binary within
    2e-4, instance agreement >= 0.995), 33 ROIs chunked equal to the
    in-bucket calls; (d) ms per artifact call beside the engine's; (e)
    ``run_harness`` (artifact and ``--config``) and ``run_validation`` over
    phase 16a's val tree;
18. distillation: (a) ``run_distillation`` on
    ``rgb_hierarchical_unet_v2_distillation_b0_from_b7_temp_prog`` at its
    sizes (B0 from B7, 640 x 640, batch 8, bf16), synthetic, 2 epochs x 4
    steps, 2 stages unfrozen at epoch 1, the teacher with the fused tail and
    the largest number of fused blocks every block admits
    (:func:`admissible_fused_blocks`, printed for B7 and B3): finite steps,
    the temperature schedule, the launches of a teacher forward a step plus
    one validation sweep, the optimizer rebuilt at epoch 1, checkpoints
    restored with their distillation state (:func:`distillation_run`); (b)
    the KD step with the teacher's kernels against the same teacher without
    them in float32 and bf16 by phase 14b's rule (:func:`distill_step_kernels`);
    (c) ms per bf16 KD step, the teacher's share, device busy time (the
    union of the kernels' time ranges), idle share and peak memory
    (:func:`time_distill_steps`); (d)
    ``make_hierarchical_distill_step`` at bench.py's shapes (teacher mid
    256, student mid 128 with its frozen stage 1, batch 4 x 2 ROIs): finite
    steps, launches per step, every kernel call against its plain version,
    ms per step (:func:`hierarchical_distill`);
19. the other model families and the YOLO-feature distillation
    (:func:`other_families`), every ``conv_ln_act`` call of a served forward
    held against ``conv_ln_act_plain`` and printed by shape
    (:class:`ConvLnActSpy`), the launches of a served forward equal to the
    gate's count (:func:`fused_units`): (a) the multi-scale RGB model
    (``model_from_config``, crops 56 / 42 / 28, concat, mask 56, 640 x 640)
    and (b) the variable-ROI model (``layer_3`` 56, ``layer_22`` 42,
    ``layer_34`` 28) and the baseline, each served at batch 8 x 8 ROIs a
    image with the fused head against it off under phase 4's gates, ms per
    forward of both in turns (:func:`serve_a8_family`); (c) heads V1, V3 and
    V4 at mid 256 on (64, 28, 28, 256) features, mask 56, fused against
    plain in float32 and bf16 (:func:`serve_head_variants`); (d)
    ``run_training`` on the multi-scale RGB config, 5 bf16 steps at 640 x
    640, batch 8 x 8 ROIs, the checkpoint restored equal, ms per step
    (:func:`train_multiscale_rgb`); (e) ``run_yolo_feature_distillation``,
    B0 from B7 with the fused tail and 18 fused blocks, 640 x 640, batch 4,
    2 epochs x 4 steps on synthetic batches and 2 steps from 640 x 640
    golden fixtures: the temperature 3 -> 1, one teacher forward of launches
    a step, the kernel teacher against the plain one by phase 18b's rule, ms
    per step of both in turns, idle share and peak memory
    (:func:`yolo_distillation`);
20. data parallelism (:func:`data_parallel`), each part in ranks of its
    own processes (``parallel.launch.spawn``): (a) one rank over NCCL runs
    the DP train step of phase 14's model (bf16, batch 8 x 8 ROIs, dropout
    off) for 3 steps against the same step without a mesh from the same
    weights and batches: losses and parameters equal bit for bit; ms per
    step of both in turns (:func:`dp_world_one_rank`); (b) two ranks share
    the card over Gloo, the global batch 4 + 4, 3 float32 steps: losses and
    parameters bit-identical across the ranks, 6 + 6 ``fused_mbconv`` and
    1 ``tail`` launches a rank step, and the first update's averaged loss and
    stage-2 gradients within phase 14b's bounds of a one-process reference
    that takes each half's gradients in turn (:func:`dp_two_ranks_gloo`,
    :func:`_dp_reference`); (c) bench.py's engine (B0, 480 x 640, batch 32,
    mid 128, ``fused_head``, dilation 1) given a mesh of two Gloo ranks at
    32, 6 and 1 ROIs: float32 binary masks within atol 1e-5 of the
    single-device engine, logits within 1e-5 of the same model at the
    ranks' shard shapes without collectives and within max(1e-5, 2 x that
    witness's distance) of the engine, instance masks equal to the
    engine's on every pixel not within that tolerance of a tie,
    float32 and bf16 under phase 4's gates and int8 (calibrated on the
    mesh) under phase 7's against the plain path on the mesh, each rank's
    ``roi_align`` and ``conv_ln_act_s8`` calls covering its shard only, the
    REPLICATED warning where the bucket does not divide, int8 with the s8
    tail (1 ``tail_q`` launch a rank forward) against one device, and
    ``make_roi_sharded_infer`` at 6 ROIs (:func:`dp_mesh_serving`); (d)
    ``run_dryrun(2)`` on the card over Gloo, ``parallel.multihost`` twice
    over Gloo, and ``int8_accuracy.main`` at its own tiny shapes, with
    their float32 and int8 IoU;
21. LayerNorm2d chains (:func:`layernorm_chains`): (a) the kernel pair
    ``ops/cuda_norm.ln_act`` against ``ln_act_plain`` at every shape a
    served B0 (128 RoIs) and B7 (64 RoIs) forward normalises, bf16 and
    float32, with and without a residual, x's dtype and int8 out, its
    statistics against float64, its scalar form and a residual in another
    layout at ragged shapes, under ``LN_BF16_ULPS`` and the
    tolerances beside it; (b) its device time at the two largest served
    shapes in its three served uses against its byte bound and the plain
    chain; (c) each benchmark cell's flagship served once with every
    ``ln_act`` call of the forward held against the plain chain on its own
    operands (52 calls a B0 forward, 57 a B7 one), and forwards with the
    route on and off in turns;
22. the B1 enhanced head (:func:`b1_enhanced_head`): (a) the fused unit
    ``conv_ln_act`` at the seven shapes of the depth-4, 1024-channel
    EnhancedUNet at RoI 80 x 60 (``B1_UNIT_CALLS``: 20 x 15 and 10 x 7
    pixels, Ci and Co 256 to 1024, K up to 9216), 32 RoIs, in bf16 and in
    its int8 form, each held against ``conv_ln_act_plain`` within
    ``TOL_CONV`` and timed (one call and ten in a row, operands prepared
    once, device time by kernel) against its bound; (b) the B1 enhanced
    flagship (the benchmark's ``b1_enhanced_480x640_int8``) served at 8
    images x 31 RoIs with the fused head: in bf16 every ``conv_ln_act``
    call of a forward held against its plain version and counted by shape
    (``B1_UNIT_CALLS``: the seven shapes, 20 a forward); in int8 every
    ``conv_ln_act_s8`` call likewise (``B1_UNIT_CALLS_INT8``: 17, the three
    ConvNormActs behind a pre-quantized boundary on the int8 QConv path),
    every int8 QConv exact, one ``unet_skip_resizes`` a forward, and forward
    times;
23. CUDA graphs (:func:`graph_serving`): each benchmark cell's engine as
    ``port_bench`` builds it (configuration, seed-7 weights, calibration,
    request pool) served from its graph against eager serving on the same
    engine: every request of the pool replayed equal bit for bit to its
    eager call, wall ms a ``__call__`` of each in turns and of the capture,
    the profiler's busy time of replayed requests within 5% of eager ones
    (read by the benchmark's ``lib/trace.py``), 1 capture, a replay a call
    and no fallback.

``python3 chip_smoke.py --phases 1,2,6`` runs a subset (for bring-up); the
contract run takes no arguments.

It prints a JSON line of per-kernel results (launches on the served paths,
max abs error, kernel, plain and library or chain times, and the bound: the
least time the card could take for the same work; for the stage-1 kernels
and the crop also their launches in phase 18's distillation and per
distillation step, and the stage-1 kernels' launches per YOLO distillation
step; for ``conv_ln_act`` its launches per served forward of each family
of phase 19; ``dp_launches_per_rank``: a kernel's launches per DP rank
step and per mesh-served forward on one rank, phase 20), then as its last
line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
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
# Co, k; each regime of the kernel (wgmma for Co > 32, the one-launch kernel
# below) and each ragged channel count. Stage 2: bott_conv (3x3 at 384 on the
# 16x12 bottleneck), enc1_out (32x24 map), feature_combiner (1x1, 258 = 256
# RGB features + 2 logit channels), tnt_res1 (the 128x96 mask map), the logit
# heads final_out (48 -> 2) and contour/out (64 -> 1). Stage 1: the first
# conv of the decoder stages 0, 2, 3 and 4 (30x40 up to 480x640).
QCONV_SHAPES = {
    "bott_conv": (32, 16, 12, 384, 384, 3),
    "enc1_out": (32, 32, 24, 96, 192, 3),
    "feature_combiner": (32, 64, 48, 258, 256, 1),
    "tnt_res1": (32, 128, 96, 64, 64, 3),
    "final_out": (32, 64, 48, 48, 2, 1),
    "contour/out": (32, 64, 48, 64, 1, 1),
    "decoder0/conv0": (32, 30, 40, 432, 256, 3),
    "decoder2/conv0": (32, 120, 160, 152, 64, 3),
    "decoder3/conv0": (32, 240, 320, 96, 32, 3),
    "decoder4/conv0": (32, 480, 640, 32, 16, 3),
}
# float32 kernel path vs plain path end to end: least instance agreement
MIN_AGREE = 0.995
INT8_PEAK_TOPS = 1979.0  # H100 SXM dense int8 (NVIDIA data sheet, at 700 W)
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W),
# for each kernel's bound: the larger of bytes / HBM rate and operations /
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# exp runs on the special-function units, 16 a clock on each of 132 SMs; the
# clock is the one the float32 peak implies (67e12 / (132 * 128 * 2))
SFU_PER_S = 132 * 16 * (PEAK_OPS["f32"] / (132 * 128 * 2))
# the fused stage-1 tail at the flagship's last decoder stage: decoder3's
# output (B, 240, 320, 32) -> 16 channels -> (B, 480, 640) logits
TAIL_SHAPE = (32, 240, 320, 32, 16)
# tail, float32: the JAX package's gate for its Pallas tail
# (tests/test_pallas_tail.py). bfloat16: kernel and plain version compute the
# same bf16 upsampled input (equal float32 ops) and round at the same three
# places, but their float32 conv sums differ in order (tensor cores against
# cuDNN), so a value of y0 or y1 near a bf16 rounding boundary can land one
# ulp away. One ulp of y1 (2^-7 |y1|, |y1| <= ~4 here) through one head weight
# (|kh| <= ~0.3 at these weights' LeCun scale) moves a logit by ~1e-2, a y0
# ulp through conv1 and the head by less; allow two such flips near one
# pixel (atol 2e-2), and the logit's own rounding (one ulp, 2^-7 relative).
TOL_TAIL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2.0 ** -7)}
TOL_BILATERAL = 1e-5
BINARY_SHAPE = (32, 480, 640, 1)
# launches of a kernel in one served forward (one binary-mode batch for the
# filters), as the phases that assert them saw them
PER_FORWARD: dict = {}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = TIMING_REPS, warmup: int = 3, calls: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``calls`` launches of ``fn``
    in a row, per launch. One call between the events also counts the time the
    host takes to reach the launch (what a caller of one op sees); with
    several in a row the host runs ahead and the device time remains."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def clocks_under(fn, calls: int = 100) -> str:
    """The SM clock and power draw (``nvidia-smi``, sampled every 100 ms)
    while ``calls`` launches of ``fn`` run back to back: the lowest and
    highest clock and the highest draw."""
    import torch

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = [[float(v) for v in line.split(",")] for line in out.strip().splitlines()
            if line.count(",") == 1]
    if not rows:
        return "clocks not read"
    clocks = [r[0] for r in rows]
    return (f"SM clock {min(clocks):.0f}-{max(clocks):.0f} MHz, power draw up to "
            f"{max(r[1] for r in rows):.1f} W over {len(rows)} samples")


def device_ms_by_kernel(fn, reps: int = 10) -> dict:
    """Device time per call of ``fn`` by kernel (``torch.profiler``), keyed by
    the kernel's short name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.count:
            key = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            found = re.search(r"([A-Za-z_]\w*)\s*[<(]", key)
            name = found.group(1) if found else e.key[:40]
            # per launch times launches per call: a long process's later
            # profiles can miss some of their events, and then the total over
            # reps would read short
            per_call = max(1, round(e.count / reps))
            out[name] = out.get(name, 0.0) + e.self_device_time_total / e.count * per_call / 1e3
    return out


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


def head_bound(kind: str) -> dict:
    """conv_ln_act at ``HEAD_SHAPE``, k=3, bf16 activations: x and the
    output once, the weights (2 bytes, or 1 as int8), three float32 vectors;
    the conv's multiply-adds plus ~10 operations per output for the norm."""
    n, h, w, c = HEAD_SHAPE
    px = n * h * w
    wbytes = 2 if kind == "bf16" else 1
    return bound(2 * px * c * 2 + 9 * c * c * wbytes + 3 * c * 4,
                 2 * 9 * c * c * px + 10 * px * c, kind)


def check_kernels(card: str, rng) -> list:
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_head

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
    # the pure-RGB bottleneck (phase 15a: 64 ROIs of 64 x 64 -> 16 x 16 x 384),
    # whose LayerNorm pass caches 48 KB a block
    cases += [((64, 16, 16, c), 3, True, dt) for dt in (torch.float32, torch.bfloat16)]
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
            # as the blocks run it: the operands prepared once, the weight a view
            ops = cuda_head.prepare_bf16(wt, b, g, be)
            view = wt.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0)

            def served():
                return cuda_head.conv_ln_act(x, view, b, g, be, height=h, width=w, prepared=ops)

            if not torch.equal(served(), got):
                raise AssertionError("conv_ln_act bf16: prepared operands change the result")
            split = device_ms_by_kernel(served)
            if "conv_bf16_wgmma_kernel" not in split:
                raise AssertionError(f"conv_ln_act bf16: the served shape did not run on wgmma: "
                                     f"{split}")
            kms = median_ms(served)
            kms10 = median_ms(served, calls=10)
            each = median_ms(lambda: cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w))
            pms = median_ms(lambda: cuda_head.conv_ln_act_plain(x, wt, b, g, be))
            cms = median_ms(unfused_chain(x, wt, b, g, be))
            timing = (kms, pms, cms, kms10)
            print(f"conv_ln_act bf16 k=3 {HEAD_SHAPE}->{c}: kernel {kms:.4f} ms with prepared "
                  f"operands ({kms10:.4f} ms ten launches in a row; {each:.4f} ms preparing them "
                  f"at every call), plain {pms:.4f} ms, unfused bf16 chain {cms:.4f} ms (median "
                  f"of {TIMING_REPS}, CUDA events); device ms by kernel "
                  f"{ {k_: round(v, 4) for k_, v in split.items()} } [{card}]")
    results.append({"name": "conv_ln_act", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/conv_ln_act.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_head.py:243",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    "library_ms": None, "chain_ms": timing[2], "ms_10": timing[3],
                    **head_bound("bf16")})
    results.append(check_roi_align(card, rng))
    return results


def served_crop_rois(n: int):
    """The served crop request of the timings: one box ``[0.2, 0.1, 0.8,
    0.95]`` per image, float32 on the card."""
    import torch

    rois = torch.tensor([[0.0, 0.2, 0.1, 0.8, 0.95]] * n, device="cuda")
    rois[:, 0] = torch.arange(n, device="cuda", dtype=torch.float32)
    return rois


def grid_sample_crops(rois, maps):
    """``F.grid_sample`` (bilinear, zeros, align_corners=True) computing the
    served crops of ``maps`` (NHWC, one dtype) on their NCHW views with a
    grid made once: the same function only where each ROI crops its own
    image, as served (one ROI per image), and only in float32 (the grid
    takes the maps' dtype, so in bf16 it rounds the sample positions). The
    library yardstick of the ``roi_align`` row, used nowhere in the port.
    Returns a zero-argument callable."""
    import torch
    import torch.nn.functional as F

    from human_instance_segmentation_tpu_torch.ops.sampling import grid_sample_positions

    (h, w), (oh, ow) = IMAGE_HW, ROI_HW
    py = grid_sample_positions(rois[:, 2] * h, rois[:, 4] * h, oh, True)
    px = grid_sample_positions(rois[:, 1] * w, rois[:, 3] * w, ow, True)
    gy = (2.0 * py / (h - 1) - 1.0)[:, :, None].expand(-1, oh, ow)
    gx = (2.0 * px / (w - 1) - 1.0)[:, None, :].expand(-1, oh, ow)
    grid = torch.stack([gx, gy], dim=-1).contiguous()
    grid = grid.to(maps[0].dtype)  # grid_sample takes the input's dtype

    def run():
        return [F.grid_sample(m.permute(0, 3, 1, 2), grid, mode="bilinear",
                              padding_mode="zeros", align_corners=True) for m in maps]

    return run


def check_roi_align(card: str, rng) -> dict:
    """Phase 3, RoIAlign: the pair entry point (both served crops in one
    launch) and the single-map entry against two plain calls, with the RGB
    map beside a logit map of 1 or 2 channels, float32 and bf16,
    ``aligned`` both ways, the second map contiguous or a permuted view, over
    boxes that include the sentinel, an edge at exactly 1.0, a degenerate
    box and one hanging off the image; then timed at the served shapes
    beside ``F.grid_sample``."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_roi_align

    dev = torch.device("cuda")
    n = HEAD_SHAPE[0]
    rois = rng.random((n, 5)).astype("float32")
    rois[:, 0] = rng.integers(0, n, n)
    lo = rng.random((n, 2)) * 0.5
    rois[:, 1:3] = lo
    rois[:, 3:5] = lo + 0.1 + rng.random((n, 2)) * 0.4
    rois[0] = [-1.0, 0.1, 0.1, 0.5, 0.5]         # sentinel
    rois[1] = [1.0, 0.5, 0.25, 1.0, 1.0]         # right/bottom edge at exactly 1.0
    rois[2] = [2.0, 0.3, 0.4, 0.3, 0.4]          # degenerate box
    rois[3] = [3.0, -0.1, -0.05, 0.2, 0.3]       # hangs past the top-left corner
    rois_t = torch.tensor(rois, device=dev)
    scale = (float(IMAGE_HW[0]), float(IMAGE_HW[1]))
    kw = dict(spatial_scale=scale)

    def held(got, ref, dt, what):
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        if dt == torch.float32:
            ok, tol = err <= TOL_ROI_F32, f"atol {TOL_ROI_F32}"
        else:
            ok = bool((diff <= 1e-6 + ROI_BF16_RTOL * ref.float().abs()).all())
            tol = "1 bf16 ulp (rtol 2^-7)"
        ok = ok and got.is_contiguous() and got.shape == ref.shape and got.dtype == ref.dtype
        print(f"roi_align {what}: max_abs_err={err:.3e} ({tol})")
        if not ok:
            raise AssertionError(f"roi_align {what}: {err}")
        return err if dt == torch.float32 else 0.0

    worst = 0.0
    cases = [(c2, dt, aligned, layout) for c2 in (1, 2)
             for dt in (torch.float32, torch.bfloat16) for aligned in (True, False)
             for layout in ("contiguous", "permuted")]
    for c2, dt, aligned, layout in cases:
        first = torch.tensor(rng.standard_normal((n, *IMAGE_HW, 3)), dtype=dt, device=dev)
        second = torch.tensor(rng.standard_normal((n, c2, *IMAGE_HW)), dtype=dt, device=dev)
        second = second.permute(0, 2, 3, 1)
        if layout == "contiguous":
            second = second.contiguous()
        args = (rois_t, *ROI_HW)
        got1, got2 = cuda_roi_align.roi_align_pair(first, second, *args, aligned=aligned, **kw)
        one1 = cuda_roi_align.roi_align(first, *args, aligned=aligned, **kw)
        one2 = cuda_roi_align.roi_align(second, *args, aligned=aligned, **kw)
        torch.cuda.synchronize()
        ref1 = cuda_roi_align.roi_align_plain(first, *args, aligned=aligned, **kw)
        ref2 = cuda_roi_align.roi_align_plain(second, *args, aligned=aligned, **kw)
        torch.cuda.synchronize()
        tag = f"C=(3, {c2}) {dt} aligned={aligned} second map {layout}"
        worst = max(worst, held(got1, ref1, dt, f"pair RGB {tag}"),
                    held(got2, ref2, dt, f"pair logit {tag}"))
        if not (torch.equal(one1, got1) and torch.equal(one2, got2)):
            raise AssertionError(f"roi_align {tag}: the single-map entry differs from the pair")
        del first, second, got1, got2, one1, one2, ref1, ref2

    # the served shapes: bf16 RGB and the 2-channel logit map as the model
    # hands it (the wrapper's NCHW output viewed NHWC), or the fused tail's
    # 1-channel map; one box a image
    served = served_crop_rois(n)
    rgb = torch.tensor(rng.random((n, *IMAGE_HW, 3)), dtype=torch.bfloat16, device=dev)
    logit2 = torch.tensor(rng.random((n, 2, *IMAGE_HW)), dtype=torch.bfloat16,
                          device=dev).permute(0, 2, 3, 1)
    logit1 = torch.tensor(rng.random((n, *IMAGE_HW)), dtype=torch.bfloat16, device=dev)[..., None]
    args = (served, *ROI_HW)
    library = grid_sample_crops(served, (rgb, logit2))
    lib_out = library()
    lerr = max((g.permute(0, 2, 3, 1).float() - cuda_roi_align.roi_align_plain(
        m, *args, aligned=True, **kw).float()).abs().max().item()
        for g, m in zip(lib_out, (rgb, logit2)))
    calls = {
        "pair rgb + logit C=2": lambda: cuda_roi_align.roi_align_pair(rgb, logit2, *args,
                                                                      aligned=True, **kw),
        "pair rgb + logit C=1": lambda: cuda_roi_align.roi_align_pair(rgb, logit1, *args,
                                                                      aligned=True, **kw),
        "single rgb": lambda: cuda_roi_align.roi_align(rgb, *args, aligned=True, **kw),
        "F.grid_sample rgb + logit C=2 (library, two calls)": library,
    }
    times = {}
    for name, fn in calls.items():
        times[name] = (median_ms(fn), median_ms(fn, calls=10), sum(device_ms_by_kernel(fn).values()))
        print(f"roi_align served {name}: {times[name][0]:.4f} ms one call, {times[name][1]:.4f} ms "
              f"ten in a row, device {times[name][2]:.4f} ms (median of {TIMING_REPS}, CUDA events; "
              f"profiler) [{card}]")
    pms = median_ms(lambda: (cuda_roi_align.roi_align_plain(rgb, *args, aligned=True, **kw),
                             cuda_roi_align.roi_align_plain(logit2, *args, aligned=True, **kw)))
    print(f"roi_align served: plain (two separable-product calls) {pms:.4f} ms; F.grid_sample "
          f"against the plain crops max abs {lerr:.3e} [{card}]")
    # bytes these boxes need: every source pixel under a box once (at most
    # the four taps of each output), 3 + 2 bf16 channels, plus the outputs
    box_w, box_h = 0.6 * IMAGE_HW[1] + 1, 0.85 * IMAGE_HW[0] + 1
    taps = n * min(box_w * box_h, 4.0 * ROI_HW[0] * ROI_HW[1])
    outs = n * ROI_HW[0] * ROI_HW[1] * 5
    pair = times["pair rgb + logit C=2"]
    lib = times["F.grid_sample rgb + logit C=2 (library, two calls)"]
    return {"name": "roi_align", "route": "cuda",
            "source": "human_instance_segmentation_tpu_torch/csrc/roi_align.cu",
            "replaces": "human_instance_segmentation_tpu/ops/pallas_roi_align.py:128",
            "max_abs_err": worst, "ms": pair[0], "ms_10": pair[1], "device_ms": pair[2],
            "plain_ms": pms, "library_ms": lib[0], "library_ms_10": lib[1],
            "library_device_ms": lib[2],
            "library": "F.grid_sample x2 on the NCHW views, grid made once, one ROI per image; "
                       "its bf16 grid rounds the positions", "library_max_abs_err": lerr,
            **bound(taps * 5 * 2 + outs * 2, 8 * outs, "f32")}


def bound(nbytes: float, ops: float, kind: str, sfu_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes moved once over the HBM
    rate against operations over the peak rate of their type (and exps over
    the special-function rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_OPS[kind], sfu_ops / SFU_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tail_operands(rng, ci: int, c: int, dtype, dev):
    """Seeded tail weights at LeCun scale with non-trivial BN statistics,
    HWIO as the wrapper takes them."""
    import torch

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    def bn():
        return tuple(t(v) for v in (rng.uniform(0.5, 1.5, c), rng.standard_normal(c) * 0.1,
                                    rng.standard_normal(c) * 0.1, rng.uniform(0.5, 1.5, c)))

    k0 = t(rng.standard_normal((3, 3, ci, c)) / (9 * ci) ** 0.5)
    k1 = t(rng.standard_normal((3, 3, c, c)) / (9 * c) ** 0.5)
    kh = t(rng.standard_normal((3, 3, c, 1)) / (9 * c) ** 0.5)
    bh = t(rng.standard_normal(1))
    return k0, bn(), k1, bn(), kh, bh


def unfused_tail_chain(x_nchw, k0, bn0, k1, bn1, kh, bh, int8_scales=None):
    """What the model runs with ``pallas_tail=False``, as a zero-argument
    callable: the last DecoderBlock and the seg head as modules in x's dtype;
    with ``int8_scales`` (conv0's, conv1's) the block's convs run s8."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import quant

    from human_instance_segmentation_tpu_torch.models.unet import DecoderBlock

    ci, c = k0.shape[2], k0.shape[3]
    block = DecoderBlock(ci, 0, c).to(device=x_nchw.device, dtype=x_nchw.dtype).eval()
    head = torch.nn.Conv2d(c, 1, 3, padding=1).to(device=x_nchw.device, dtype=x_nchw.dtype)
    with torch.no_grad():
        block.conv0.weight.copy_(k0.permute(3, 2, 0, 1))
        block.conv1.weight.copy_(k1.permute(3, 2, 0, 1))
        head.weight.copy_(kh.permute(3, 2, 0, 1))
        head.bias.copy_(bh)
        for m, p in ((block.bn0, bn0), (block.bn1, bn1)):
            for dst, src in zip((m.weight, m.bias, m.running_mean, m.running_var), p):
                dst.copy_(src)
    if int8_scales is not None:
        quant.set_int8_serving(block, True, dict(zip(("conv0", "conv1"), int8_scales)))

    def run():
        with torch.inference_mode():
            return head(block(x_nchw, None))[:, 0]

    return run


def blob_mask(rng, shape, dev):
    """A {0, 1} float32 mask of smooth blobs with a noisy rim: low-pass
    noise thresholded, then 2% of the pixels flipped."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = shape
    noise = torch.tensor(rng.standard_normal((b * c, 1, h // 8 + 2, w // 8 + 2)), dtype=torch.float32,
                         device=dev)
    smooth = F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=False)
    mask = (smooth > 0).reshape(b, c, h, w).permute(0, 2, 3, 1)
    flip = torch.tensor(rng.random(shape) < 0.02, device=dev)
    return (mask ^ flip).to(torch.float32).contiguous()


def check_tail_and_filters(card: str, rng) -> list:
    """Phase 9: the fused tail, the bilateral filter and the edge smoothing
    against their plain versions at the slice's shapes and ragged ones."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_kernels, cuda_tail

    dev = torch.device("cuda")
    results = []

    # ---- tail -----------------------------------------------------------
    worst, timing = 0.0, None
    b, h, w, ci, c = TAIL_SHAPE
    cases = [(TAIL_SHAPE, dt, layout) for dt in (torch.float32, torch.bfloat16)
             for layout in ("nchw", "nhwc")]
    # odd sizes (partial tiles in both directions), channels off the kernel's
    # chunk (8) and block (16) widths, C > 16 (two output-channel blocks)
    cases += [(shape, dt, "nhwc") for shape in ((2, 13, 19, 5, 12), (1, 9, 21, 12, 20))
              for dt in (torch.float32, torch.bfloat16)]
    for shape, dt, layout in cases:
        cb, chh, cw, cci, cc = shape
        ops = tail_operands(rng, cci, cc, dt, dev)
        x = torch.tensor(rng.standard_normal((cb, chh, cw, cci)), dtype=dt, device=dev)
        if layout == "nchw":  # as the model hands it over: NCHW memory, NHWC view
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        got = cuda_tail.tail(x, *ops)
        torch.cuda.synchronize()
        ref = cuda_tail.tail_plain(x, *ops)
        torch.cuda.synchronize()
        if got.shape != (cb, 2 * chh, 2 * cw) or got.dtype != dt:
            raise AssertionError(f"tail {shape} {dt}: output {tuple(got.shape)} {got.dtype}")
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        atol, rtol = TOL_TAIL[str(dt).split(".")[1]]
        print(f"tail {shape} {dt} {layout} input: max_abs_err={err:.3e} (atol {atol}, rtol "
              f"{rtol}), |ref| max {ref.float().abs().max().item():.2f}")
        if not (bool((diff <= atol + rtol * ref.float().abs()).all())
                and torch.isfinite(got.float()).all()):
            raise AssertionError(f"tail {shape} {dt} {layout}: {err}")
        if dt == torch.float32:
            worst = max(worst, err)
        if dt == torch.bfloat16:
            ulps = int((diff > 2.0 ** -8 * ref.float().abs()).sum())
            print(f"tail {shape} bf16 {layout}: {int((diff > 0).sum())} of {diff.numel()} logits "
                  f"differ, {ulps} by more than half an ulp")
        if (shape, dt, layout) == (TAIL_SHAPE, torch.bfloat16, "nchw"):  # the served form
            xn = x.permute(0, 3, 1, 2)
            chain = unfused_tail_chain(xn, *ops)
            cdiff = (chain().float() - ref.float()).abs().max().item()
            packed = cuda_tail.pack_tail_weights(*ops)  # as the UNet keeps them
            kms = median_ms(lambda: cuda_tail.tail(x, *ops, packed=packed))
            kms10 = median_ms(lambda: cuda_tail.tail(x, *ops, packed=packed), calls=10)
            pack_ms = median_ms(lambda: cuda_tail.tail(x, *ops))
            pms = median_ms(lambda: cuda_tail.tail_plain(x, *ops), reps=5, warmup=1)
            cms = median_ms(chain)
            timing = (kms, pms, cms)
            print(f"tail bf16 {TAIL_SHAPE}: kernel {kms:.4f} ms with kept weights ({kms10:.4f} "
                  f"ms ten launches in a row; {pack_ms:.4f} ms packing them per call), plain "
                  f"{pms:.4f} ms, unfused bf16 chain of the model {cms:.4f} ms (its max abs "
                  f"distance from the plain version {cdiff:.3e}) (median of {TIMING_REPS}, CUDA "
                  f"events) [{card}]")
        del x, got, ref, diff
        torch.cuda.empty_cache()
    px = b * 2 * h * 2 * w
    results.append({"name": "tail", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/tail.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_tail.py:269",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    "library_ms": None, "chain_ms": timing[2],
                    **bound(2 * b * h * w * ci + 2 * px, 2 * 9 * (ci * c + c * c + c) * px, "bf16")})

    # ---- bilateral_filter -------------------------------------------------
    # every unrolled k and the generic one (11), at the served shape, ragged
    # shapes and planes narrower (and shorter) than one 32 x 32 tile
    worst, timing = 0.0, None
    cases = [(shape, k, ss, sr) for shape, ss, sr in ((BINARY_SHAPE, 1.5, 0.2),
                                                     ((2, 37, 53, 3), 1.0, 0.1))
             for k in (3, 5, 7, 9, 11)]
    cases += [((1, 16, 9, 2), 9, 2.0, 0.3), ((1, 16, 9, 2), 11, 2.0, 0.3),
              ((1, 6, 7, 1), 11, 3.0, 0.5), ((3, 20, 12, 1), 3, 0.8, 0.05)]
    for shape, k, ss, sr in cases:
        x = torch.tensor(rng.random(shape), dtype=torch.float32, device=dev)
        got = cuda_kernels.bilateral_filter(x, k, ss, sr)
        torch.cuda.synchronize()
        ref = cuda_kernels.bilateral_filter_plain(x, k, ss, sr)
        err = (got - ref).abs().max().item()
        print(f"bilateral_filter {shape} k={k} sigma ({ss}, {sr}): max_abs_err={err:.3e} "
              f"(atol {TOL_BILATERAL})")
        if not (err <= TOL_BILATERAL and got.shape == x.shape and torch.isfinite(got).all()):
            raise AssertionError(f"bilateral_filter {shape} k={k}: {err}")
        worst = max(worst, err)
        if (shape, k) == (BINARY_SHAPE, 7):
            def fn():
                return cuda_kernels.bilateral_filter(x, k, ss, sr)

            kms, kms10 = median_ms(fn), median_ms(fn, calls=10)
            dms = sum(device_ms_by_kernel(fn).values())
            pms = median_ms(lambda: cuda_kernels.bilateral_filter_plain(x, k, ss, sr), reps=5,
                            warmup=1)
            timing = (kms, pms, kms10, dms)
            print(f"bilateral_filter f32 {shape} k={k}: kernel {kms:.4f} ms one call, {kms10:.4f} "
                  f"ms ten in a row, device {dms:.4f} ms; plain ({k * k} shifted multiply-adds) "
                  f"{pms:.4f} ms (median of {TIMING_REPS}, CUDA events; profiler) [{card}]")
        del x, got, ref
    # bf16 input: the wrapper filters the float32 planes and rounds once
    for shape in (BINARY_SHAPE, (2, 37, 53, 3)):
        x = torch.tensor(rng.random(shape), dtype=torch.bfloat16, device=dev)
        got = cuda_kernels.bilateral_filter(x, 7, 1.5, 0.2)
        via32 = cuda_kernels.bilateral_filter(x.float(), 7, 1.5, 0.2)
        ref = cuda_kernels.bilateral_filter_plain(x.float(), 7, 1.5, 0.2)
        torch.cuda.synchronize()
        err = (via32 - ref).abs().max().item()
        ulp = (got.float() - ref.to(torch.bfloat16).float()).abs().max().item()
        print(f"bilateral_filter bf16 {shape} k=7: output {got.dtype}, equal to the float32 "
              f"filter rounded once: {torch.equal(got, via32.to(torch.bfloat16))}; float32 filter "
              f"max_abs_err={err:.3e} (atol {TOL_BILATERAL}); against the plain result rounded "
              f"to bf16 {ulp:.3e}")
        if not (got.dtype == torch.bfloat16 and torch.equal(got, via32.to(torch.bfloat16))
                and err <= TOL_BILATERAL):
            raise AssertionError(f"bilateral_filter bf16 {shape}: {err}")
    n = 1
    for d in BINARY_SHAPE:
        n *= d
    # the function's least work at k = 7: (k^2 - 1) / 2 = 24 exps a pixel
    # (a pair's weight serves both its pixels, the centre's is 1) and their
    # exponents (difference, square, multiply-add: 4 flops each), then a
    # multiply-add and an add for each of the 48 taps and the division
    results.append({"name": "bilateral_filter", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/bilateral.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_kernels.py:100",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    "ms_10": timing[2], "device_ms": timing[3],
                    "library_ms": None, "chain_ms": timing[1],
                    **bound(8 * n, (24 * 4 + 48 * 3 + 2) * n, "f32", sfu_ops=24 * n)})

    # ---- edge_smooth --------------------------------------------------------
    # the served shape, ragged shapes, widths around the lanes' edges (1, 3,
    # 5, 127, 129), strips cut short (H = 1, 3, 5 and 37: shorter than a
    # warp's rows, not a multiple of them), several planes (B * C > 1), and a
    # plane that does not start on 16 bytes (a view into a buffer at a
    # one-element offset): the four-column form and the one-column form,
    # each held to 0 differing pixels
    worst, timing = 0.0, None

    def noise(shape):
        return torch.tensor(rng.random(shape) > 0.5, device=dev).float()

    def offset_view(shape):
        n = 1
        for d in shape:
            n *= d
        buf = torch.zeros(n + 1, device=dev)
        view = buf[1:].view(shape)
        view.copy_(noise(shape))
        return view

    masks = [("blobs", blob_mask(rng, BINARY_SHAPE, dev)),
             ("noise", noise(BINARY_SHAPE)),
             ("ragged blobs", blob_mask(rng, (2, 37, 53, 3), dev))]
    masks += [(f"noise W={shape[2]}", noise(shape))
              for shape in ((1, 21, 1, 1), (2, 19, 3, 1), (1, 33, 5, 2), (1, 40, 127, 1),
                            (2, 23, 129, 1))]
    masks += [("noise H = 1", noise((3, 1, 64, 1))), ("noise H = 5", noise((3, 5, 64, 1))),
              ("noise H = 3, ragged W", noise((1, 3, 129, 1))),
              ("noise H = 37", noise((2, 37, 132, 1))),
              ("noise B * C = 8", noise((4, 16, 64, 2))),
              ("noise, base 4 bytes past 16", offset_view((4, 29, 128, 1)))]
    forms = set()  # the forms the wrapper launched: columns a lane
    for name, m in masks:
        for thr, strength in ((0.5, 3.0), (0.4, 1.5)):
            before = cuda_kernels.edge_smooth.launches
            cuda_kernels.edge_smooth.last_vec = None
            got = cuda_kernels.edge_smooth(m, thr, strength)
            torch.cuda.synchronize()
            if cuda_kernels.edge_smooth.launches != before + 1:
                raise AssertionError(f"edge_smooth {name}: not one launch")
            vec = cuda_kernels.edge_smooth.last_vec
            forms.add(vec)
            ref = cuda_kernels.edge_smooth_plain(m, thr, strength)
            ndiff = int((got != ref).sum().item())
            print(f"edge_smooth {name} {tuple(m.shape)} ({vec} column(s) a lane) threshold {thr} "
                  f"strength {strength}: {ndiff} differing pixels (tol 0), changed "
                  f"{(got != m).float().mean():.4f} of the mask")
            if ndiff or got.shape != m.shape:
                raise AssertionError(f"edge_smooth {name}: {ndiff} pixels differ")
        if name == "blobs":
            def fn():
                return cuda_kernels.edge_smooth(m)

            kms, kms10 = median_ms(fn), median_ms(fn, calls=10)
            dms = sum(device_ms_by_kernel(fn).values())
            pms = median_ms(lambda: cuda_kernels.edge_smooth_plain(m))
            timing = (kms, pms, kms10, dms)
            print(f"edge_smooth f32 {tuple(m.shape)}: kernel {kms:.4f} ms one call, {kms10:.4f} ms "
                  f"ten in a row, device {dms:.4f} ms; plain (two depthwise convs and the blend) "
                  f"{pms:.4f} ms (median of {TIMING_REPS}, CUDA events; profiler) [{card}]")
    if forms != {1, 4}:
        raise AssertionError(f"edge_smooth: the cases reached the forms {forms}, not both")
    soft = torch.tensor(rng.random(BINARY_SHAPE), dtype=torch.float32, device=dev)
    ndiff = int((cuda_kernels.edge_smooth(soft) != cuda_kernels.edge_smooth_plain(soft)).sum())
    print(f"edge_smooth soft (non-binary) input {BINARY_SHAPE}: {ndiff} of {n} pixels differ "
          f"(reported, not gated: the sums round in another order off {{0, 1}})")
    results.append({"name": "edge_smooth", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/postprocess.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_kernels.py:157",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    "ms_10": timing[2], "device_ms": timing[3],
                    "library_ms": None, "chain_ms": timing[1], "soft_input_diff_pixels": ndiff,
                    **bound(8 * n, 30 * n, "f32", sfu_ops=n)})
    return results


# the first six MBConv blocks of the B0 encoder at 480x640, batch 32: x (B,
# Ci, H, W), expand ratio, kernel, stride, Co (the squeeze width is Ci // 4)
MBCONV_SHAPES = [
    ((32, 32, 240, 320), 1, 3, 1, 16),
    ((32, 16, 240, 320), 6, 3, 2, 24),
    ((32, 24, 120, 160), 6, 3, 1, 24),
    ((32, 24, 120, 160), 6, 5, 2, 40),
    ((32, 40, 60, 80), 6, 5, 1, 40),
    ((32, 40, 60, 80), 6, 3, 2, 80),
]
# odd channel counts, extents off the 8 x 16 tile, batch 1
MBCONV_RAGGED = [
    ((1, 5, 13, 19), 6, 3, 1, 7),
    ((2, 12, 22, 18), 3, 5, 2, 9),
    ((1, 7, 9, 11), 1, 5, 1, 7),
    ((1, 9, 6, 36), 4, 3, 2, 9),
]
# fused_mbconv, float32: the JAX package's gate for its Pallas kernel
# (tests/test_pallas_mbconv.py:48). bfloat16: kernel and plain version round at
# the same four places, but their float32 sums differ in the last bits, so a
# value can land on the other side of a bf16 rounding boundary: one ulp of `a`
# or of `d * se` moves y by |w| * 2^-8 |operand| (a few 1e-3), and y's own
# rounding by one ulp (2^-8 |y| relative to the midpoint, 2^-7 |y| at worst).
TOL_MBCONV = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
# the mean of d over a block's kept positions (pass 1's result, the
# squeeze-excite input), absolute. float32: summation order only. bfloat16:
# where the kernel's expand sums (tensor cores) and cuDNN's straddle a bf16
# rounding boundary, one value of `a` lands one ulp (up to 2^-7 |a|) away and
# moves the k*k values of d it feeds by |wdw| times that; over the 1,200 kept
# positions of the smallest served map (30 x 40) that is up to about 1e-5 per
# such value at these weights (1.2e-5 measured in one run), so allow ten.
TOL_MBCONV_MEAN = {"float32": 1e-5, "bfloat16": 1e-4}


def mbconv_operands(rng, ci: int, expand: int, k: int, co: int, dtype, dev):
    """Seeded folded MBConv weights at LeCun scale (BN gains near 1 folded
    in), as ``fused_mbconv`` takes them."""
    import torch

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    cm, cse = ci * expand, max(1, ci // 4)
    we = t(rng.standard_normal((ci, cm)) / ci ** 0.5) if expand != 1 else None
    be = t(rng.standard_normal(cm) * 0.1) if expand != 1 else None
    return (we, be, t(rng.standard_normal((k, k, cm)) / k), t(rng.standard_normal(cm) * 0.1),
            t(rng.standard_normal((cm, cse)) / cm ** 0.5), t(rng.standard_normal(cse) * 0.1),
            t(rng.standard_normal((cse, cm)) / cse ** 0.5), t(rng.standard_normal(cm) * 0.1),
            t(rng.standard_normal((cm, co)) / cm ** 0.5), t(rng.standard_normal(co) * 0.1))


def unfused_mbconv_chain(x, ci: int, expand: int, k: int, stride: int, co: int):
    """What the encoder runs without ``fused_blocks``, as a zero-argument
    callable: the MBConv module (cuDNN convs, BN, SiLU and squeeze-excite as
    separate ops) in x's dtype, random weights."""
    import torch

    from human_instance_segmentation_tpu_torch.models.efficientnet import MBConv

    block = MBConv(ci, co, expand, k, stride).to(device=x.device, dtype=x.dtype).eval()

    def run():
        with torch.inference_mode():
            return block(x)

    return run


def mbconv_bounds(shape, expand: int, k: int, stride: int, co: int, elem: int):
    """Bounds of the two passes at one block shape: bytes (x once per pass,
    y once, the sums) against the two 1x1 products at the bf16 tensor-core
    peak, the depthwise taps at the float32 peak and the SiLUs' exps."""
    b, ci, h, w = shape
    cm, px_in, px_out = ci * expand, b * h * w, b * (h // stride) * (w // stride)
    mm_e = 2 * ci * cm * px_in if expand != 1 else 0
    dw, exps = 2 * k * k * cm * px_out, cm * px_out + (cm * px_in if expand != 1 else 0)

    def t(nbytes, mm):
        t_ops = max(mm / PEAK_OPS["bf16"], dw / PEAK_OPS["f32"], exps / SFU_PER_S) * 1e3
        return nbytes / HBM_BYTES_PER_S * 1e3, t_ops

    sums = t(px_in * ci * elem + b * cm * 4, mm_e)
    apply = t(px_in * ci * elem + px_out * co * elem + b * cm * elem, mm_e + 2 * cm * co * px_out)
    return sums, apply


def tail_q_scales(x, ops):
    """Calibrated-style scales of the int8 tail from the float chain on the
    first image: abs-max / 127 of x, of conv1's input and of the head's."""
    import torch
    import torch.nn.functional as F

    from human_instance_segmentation_tpu_torch.ops import cuda_tail
    from human_instance_segmentation_tpu_torch.ops.sampling import upsample_2x_bilinear

    k0, bn0, k1, bn1, _, _ = ops
    s0, t0 = cuda_tail.fold_bn(bn0)
    s1, t1 = cuda_tail.fold_bn(bn1)
    y = upsample_2x_bilinear(x[:1].float().permute(0, 3, 1, 2), axes=(2, 3))
    y0 = F.relu(cuda_tail._conv(y, k0) * s0[:, None, None] + t0[:, None, None])
    y1 = F.relu(cuda_tail._conv(y0, k1) * s1[:, None, None] + t1[:, None, None])
    return tuple(max(float(v.abs().max()), 1e-6) / 127.0 for v in (x.float(), y0, y1))


def check_mbconv_and_tail_q(card: str, rng) -> list:
    """Phase 12: the fused MBConv (both passes) and the int8 fused tail
    against their plain versions at the served and at ragged shapes, timed
    beside the plain versions and the chains the model would run instead."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_mbconv, cuda_tail, quant

    dev = torch.device("cuda")
    results = []

    # ---- fused_mbconv ---------------------------------------------------
    worst = {"sums": 0.0, "apply": 0.0}
    ms = {"sums": 0.0, "apply": 0.0, "fused": 0.0, "plain_sums": 0.0, "plain": 0.0, "chain": 0.0}
    bounds = {"sums": [0.0, 0.0], "apply": [0.0, 0.0]}
    # the served encoder hands its blocks channels-last memory (its NHWC input
    # is viewed as NCHW and cuDNN keeps the format): that is the timed layout;
    # contiguous NCHW is checked beside it
    cl, nchw = torch.channels_last, torch.contiguous_format
    cases = [(c, dt, fmt, True) for c in MBCONV_SHAPES
             for dt, fmt in ((torch.float32, nchw), (torch.bfloat16, cl))]
    cases += [(c, dt, fmt, False) for c in MBCONV_RAGGED
              for dt, fmt in ((torch.float32, cl), (torch.bfloat16, nchw), (torch.bfloat16, cl))]
    for (shape, expand, k, stride, co), dt, fmt, served in cases:
        b, ci, h, w = shape
        residual = stride == 1 and ci == co
        x = torch.tensor(rng.standard_normal(shape), dtype=dt,
                         device=dev).contiguous(memory_format=fmt)
        ops = mbconv_operands(rng, ci, expand, k, co, dt, dev)
        we, be, wdw, bdw, wr, br, ws, bs, wp, bp = ops
        kw = dict(kernel=k, stride=stride)
        got_sums = cuda_mbconv.mbconv_sums(x, we, be, wdw, bdw, **kw)
        got = cuda_mbconv.fused_mbconv(x, *ops, residual=residual, **kw)
        torch.cuda.synchronize()
        ref_sums = cuda_mbconv.mbconv_sums_plain(x, we, be, wdw, bdw, **kw)
        ref = cuda_mbconv.fused_mbconv_plain(x, *ops, residual=residual, **kw)
        count = (h // stride) * (w // stride)
        serr = ((got_sums - ref_sums).abs() / count).max().item()  # as an error of the mean
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        name = str(dt).split(".")[1]
        atol, rtol = TOL_MBCONV[name]
        layout = "channels-last" if fmt == cl else "NCHW"
        print(f"fused_mbconv {shape} e{expand} k{k} s{stride} -> {co} {name} {layout}: mean-of-d "
              f"max_abs_err={serr:.3e} (atol {TOL_MBCONV_MEAN[name]}), y max_abs_err={err:.3e} "
              f"(atol {atol}, rtol {rtol:.2e}), |ref| max {ref.float().abs().max().item():.2f}")
        if got.shape != ref.shape or got.dtype != dt or not torch.isfinite(got.float()).all() \
                or not got.is_contiguous(memory_format=fmt):
            raise AssertionError(f"fused_mbconv {shape} {name}: bad output")
        if serr > TOL_MBCONV_MEAN[name] or not bool((diff <= atol + rtol * ref.float().abs()).all()):
            raise AssertionError(f"fused_mbconv {shape} k{k} s{stride} {name}: {serr}, {err}")
        if dt == torch.float32:
            worst["sums"] = max(worst["sums"], serr)
            worst["apply"] = max(worst["apply"], err)
        if served and dt == torch.bfloat16:
            se = cuda_mbconv.squeeze_excite(got_sums, count, wr, br, ws, bs, dt)
            t = {"sums": median_ms(lambda: cuda_mbconv.mbconv_sums(x, we, be, wdw, bdw, **kw)),
                 "apply": median_ms(lambda: cuda_mbconv.mbconv_apply(
                     x, se, we, be, wdw, bdw, wp, bp, residual=residual, **kw)),
                 "fused": median_ms(lambda: cuda_mbconv.fused_mbconv(
                     x, *ops, residual=residual, **kw)),
                 "plain_sums": median_ms(lambda: cuda_mbconv.mbconv_sums_plain(
                     x, we, be, wdw, bdw, **kw), reps=5, warmup=1),
                 "plain": median_ms(lambda: cuda_mbconv.fused_mbconv_plain(
                     x, *ops, residual=residual, **kw), reps=5, warmup=1),
                 "chain": median_ms(unfused_mbconv_chain(x, ci, expand, k, stride, co))}
            bs_, ba_ = mbconv_bounds(shape, expand, k, stride, co, 2)
            print(f"fused_mbconv bf16 channels-last {shape} e{expand} k{k} s{stride}: sums kernel "
                  f"{t['sums']:.4f} ms (bound {max(bs_):.4f}), apply kernel {t['apply']:.4f} ms "
                  f"(bound {max(ba_):.4f}), both with the squeeze-excite ops {t['fused']:.4f} ms, "
                  f"plain {t['plain']:.4f} ms, unfused bf16 MBConv module (cuDNN) "
                  f"{t['chain']:.4f} ms (median of {TIMING_REPS}, CUDA events) [{card}]")
            for key in ms:
                ms[key] += t[key]
            for key, bb in (("sums", bs_), ("apply", ba_)):
                bounds[key][0] += bb[0]
                bounds[key][1] += bb[1]
        del x, got, ref, diff
        torch.cuda.empty_cache()
    print(f"fused_mbconv bf16 channels-last, the six served blocks together: sums "
          f"{ms['sums']:.4f} ms, apply {ms['apply']:.4f} ms, fused (2 launches + squeeze-excite) "
          f"{ms['fused']:.4f} ms, plain {ms['plain']:.4f} ms, unfused bf16 MBConv modules "
          f"{ms['chain']:.4f} ms [{card}]")
    for key, line in (("sums", 183), ("apply", 201)):
        tb, to = bounds[key]
        results.append({
            "name": f"mbconv_{key}", "route": "cuda",
            "source": "human_instance_segmentation_tpu_torch/csrc/mbconv.cu",
            "replaces": f"human_instance_segmentation_tpu/ops/pallas_mbconv.py:{line}",
            "max_abs_err": worst[key], "ms": ms[key],
            "plain_ms": ms["plain_sums"] if key == "sums" else ms["plain"],
            # no single PyTorch call computes an MBConv: the chain is the unfused
            # module (both passes together replace it)
            "library_ms": ms["chain"] if key == "apply" else None,
            "library": "chain: the unfused bf16 MBConv modules (cuDNN), six blocks",
            "chain_ms": ms["chain"], "fused_ms": ms["fused"], "shapes": "sum over MBCONV_SHAPES",
            "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"})

    # ---- tail_q -----------------------------------------------------------
    worst, timing = 0.0, None
    b, h, w, ci, c = TAIL_SHAPE
    cases = [(TAIL_SHAPE, dt, kind) for dt, kind in (
        (torch.bfloat16, "nchw"), (torch.float32, "nchw"), (torch.bfloat16, "int8"),
        (torch.float32, "int8"))]
    cases += [(shape, dt, kind) for shape in ((2, 13, 19, 5, 12), (1, 9, 21, 12, 20),
                                              (1, 16, 40, 48, 16))
              for dt in (torch.float32, torch.bfloat16) for kind in ("nhwc", "int8")]
    for shape, dt, kind in cases:
        cb, chh, cw, cci, cc = shape
        ops = tail_operands(rng, cci, cc, dt, dev)
        x = torch.tensor(rng.standard_normal((cb, chh, cw, cci)), dtype=dt, device=dev)
        sx, sm, sh = tail_q_scales(x, ops)
        sx *= 0.8  # some inputs clip
        if kind == "nchw":
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        xin = quant.quantize_symmetric(x, sx) if kind == "int8" else x
        got = cuda_tail.tail_q(xin, *ops, sx, sm, sh, out_dtype=dt)
        torch.cuda.synchronize()
        ref = cuda_tail.tail_q_plain(xin, *ops, sx, sm, sh, out_dtype=dt)
        flt = cuda_tail.tail_plain(x, *ops)
        torch.cuda.synchronize()
        name = str(dt).split(".")[1]
        if got.shape != (cb, 2 * chh, 2 * cw) or got.dtype != dt:
            raise AssertionError(f"tail_q {shape} {name}: output {tuple(got.shape)} {got.dtype}")
        diff = (got.float() - ref.float()).abs()
        bd = cuda_tail.BORDER
        inner = diff[:, bd:-bd, bd:-bd]
        ierr = inner.max().item() if inner.numel() else 0.0
        atol, rtol = TOL_TAIL[name]
        edge_ok = bool((diff <= atol + rtol * ref.float().abs()).all())
        rel = ((got.float() - flt.float()).abs().max() / flt.float().abs().max()).item()
        print(f"tail_q {shape} {name} {kind} input: interior max_abs_err={ierr:.3e} (tol 0, "
              f"{inner.numel()} pixels), border max_abs_err={diff.max().item():.3e} (atol {atol}, "
              f"rtol {rtol}); distance from the float tail {100 * rel:.2f}% of its max")
        if ierr != 0.0 or not edge_ok or not torch.isfinite(got.float()).all():
            raise AssertionError(f"tail_q {shape} {name} {kind}: interior {ierr}, border "
                                 f"{diff.max().item()}")
        if dt == torch.float32:
            worst = max(worst, diff.max().item())
        if (shape, dt, kind) == (TAIL_SHAPE, torch.bfloat16, "nchw"):  # the served form
            wq = cuda_tail.build_tail_weights_q(*ops, sx, sm, sh)
            packed = cuda_tail.pack_tail_weights_q(wq, ops, dt)

            def served():
                return cuda_tail.tail_q(x, *ops, sx, sm, sh, packed=packed)

            # a served call allocates its output and nothing else (no int8
            # copy of x), and launches only the tail's own kernels
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = served()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            if extra > y.numel() * y.element_size() + (1 << 20):
                raise AssertionError(f"tail_q allocated {extra} bytes beyond its output")
            del y
            listing = device_ms_by_kernel(served)
            if len(listing) > 2 or any("tail" not in k for k in listing):
                raise AssertionError(f"tail_q: device ops besides its kernels: {listing}")
            kms = median_ms(served)
            kms10 = median_ms(served, calls=10)
            bms = median_ms(lambda: cuda_tail.tail_q(x, *ops, sx, sm, sh))
            pms = median_ms(lambda: cuda_tail.tail_q_plain(x, *ops, sx, sm, sh), reps=3, warmup=1)
            fms = median_ms(lambda: cuda_tail.tail(x, *ops))
            cms = median_ms(unfused_tail_chain(x.permute(0, 3, 1, 2), *ops,
                                               int8_scales=(sx, sm)))
            timing = (kms, pms, cms, fms, kms10)
            clocks = clocks_under(served)
            print(f"tail_q bf16 {TAIL_SHAPE}: kernel {kms:.4f} ms with kept weights ({kms10:.4f} "
                  f"ms ten launches in a row), {bms:.4f} ms building them per call, plain "
                  f"(float64 convs) {pms:.4f} ms, float tail kernel {fms:.4f} ms, unfused int8 "
                  f"decoder stage + bf16 seg head of the model {cms:.4f} ms (median of "
                  f"{TIMING_REPS}, CUDA events); a served call allocates {extra} bytes (its "
                  f"output {x.shape[0] * 4 * x.shape[1] * x.shape[2] * 2}); device ms by kernel "
                  f"{ {k_: round(v, 4) for k_, v in listing.items()} }; {clocks} [{card}]")
        del x, xin, got, ref, flt, diff
        torch.cuda.empty_cache()
    px = b * 2 * h * 2 * w
    results.append({"name": "tail_q", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/tail_q.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_tail_q.py:236",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    "library_ms": timing[2],
                    "library": "chain: unfused int8 decoder stage (qconv2d) + bf16 seg head",
                    "chain_ms": timing[2], "float_tail_ms": timing[3], "ms_10": timing[4],
                    **bound(2 * b * h * w * ci + 2 * px, 2 * 9 * (ci * c + c * c + c) * px, "int8")})
    return results


def make_request(rng, batch: int, nrois: int, hw=IMAGE_HW):
    import numpy as np

    images = rng.random((batch, *hw, 3), dtype=np.float32)
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
                                image_size=IMAGE_HW, mid_channels=mid, seed=0,
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
        if (dc, dr) != (5, 1):
            raise AssertionError(f"expected 5 conv_ln_act and 1 roi_align launch, got {dc}, {dr}")
        PER_FORWARD["roi_align"] = dr
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
    for engine in engines.values():  # the timed shape, before any timing
        engine.warmup(batch=batch, buckets=(batch,))
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(median_ms(lambda: engines[name].forward(images_t, rois_t),
                                     reps=TIMING_REPS // 2, warmup=0))
    for name, ms in times.items():
        med = statistics.median(ms)
        busy, kernels, _ = forward_profile(engines[name], images_t, rois_t)
        print(f"forward batch {batch} x 1 roi, bf16, {name} path: {med:.3f} ms/batch, "
              f"{batch / med * 1e3:.1f} img/s (median of per-round medians {ms}, "
              f"{TIMING_REPS // 2} forwards each, CUDA events); device busy {busy:.3f} ms "
              f"({100 * (1 - busy / med):.1f}% idle), {kernels} kernels per forward [{card}]")


def forward_profile(engine, images_t, rois_t, reps: int = 3):
    """Device time per forward (``torch.profiler``): busy ms, kernels, and
    the CUDA events of ``reps`` forwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.forward(images_t, rois_t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.forward(images_t, rois_t)
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages() if ev.device_type.name == "CUDA"]
    busy = sum(ev.self_device_time_total for ev in events) / (reps * 1e3)
    return busy, sum(ev.count for ev in events) // reps, events


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
    timing, worst, shapes = None, 0.0, {}
    for name, (n, h, w, ci, co, k) in QCONV_SHAPES.items():
        x32 = torch.tensor(rng.standard_normal((n, h, w, ci)), dtype=torch.float32, device=dev)
        w32 = torch.tensor(rng.standard_normal((k, k, ci, co)) / (k * k * ci) ** 0.5,
                           dtype=torch.float32, device=dev)
        bias = torch.tensor(rng.standard_normal(co), dtype=torch.float32, device=dev)
        sx = float(x32.abs().max()) / 127.0 * 0.8  # some activations clip
        xq = quant.quantize_symmetric(x32, sx)
        xb, wb = x32.to(torch.bfloat16), w32.to(torch.bfloat16)
        wide = torch.empty((n, h, w, ci + 16), dtype=torch.bfloat16, device=dev)
        wide[..., :ci] = xb
        # (dtype, case, input, the case whose plain result it must equal, bias)
        cases = [(torch.float32, "static", x32, None, None),
                 (torch.bfloat16, "static", xb, None, None),
                 (torch.bfloat16, "int8 input", xq, None, None),
                 (torch.float32, "dynamic", x32, None, None),
                 (torch.bfloat16, "int8 input, unaligned", unaligned(xq), "int8 input", None),
                 (torch.bfloat16, "static, unaligned", unaligned(xb), "static", None),
                 (torch.bfloat16, "static, NCHW memory",
                  xb.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), "static", None),
                 (torch.bfloat16, "static, pixel stride Ci + 16", wide[..., :ci], "static", None),
                 (torch.bfloat16, "static, bias", xb, "static", bias)]
        refs = {}
        for dt, mode, xin, same_as, bs in cases:
            wt = w32.to(dt)
            scale = None if mode == "dynamic" else sx
            got = quant.qconv2d(xin, wt, 1, k // 2, scale, bias=bs)
            torch.cuda.synchronize()
            if same_as is None:
                # the plain version on this very input; kept for the cases
                # that feed the same values through another layout
                ref = refs[(dt, mode)] = quant.qconv2d_plain(xin, wt, 1, k // 2, scale)
            else:
                ref = refs[(dt, same_as)]
                if bs is not None:  # the order before the epilogue took it: a separate add
                    ref = ref + bs.to(ref.dtype)
            err = (got.float() - ref.float()).abs().max().item()
            print(f"qconv2d {name} {tuple(xin.shape)}->{co} k={k} {dt} {mode}: "
                  f"max_abs_err={err:.3e} (tol 0)")
            if got.dtype != ref.dtype or err != 0.0 or not torch.isfinite(got.float()).all():
                raise AssertionError(f"qconv2d {name} {dt} {mode}: {err}")
            worst = max(worst, err)
            del got, ref
        del refs, wide
        # timed as a QConv runs it: operands prepared once, bf16, static scale
        ops = quant.s8_operands(quant.s8_weights(wb), sx, None, torch.bfloat16)
        def conv():
            return quant.qconv2d(xb, None, 1, k // 2, prepared=ops)

        kms = median_ms(conv)  # one call between the events, as the earlier readings
        sms = median_ms(conv, calls=10)  # launches in a row: the host runs ahead
        xc, wc = xb.permute(0, 3, 1, 2).contiguous(), wb.permute(3, 2, 0, 1).contiguous()
        cms = median_ms(lambda: torch.nn.functional.conv2d(xc, wc, padding=k // 2), calls=10)
        xl, wl = xb.permute(0, 3, 1, 2), wc.contiguous(memory_format=torch.channels_last)
        lms = median_ms(lambda: torch.nn.functional.conv2d(xl, wl, padding=k // 2), calls=10)
        px = n * h * w
        qbound = bound(px * ci * 2 + k * k * ci * co + px * co * 2, 2 * k * k * ci * co * px,
                       "int8")
        dev_ms = device_ms_by_kernel(conv)
        shapes[name] = {"ms": sms, "single_call_ms": kms, "device_ms": sum(dev_ms.values()),
                        **qbound, "cudnn_bf16_ms": min(cms, lms)}
        print(f"qconv2d {name} bf16 {tuple(xb.shape)}->{co} k={k}: kernel {sms:.4f} ms (10 "
              f"launches in a row; {kms:.4f} ms for one call between the events; device time "
              f"{sum(dev_ms.values()):.4f} ms: { {k_: round(v, 4) for k_, v in dev_ms.items()} }), "
              f"bound {qbound['bound_ms']:.4f} ms ({qbound['bound_by']}), bf16 cuDNN conv NCHW "
              f"{cms:.4f} ms, channels-last {lms:.4f} ms [{card}]")
        if name.startswith("decoder"):
            # the stage-1 decoder hands conv0 the concatenation of the upsampled map and the
            # skip, which lies in NCHW memory: read through its strides, no copy
            xn = xb.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            nms = median_ms(lambda: quant.qconv2d(xn, None, 1, k // 2, prepared=ops), calls=10)
            shapes[name]["nchw_memory_ms"] = nms
            print(f"qconv2d {name}: {nms:.4f} ms on the same values in NCHW memory [{card}]")
            del xn
        if name == "decoder4/conv0":
            pms = median_ms(lambda: quant.qconv2d_plain(xb, None, 1, k // 2, prepared=ops),
                            reps=3, warmup=1)
            timing = (sms, pms, min(cms, lms), qbound, kms)
        del x32, w32, xq, xb, wb, xc, wc, xl, wl, ops
        torch.cuda.empty_cache()

    # ---- (b) s8_matmul: the probe and a 4096^3 GEMM ----------------------
    ones = torch.ones((256, 256), dtype=torch.int8, device=dev)
    probe = quant.s8_matmul(ones, ones)
    torch.cuda.synchronize()
    if not bool((probe == 256).all()):
        raise AssertionError("s8_matmul 256x256 all-ones probe: not every entry is 256")
    pbound = bound(3 * 256 * 256 + 256 * 256 * 4, 2 * 256 ** 3, "int8")
    probe_ms = median_ms(lambda: quant.s8_matmul(ones, ones))
    probe_plain_ms = median_ms(lambda: quant.s8_matmul_plain(ones, ones))
    probe_lib_ms = median_ms(lambda: torch._int_mm(ones, ones))
    print(f"s8_matmul 256x256 all-ones probe: every entry 256; {probe_ms:.4f} ms, plain (float64 "
          f"GEMM) {probe_plain_ms:.4f} ms, torch._int_mm {probe_lib_ms:.4f} ms (one call "
          f"between the events each), bound {pbound['bound_ms']:.6f} ms by "
          f"{pbound['bound_by']} [{card}]")
    m = 4096
    a = torch.randint(-127, 128, (m, m), dtype=torch.int8, device=dev)
    b = torch.randint(-127, 128, (m, m), dtype=torch.int8, device=dev)
    got = quant.s8_matmul(a, b)
    torch.cuda.synchronize()
    lib = torch._int_mm(a, b)  # the library's s8 GEMM: a yardstick here, never called by the port
    err = (got.to(torch.float64) - quant.s8_matmul_plain(a, b).to(torch.float64)).abs().max().item()
    print(f"s8_matmul {m}^3: max_abs_err={err} (tol 0); equal to torch._int_mm: "
          f"{bool(torch.equal(got, lib))}")
    if err != 0.0 or not torch.equal(got, lib):
        raise AssertionError(f"s8_matmul {m}^3: {err}")
    worst = max(worst, err)
    packed = quant.pack_matmul_b(b)  # as a conv keeps its weights: packed once
    gms = median_ms(lambda: quant.s8_matmul(a, b, packed), calls=10)
    gms_one = median_ms(lambda: quant.s8_matmul(a, b, packed))
    gms_pack = median_ms(lambda: quant.s8_matmul(a, b), calls=10)
    gpms = median_ms(lambda: quant.s8_matmul_plain(a, b), reps=5, warmup=1)
    bt = b.t().contiguous().t()  # column-major b, the layout cuBLASLt's s8 GEMM reads
    lms = min(median_ms(lambda: torch._int_mm(a, b), calls=10),
              median_ms(lambda: torch._int_mm(a, bt), calls=10))
    tops = 2 * m ** 3 / (gms * 1e-3) / 1e12
    gbound = bound(2 * m * m + 4 * m * m, 2 * m ** 3, "int8")
    print(f"s8_matmul {m}^3: kernel {gms:.4f} ms = {tops:.1f} TOPS "
          f"({100 * tops / INT8_PEAK_TOPS:.1f}% of the {INT8_PEAK_TOPS:.0f} TOPS dense int8 "
          f"peak; 10 launches in a row, as the library call beside it; {gms_one:.4f} ms for one "
          f"call between the events; {gms_pack:.4f} ms when b is packed K-major at every call), bound "
          f"{gbound['bound_ms']:.4f} ms ({gbound['bound_by']}), torch._int_mm {lms:.4f} ms "
          f"(kernel / library {gms / lms:.2f}), plain (float64 GEMM) {gpms:.4f} ms [{card}]")
    del a, b, bt, got, lib, packed
    results.append({"name": "qconv", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/qconv.cu",
                    "replaces": "scripts/exp_r4_probe.py:86",
                    "also_replaces": "scripts/exp_r4_probe.py:59",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    # no PyTorch call runs an s8 conv on the card: the nearest
                    # library call is cuDNN's bf16 conv of the same shape
                    "library_ms": timing[2],
                    "library": "F.conv2d bf16 (cuDNN, best of NCHW and channels-last), not s8",
                    **timing[3], "single_call_ms": timing[4], "shapes": shapes,
                    "s8_matmul_4096_ms": gms,
                    "s8_matmul_4096_tops": tops, "s8_matmul_4096_bound_ms": gbound["bound_ms"],
                    "s8_matmul_4096_library_ms": lms, "s8_matmul_4096_library": "torch._int_mm",
                    "probe_256_ms": probe_ms, "probe_256_plain_ms": probe_plain_ms,
                    "probe_256_library_ms": probe_lib_ms,
                    "probe_256_bound_ms": pbound["bound_ms"]})

    # ---- (c) conv_ln_act, int8 form --------------------------------------
    n, h, w, c = HEAD_SHAPE
    worst, timing = 0.0, None
    cases = [((n, h, w, c), k, res, dt) for dt in (torch.float32, torch.bfloat16)
             for k, res in ((3, False), (3, True), (1, False))]
    cases += [((3, 5, 7, 260), 3, True, dt) for dt in (torch.float32, torch.bfloat16)]
    # the pure-RGB bottleneck (phase 15a: 64 ROIs of 64 x 64 -> 16 x 16 x 384),
    # whose LayerNorm pass caches 48 KB a block
    cases += [((64, 16, 16, c), 3, True, dt) for dt in (torch.float32, torch.bfloat16)]
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
            # as the blocks run it: the int8 operands prepared once
            ops = cuda_head.prepare_s8(wt, xs, b, g, be)
            same = cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w, xscale=xs,
                                         prepared=ops)
            if not torch.equal(same, got):
                raise AssertionError("conv_ln_act s8: prepared operands change the result")

            def fused():
                return cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w, xscale=xs,
                                             prepared=ops)

            bf16_ops = cuda_head.prepare_bf16(wt, b, g, be)

            def bf16_form():
                return cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w,
                                             prepared=bf16_ops)

            kms = median_ms(fused)
            kms10 = median_ms(fused, calls=10)
            each = median_ms(lambda: cuda_head.conv_ln_act(x, wt, b, g, be, height=h, width=w,
                                                           xscale=xs))
            pms = median_ms(lambda: cuda_head.conv_ln_act_plain(x, wt, b, g, be, xscale=xs))
            bms = median_ms(bf16_form)
            bms10 = median_ms(bf16_form, calls=10)
            timing = (kms, pms, kms10)
            dev_ms = device_ms_by_kernel(fused)
            bdev_ms = device_ms_by_kernel(bf16_form)
            print(f"conv_ln_act s8 bf16 k=3 {HEAD_SHAPE}->{c}: kernel {kms:.4f} ms "
                  f"({kms10:.4f} ms ten launches in a row; {each:.4f} ms when the weights are "
                  f"quantized at every call), plain {pms:.4f} ms; the bf16 conv_ln_act kernel "
                  f"with prepared operands in the same run {bms:.4f} ms ({bms10:.4f} ten in a "
                  f"row) (median of {TIMING_REPS}, CUDA events); device time by kernel: s8 "
                  f"{ {k_: round(v, 4) for k_, v in dev_ms.items()} } ms, bf16 "
                  f"{ {k_: round(v, 4) for k_, v in bdev_ms.items()} } ms, the rest is the host "
                  f"[{card}]")
    results.append({"name": "conv_ln_act_s8", "route": "cuda",
                    "source": "human_instance_segmentation_tpu_torch/csrc/conv_ln_act.cu",
                    "replaces": "human_instance_segmentation_tpu/ops/pallas_head.py:243",
                    "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
                    "library_ms": None, "ms_10": timing[2], **head_bound("int8")})
    return results


def int8_engine(mid: int, dtype, kernels: bool, scales=None):
    """The B0 flagship served with ``quantize="int8", fused_head=True``: the
    kernel path, or (``kernels=False``) the same graph computed by the
    plain versions (plain fused unit, s8 conv and LayerNorm2d chains, plain
    crops)."""
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine, create_flagship

    model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                            image_size=IMAGE_HW, mid_channels=mid, seed=0,
                            pallas_roi_align=kernels)
    engine = InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=True,
                             quantize="int8", kernels=kernels)
    engine.scales = dict(scales) if scales is not None else None
    return engine


@contextlib.contextmanager
def served_eagerly(engine):
    """The engine's calls in the block serve eagerly, never from a CUDA
    graph: for checks that read values back to the host inside a served
    call, which no graph can hold (and for eager timings)."""
    engine._graphs_on = lambda: False
    try:
        yield
    finally:
        del engine._graphs_on


def check_int8_calls(engine, images, rois) -> dict:
    """Serve one request and hold every s8 kernel call of that forward
    against its plain version on the very inputs the forward gave it:
    qconv2d exactly, conv_ln_act's int8 form within ``TOL_CONV``. Returns
    {kernel: (calls checked, max abs error)}, and under ``"s8_shapes"`` the
    int8 conv_ln_act calls by (H, W, Ci, Co)."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_head, quant

    real_c = cuda_head.conv_ln_act
    seen = {"qconv": [0, 0.0], "conv_ln_act_s8": [0, 0.0]}
    shapes: dict = {}

    def check_qconv(m, args, y):
        x = args[0]
        if not (m.runs_int8 or x.dtype == torch.int8):
            return
        # the plain version on the forward's own input, the weights quantized
        # anew from the module's parameters, the bias added separately
        dtype = m.weight.dtype if x.dtype == torch.int8 else x.dtype
        ref = quant.qconv2d_plain(x.permute(0, 2, 3, 1), m.weight.to(dtype).permute(2, 3, 1, 0),
                                  m.stride[0], m.padding[0], m.static_scale)
        if m.bias is not None:
            ref = ref + m.bias.to(ref.dtype)
        err = (y.permute(0, 2, 3, 1).float() - ref.float()).abs().max().item()
        if y.dtype != ref.dtype or err != 0.0:
            raise AssertionError(f"qconv2d {tuple(x.shape)} -> {m.out_channels} in the forward: "
                                 f"{err}")
        seen["qconv"][0] += 1

    def fused(*args, **kwargs):
        y = real_c(*args, **kwargs)
        if kwargs.get("xscale") is not None:
            plain_kw = {k: v for k, v in kwargs.items()
                        if k not in ("height", "width", "prepared")}  # weights quantized anew
            ref = cuda_head.conv_ln_act_plain(*args, **plain_kw)
            diff = (y.float() - ref.float()).abs()
            atol, rtol = TOL_CONV[str(y.dtype).split(".")[1]]
            if not bool((diff <= atol + rtol * ref.float().abs()).all()):
                raise AssertionError(f"conv_ln_act s8 in the forward: {diff.max().item()}")
            seen["conv_ln_act_s8"][0] += 1
            seen["conv_ln_act_s8"][1] = max(seen["conv_ln_act_s8"][1], diff.max().item())
            key = (args[0].shape[1], args[0].shape[2], args[0].shape[-1], args[1].shape[-1])
            shapes[key] = shapes.get(key, 0) + 1
        return y

    # the wrapper's own launch counter resolves to this name while patched
    fused.launches = 0
    hooks = [m.register_forward_hook(check_qconv) for m in engine.model.modules()
             if isinstance(m, quant.QConv)]
    cuda_head.conv_ln_act = fused
    try:
        with served_eagerly(engine):  # the checks read values back to the host
            engine(images, rois)
    finally:
        cuda_head.conv_ln_act = real_c
        for hook in hooks:
            hook.remove()
    torch.cuda.synchronize()
    return {**{k: tuple(v) for k, v in seen.items()}, "s8_shapes": shapes}


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
        if (d["conv_ln_act"], d["conv_ln_act_s8"], d["roi_align"]) != (0, 5, 1):
            raise AssertionError(f"expected 0 bf16 + 5 s8 conv_ln_act and 1 roi_align, got {d}")
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
    from human_instance_segmentation_tpu_torch.ops import cuda_head, quant

    batch = 32
    images, rois = make_request(rng, batch, batch)
    images_t = torch.tensor(images, device="cuda", dtype=torch.bfloat16)
    rois_t = torch.tensor(pad_rois(rois, batch), device="cuda")
    engines = {"bf16": served_bf16, "int8": served_int8}
    served_int8.calibrate(images, rois)
    crops = {}
    for name, e in engines.items():
        e.forward(images_t, rois_t)
        with torch.inference_mode():
            _, aux = e.model(images_t, rois_t)
        crops[name] = (aux["roi_patches"], aux["roi_bg_fg"])

    def stage2(name):
        with torch.inference_mode():
            return engines[name].model.stage2(*crops[name])

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
    s8 = sum(e.self_device_time_total for e in events if "s8igemm" in e.key)
    ln = sum(e.self_device_time_total for e in events if "ln_act_kernel" in e.key)
    print(f"int8 stage 2 profile (3 calls): device total {total / 3e3:.3f} ms per call; s8 conv "
          f"kernels (qconv2d and the fused unit's conv, staging included) {s8 / 3e3:.3f} ms "
          f"({100 * s8 / max(total, 1):.1f}%), the fused unit's LayerNorm pass {ln / 3e3:.3f} ms "
          f"({100 * ln / max(total, 1):.1f}%), {sum(e.count for e in events) // 3} kernels per "
          f"call [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 3e3:8.3f} ms/call  {e.count // 3:4d}x  {e.key[:90]}")

    # the whole int8 forward: launches, kernels, device time, idle share
    counters = {"qconv2d": quant.qconv2d, "conv_ln_act_s8": cuda_head.conv_ln_act_s8}
    c0 = {k: f.launches for k, f in counters.items()}
    q0 = quant.QConv.int8_calls
    served_int8.forward(images_t, rois_t)
    torch.cuda.synchronize()
    counts = {k: f.launches - c0[k] for k, f in counters.items()}
    counts["int8_calls"] = quant.QConv.int8_calls - q0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            served_int8.forward(images_t, rois_t)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 3e3
    s8 = sum(e.self_device_time_total for e in events if "s8igemm" in e.key) / 3e3
    for e in sorted((e for e in events if "s8igemm" in e.key),
                    key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / 3e3:8.3f} ms/forward  {e.count // 3:4d}x  "
              f"{e.key.replace('(anonymous namespace)::', '')[:100]}")
    wall = statistics.median(fwd["int8"])
    print(f"int8 forward profile (3 forwards): device busy {busy:.3f} ms per forward of "
          f"{wall:.3f} ms wall ({100 * (1 - busy / wall):.1f}% idle), "
          f"{sum(e.count for e in events) // 3} kernels per forward, s8 conv kernels {s8:.3f} ms; "
          f"launches per forward: qconv2d.launches {counts['qconv2d']}, "
          f"conv_ln_act_s8.launches {counts['conv_ln_act_s8']}, QConv.int8_calls "
          f"{counts['int8_calls']} [{card}]")


def serve_with_tail(card: str, rng) -> dict:
    """Phase 10: the flagship with the fused stage-1 tail
    (``create_flagship(pallas_tail=True)``) served in bf16 and float32 with
    ``fused_head=True``; launch counts asserted per forward; outputs held
    against the same weights with ``pallas_tail=False`` (float32: binary
    max-abs <= 1e-4, instance agreement >= MIN_AGREE; bf16: binary <= 1e-2
    and an agreement with the float32 reference no more than 0.002 below the
    bf16 ``pallas_tail=False`` path's own). Returns the launch counts of the
    served bf16 forwards."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.inference import (InferenceEngine,
                                                                 create_flagship, pad_rois)
    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align, cuda_tail

    def engine(dtype, tail: bool):
        model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                                image_size=IMAGE_HW, mid_channels=128, seed=0,
                                pallas_tail=tail)
        return InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=True)

    counters = {"tail": cuda_tail.tail, "conv_ln_act": cuda_head.conv_ln_act,
                "roi_align": cuda_roi_align.roi_align}
    served = engine(torch.bfloat16, True)
    requests = [make_request(rng, 4, 3), make_request(rng, 32, 32)]
    for f in counters.values():
        f.launches = 0
    outs = []
    for images, rois in requests:
        c0 = {k: f.launches for k, f in counters.items()}
        outs.append(served(images, rois))
        d = {k: f.launches - c0[k] for k, f in counters.items()}
        print(f"tail flagship batch {images.shape[0]} x {rois.shape[0]} rois: launches {d} "
              f"(one forward)")
        if d != {"tail": 1, "conv_ln_act": 5, "roi_align": 1}:
            raise AssertionError(f"expected 1 tail, 5 conv_ln_act, 1 roi_align launch, got {d}")
    launches = {k: f.launches for k, f in counters.items()}

    no_tail_bf16 = engine(torch.bfloat16, False)
    others = {"no tail bf16": no_tail_bf16, "tail f32": engine(torch.float32, True),
              "no tail f32": engine(torch.float32, False)}
    for (images, rois), (inst, binary) in zip(requests, outs):
        b, n = images.shape[0], rois.shape[0]
        if inst.shape != (n, *MASK_HW, 1) or binary.shape != (b, *IMAGE_HW, 1):
            raise AssertionError(f"bad output shapes {inst.shape}, {binary.shape}")
        if not (np.isfinite(inst).all() and np.isfinite(binary).all()):
            raise AssertionError("non-finite outputs")
        t0 = cuda_tail.tail.launches
        o = {name: e(images, rois) for name, e in others.items()}
        if cuda_tail.tail.launches != t0 + 1:
            raise AssertionError("the float32 tail engine did not launch the tail kernel once")
        tag = f"tail flagship batch {b} x {n} rois"
        bin_f32 = float(np.abs(o["tail f32"][1] - o["no tail f32"][1]).max())
        agree_f32 = _agreement(o["tail f32"][0], o["no tail f32"][0])
        print(f"{tag} f32 tail vs pallas_tail=False: binary max_abs_err {bin_f32:.3e} (tol 1e-4), "
              f"instance agreement {agree_f32:.6f} (min {MIN_AGREE})")
        bin_bf16 = float(np.abs(binary - o["no tail bf16"][1]).max())
        bin_ref = float(np.abs(binary - o["no tail f32"][1]).max())
        bin_ref_p = float(np.abs(o["no tail bf16"][1] - o["no tail f32"][1]).max())
        agree_k = _agreement(inst, o["no tail f32"][0])
        agree_p = _agreement(o["no tail bf16"][0], o["no tail f32"][0])
        print(f"{tag} bf16 tail vs pallas_tail=False: binary max_abs_err {bin_bf16:.3e} (tol "
              f"1e-2); binary vs f32: tail {bin_ref:.3e}, no tail {bin_ref_p:.3e}; instance "
              f"agreement vs f32: tail {agree_k:.6f}, no tail {agree_p:.6f} (tail >= no tail - "
              f"0.002)")
        if not (bin_f32 <= 1e-4 and agree_f32 >= MIN_AGREE):
            raise AssertionError(f"{tag}: the f32 tail disagrees with pallas_tail=False")
        if not (bin_bf16 <= 1e-2 and agree_k >= agree_p - 0.002):
            raise AssertionError(f"{tag}: the bf16 tail is further from f32 than pallas_tail=False")
    del others, o
    torch.cuda.empty_cache()
    print(f"before timing: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")

    batch = 32
    images, rois = make_request(rng, batch, batch)
    images_t = torch.tensor(images, device="cuda", dtype=torch.bfloat16)
    rois_t = torch.tensor(pad_rois(rois, batch), device="cuda")
    engines = {"tail": served, "no tail": no_tail_bf16}
    times = {"tail": [], "no tail": []}
    for name in ("no tail", "tail", "tail", "no tail"):
        times[name].append(median_ms(lambda: engines[name].forward(images_t, rois_t),
                                     reps=TIMING_REPS // 2))
    for name, ms in times.items():
        med = statistics.median(ms)
        print(f"forward batch {batch} x 1 roi, bf16, fused head, {name}: {med:.3f} ms/batch, "
              f"{batch / med * 1e3:.1f} img/s (per-round medians {ms}, {TIMING_REPS // 2} "
              f"forwards each, CUDA events) [{card}]")
    return launches


def binary_mask_mode(card: str, rng) -> dict:
    """Phase 11: binary-mask mode composed from the port's public functions
    at batch 32, 480x640: ``PeopleSegmentationUNet(pallas_tail=True)`` ->
    person probability -> ``binary_mask_bilateral(k=7, iterations=2)`` ->
    ``edge_smooth_binary_mask`` -> 1 px dilation, and on the same
    probability map the exact ``bilateral_filter(k=7, 1.5, 0.2)``.

    Held against the same pipeline on the plain versions (inside
    ``ops._build.plain()``: the tail's and the two filters' plain twins)
    twice: stage by stage on the served run's own tensors (edge smoothing
    equal, bilateral within
    ``TOL_BILATERAL``), and end to end, where the tail's rounding differences
    move a probability across a threshold for a few pixels (mask agreement
    >= 0.999). Returns the launch counts of the served bf16 run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from human_instance_segmentation_tpu_torch.inference import create_flagship
    from human_instance_segmentation_tpu_torch.models import postprocess as pp
    from human_instance_segmentation_tpu_torch.ops import _build, cuda_kernels, cuda_tail
    from human_instance_segmentation_tpu_torch.ops.morphology import dilate

    batch = 32
    images = torch.tensor(rng.random((batch, *IMAGE_HW, 3)), dtype=torch.float32, device="cuda")
    counters = {"tail": cuda_tail.tail, "bilateral_filter": cuda_kernels.bilateral_filter,
                "edge_smooth": cuda_kernels.edge_smooth}

    def pipeline(unet, x, kernels: bool):
        if not unet.pallas_tail:
            raise AssertionError("binary mode must end stage 1 in the fused tail")
        with contextlib.nullcontext() if kernels else _build.plain():
            out = pp.binary_mode(unet, x, kernel_size=7, num_iterations=2, dilation_pixels=1)
            with torch.inference_mode():
                out["exact"] = pp.bilateral_filter(out["prob"], 7, 1.5, 0.2)
        return out

    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        flagship = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                                   image_size=IMAGE_HW, mid_channels=128, seed=0,
                                   pallas_tail=True)
        unet = flagship.pretrained_unet.to(dtype).eval()
        del flagship
        x = images.to(dtype)
        # random weights give an almost constant logit sign, so a mask that
        # checks nothing: centre the head's bias on this batch's median logit
        with torch.inference_mode():
            median = unet(x.permute(0, 3, 1, 2), raw=True)[1].float().median()
        with torch.no_grad():
            unet.seg_head.bias -= median.to(dtype)
        for f in counters.values():
            f.launches = 0
        served = pipeline(unet, x, True)
        torch.cuda.synchronize()
        d = {k: f.launches for k, f in counters.items()}
        name = str(dtype).split(".")[1]
        print(f"binary mode {name} batch {batch}: launches {d} (one batch)")
        if d != {"tail": 1, "bilateral_filter": 1, "edge_smooth": 1}:
            raise AssertionError(f"expected one launch of each kernel, got {d}")
        PER_FORWARD["bilateral_filter"] = d["bilateral_filter"]
        PER_FORWARD["edge_smooth"] = d["edge_smooth"]
        if dtype == torch.bfloat16:
            launches = d
        mask = served["mask"]
        if mask.shape != (batch, *IMAGE_HW, 1) or not bool(((mask == 0) | (mask == 1)).all()):
            raise AssertionError("the binary mask is not a {0, 1} map of the images' shape")
        if not torch.isfinite(served["exact"]).all():
            raise AssertionError("non-finite bilateral output")
        # stage by stage, on the served run's own tensors
        with _build.plain():
            edged_plain = pp.edge_smooth_binary_mask(served["smoothed"])
            exact_plain = pp.bilateral_filter(served["prob"], 7, 1.5, 0.2)
        ndiff = int((edged_plain != served["edged"]).sum())
        berr = (exact_plain - served["exact"]).abs().max().item()
        # end to end on the plain versions
        plain = pipeline(unet, x, False)
        agree = float((plain["mask"] == mask).float().mean())
        perr = (plain["prob"] - served["prob"]).abs().max().item()
        eerr = (plain["exact"] - served["exact"]).abs().max().item()
        print(f"binary mode {name}: edge_smooth on the served mask {ndiff} differing pixels (tol "
              f"0); bilateral_filter on the served probability max_abs_err {berr:.3e} (atol "
              f"{TOL_BILATERAL}); end to end vs plain versions: probability max_abs_err "
              f"{perr:.3e}, mask agreement {agree:.6f} (min 0.999), exact bilateral "
              f"max_abs_err {eerr:.3e}; person share {mask.float().mean():.4f}")
        if ndiff or berr > TOL_BILATERAL or agree < 0.999:
            raise AssertionError(f"binary mode {name} disagrees with its plain versions")
        if dtype == torch.bfloat16:
            times = {"kernels": [], "plain": []}
            for which in ("plain", "kernels", "kernels", "plain"):
                times[which].append(median_ms(lambda: pipeline(unet, x, which == "kernels"),
                                              reps=TIMING_REPS // 2, warmup=1))
            for which, ms in times.items():
                med = statistics.median(ms)
                print(f"binary mode batch {batch} bf16, {which}: {med:.3f} ms/batch, "
                      f"{batch / med * 1e3:.1f} img/s, mask and exact bilateral (per-round "
                      f"medians {ms}, {TIMING_REPS // 2} batches each, CUDA events) [{card}]")
            xn, prob, sm = x.permute(0, 3, 1, 2), served["prob"], served["smoothed"]
            with torch.inference_mode():
                stages = {
                    "UNet with the tail": median_ms(lambda: unet(xn, raw=True)),
                    "binary_mask_bilateral k7 x2 (plain PyTorch)": median_ms(
                        lambda: pp.binary_mask_bilateral(prob, 7, num_iterations=2)),
                    "edge_smooth kernel + 1 px dilation": median_ms(
                        lambda: dilate(pp.edge_smooth_binary_mask(sm), 1)),
                    "exact bilateral_filter kernel": median_ms(
                        lambda: pp.bilateral_filter(prob, 7, 1.5, 0.2))}
            print(f"binary mode batch {batch} bf16, kernels, by stage: "
                  + "; ".join(f"{k} {v:.3f} ms" for k, v in stages.items()) + f" [{card}]")
            # how much of a batch the card is busy: device time by the profiler
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    pipeline(unet, x, True)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            busy = sum(e.self_device_time_total for e in events) / 3e3
            tail_ms = sum(e.self_device_time_total for e in events
                          if "tail_kernel" in e.key or "tail_bf16_kernel" in e.key) / 3e3
            wall = statistics.median(times["kernels"])
            print(f"binary mode batch {batch} bf16, kernels, profile of 3 batches: device busy "
                  f"{busy:.3f} ms per batch of {wall:.3f} ms wall ({100 * (1 - busy / wall):.1f}% "
                  f"idle), {sum(e.count for e in events) // 3} kernels per batch, the tail kernel "
                  f"{tail_ms:.3f} ms [{card}]")
        del served, plain, unet, x
        torch.cuda.empty_cache()
    return launches


def serve_fused_encoder_and_tail_q(card: str, rng) -> dict:
    """Phase 13: the flagship with ``pallas_tail=True`` and
    ``encoder_fused_blocks=N`` (N = 3 and 6) served in bf16 with
    ``fused_head=True``, without quantization and with ``quantize="int8"``,
    for a batch 32 x 1 ROI request and a smaller one.

    Launch counts are asserted per forward: N ``mbconv_sums`` and N
    ``mbconv_apply``, 5 ``conv_ln_act`` (or its s8 form), 1 ``roi_align``;
    without quantization 1 ``tail``; with int8 1 ``tail_q`` (its float border
    inside, no ``tail``) and one ``qconv`` per int8-marked QConv
    outside the fused units and outside the last decoder stage, whose two
    convs the tail absorbed. Outputs are held against the same weights and
    scales served with ``kernels=False`` and ``pallas_roi_align=False`` in
    float32 (binary max-abs <= 1e-2, instance agreement >= MIN_AGREE) and in
    bf16 (as :func:`serve_and_compare`), and without quantization also
    against ``encoder_fused_blocks=0, pallas_tail=False`` in float32 (binary
    max-abs <= 1e-4: the flags change the route, not the result). Forward
    times are printed beside the N = 0 forward of the same call. Returns the
    launch counts of the served bf16 forwards, summed over the four
    configurations."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.inference import (InferenceEngine,
                                                                 create_flagship, pad_rois)
    from human_instance_segmentation_tpu_torch.ops import (cuda_head, cuda_mbconv,
                                                           cuda_roi_align, cuda_tail, quant)

    def engine(n, dtype, quantize, kernels=True, tail=True, scales=None):
        model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                                image_size=IMAGE_HW, mid_channels=128, seed=0,
                                pallas_roi_align=kernels, pallas_tail=tail,
                                encoder_fused_blocks=n)
        e = InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=True,
                            quantize=quantize, kernels=kernels)
        e.scales = dict(scales) if scales is not None else None
        return e

    counters = {"mbconv_sums": cuda_mbconv.mbconv_sums, "mbconv_apply": cuda_mbconv.mbconv_apply,
                "tail": cuda_tail.tail, "tail_q": cuda_tail.tail_q,
                "conv_ln_act": cuda_head.conv_ln_act, "conv_ln_act_s8": cuda_head.conv_ln_act_s8,
                "qconv": quant.qconv2d, "roi_align": cuda_roi_align.roi_align}
    requests = [make_request(rng, 32, 32), make_request(rng, 4, 3)]
    total = {k: 0 for k in counters}
    timed = {}
    for quantize in (None, "int8"):
        for n in (3, 6):
            mode = quantize or "bf16"
            served = engine(n, torch.bfloat16, quantize)
            if quantize:
                served.calibrate(*requests[1])
                for key in ("pretrained_unet/decoder4#x", "pretrained_unet/decoder4#mid",
                            "pretrained_unet#head"):
                    if key not in served.scales:
                        raise AssertionError(f"calibration recorded no {key}")
            qconvs = [m for m in served.model.modules() if isinstance(m, quant.QConv)]
            for f in counters.values():
                f.launches = 0
            outs = []
            for images, rois in requests:
                c0 = {k: f.launches for k, f in counters.items()}
                outs.append(served(images, rois))
                d = {k: f.launches - c0[k] for k, f in counters.items()}
                marked = sum(m.runs_int8 for m in qconvs)
                print(f"N={n} {mode} batch {images.shape[0]} x {rois.shape[0]} rois: launches "
                      f"{d}; QConvs marked int8 {marked} (one forward)")
                want = {"mbconv_sums": n, "mbconv_apply": n, "roi_align": 1}
                if quantize:
                    want.update({"tail_q": 1, "tail": 0, "conv_ln_act": 0, "conv_ln_act_s8": 5,
                                 "qconv": marked - 5 - 2})
                else:
                    want.update({"tail_q": 0, "tail": 1, "conv_ln_act": 5, "conv_ln_act_s8": 0,
                                 "qconv": 0})
                if d != want:
                    raise AssertionError(f"N={n} {mode}: expected launches {want}, got {d}")
            for k, f in counters.items():
                total[k] += f.launches

            scales = served.scales
            plain_bf16 = engine(n, torch.bfloat16, quantize, kernels=False, scales=scales)
            others = {"plain bf16": plain_bf16,
                      "served f32": engine(n, torch.float32, quantize, scales=scales),
                      "plain f32": engine(n, torch.float32, quantize, kernels=False,
                                          scales=scales)}
            if not quantize:
                others["no flags f32"] = engine(0, torch.float32, None, tail=False)
            for (images, rois), (inst, binary) in zip(requests, outs):
                b, nr = images.shape[0], rois.shape[0]
                if inst.shape != (nr, *MASK_HW, 1) or binary.shape != (b, *IMAGE_HW, 1):
                    raise AssertionError(f"bad output shapes {inst.shape}, {binary.shape}")
                if not (np.isfinite(inst).all() and np.isfinite(binary).all()):
                    raise AssertionError("non-finite outputs")
                if not set(np.unique(inst)) <= {0.0, 1.0}:
                    raise AssertionError("instance masks are not binary")
                o = {name: e(images, rois) for name, e in others.items()}
                tag = f"N={n} {mode} batch {b} x {nr} rois"
                bin_f32 = float(np.abs(o["served f32"][1] - o["plain f32"][1]).max())
                agree_f32 = _agreement(o["served f32"][0], o["plain f32"][0])
                print(f"{tag} f32 kernels vs kernels=False: binary max_abs_err {bin_f32:.3e} "
                      f"(tol 1e-2), instance agreement {agree_f32:.6f} (min {MIN_AGREE})")
                bin_bf16 = float(np.abs(binary - o["plain bf16"][1]).max())
                agree_k = _agreement(inst, o["plain f32"][0])
                agree_p = _agreement(o["plain bf16"][0], o["plain f32"][0])
                print(f"{tag} bf16 kernels vs kernels=False: binary max_abs_err {bin_bf16:.3e} "
                      f"(tol 1e-2), instance agreement "
                      f"{_agreement(inst, o['plain bf16'][0]):.6f}; vs f32 plain: kernels "
                      f"{agree_k:.6f}, plain bf16 {agree_p:.6f} (kernels >= plain - 0.002); fg "
                      f"share {inst.mean():.4f}")
                if not (bin_f32 <= 1e-2 and agree_f32 >= MIN_AGREE):
                    raise AssertionError(f"{tag}: the f32 slice disagrees with its plain path")
                if not (bin_bf16 <= 1e-2 and agree_k >= agree_p - 0.002):
                    raise AssertionError(f"{tag}: the bf16 slice is further from f32 than its "
                                         "plain path")
                if not quantize:
                    bin_ref = float(np.abs(o["served f32"][1] - o["no flags f32"][1]).max())
                    agree_ref = _agreement(o["served f32"][0], o["no flags f32"][0])
                    print(f"{tag} f32 vs encoder_fused_blocks=0, pallas_tail=False: binary "
                          f"max_abs_err {bin_ref:.3e} (tol 1e-4), instance agreement "
                          f"{agree_ref:.6f} (min {MIN_AGREE})")
                    if not (bin_ref <= 1e-4 and agree_ref >= MIN_AGREE):
                        raise AssertionError(f"{tag}: the flags changed the result")
            del others, plain_bf16, o
            timed[(mode, n)] = served
            torch.cuda.empty_cache()

    # ---- forward times beside N = 0 (pallas_tail=True) in the same call -------
    batch = 32
    images, rois = make_request(rng, batch, batch)
    images_t = torch.tensor(images, device="cuda", dtype=torch.bfloat16)
    rois_t = torch.tensor(pad_rois(rois, batch), device="cuda")
    timed[("bf16", 0)] = engine(0, torch.bfloat16, None)
    timed[("int8", 0)] = engine(0, torch.bfloat16, "int8")
    # the int8 forward without the s8 tail: its last decoder stage and the seg
    # head as the unfused modules (two qconv and a bf16 conv)
    timed[("int8 no tail", 0)] = engine(0, torch.bfloat16, "int8", tail=False)
    for (mode, n), e in timed.items():
        if mode.startswith("int8"):
            e.calibrate(images, rois)
    torch.cuda.empty_cache()
    order = sorted(timed, key=lambda k: (k[0], k[1]))
    times = {k: [] for k in order}
    for key in order + order[::-1]:
        times[key].append(median_ms(lambda: timed[key].forward(images_t, rois_t),
                                    reps=TIMING_REPS // 2))
    for key in order:
        med = statistics.median(times[key])
        print(f"forward batch {batch} x 1 roi, {key[0]}, fused head, "
              f"{'no tail' if 'no tail' in key[0] else 'pallas_tail'}, "
              f"encoder_fused_blocks={key[1]}: {med:.3f} ms/batch, {batch / med * 1e3:.1f} img/s "
              f"(per-round medians {times[key]}, {TIMING_REPS // 2} forwards each, CUDA events) "
              f"[{card}]")
    # the stage-1 encoder alone on the same batch, in the memory format the
    # forward gives it (the NHWC images viewed as NCHW): the unfused blocks
    # (cuDNN convs, BN, SiLU and squeeze-excite as separate ops) against N
    # fused ones
    x_enc = images_t.permute(0, 3, 1, 2)
    enc = {n: timed[("bf16", n)].model.pretrained_unet.encoder for n in (0, 3, 6)}
    enc_ms = {n: [] for n in enc}
    with torch.inference_mode():
        for n in (0, 3, 6, 6, 3, 0):
            enc_ms[n].append(median_ms(lambda: enc[n](x_enc), reps=TIMING_REPS // 2))
    print(f"B0 encoder alone, batch {batch} bf16: "
          + "; ".join(f"fused_blocks={n} {statistics.median(v):.3f} ms (rounds {v})"
                      for n, v in enc_ms.items()) + f" [{card}]")

    # where a forward's device time goes, with and without the two kernels
    for key in (("bf16", 0), ("bf16", 6), ("int8", 0), ("int8", 6), ("int8 no tail", 0)):
        busy, _, events = forward_profile(timed[key], images_t, rois_t)

        def part(*names):
            return sum(ev.self_device_time_total for ev in events
                       if any(nm in ev.key for nm in names)) / 3e3

        wall = statistics.median(times[key])
        print(f"profile of 3 forwards, {key[0]}, encoder_fused_blocks={key[1]}: device busy "
              f"{busy:.3f} ms per forward of {wall:.3f} ms wall ({100 * (1 - busy / wall):.1f}% "
              f"idle), {sum(ev.count for ev in events) // 3} kernels per forward; mbconv kernels "
              f"{part('mbconv_kernel', 'mbconv_bf16_kernel'):.3f} ms, tail_q kernel (int8 map and "
              f"float border) {part('tail_q_kernel'):.3f} ms, float tail kernel "
              f"{part('tail_kernel', 'tail_bf16_kernel'):.3f} ms, s8 conv kernels "
              f"{part('s8igemm'):.3f} ms, bf16 fused-unit conv (wgmma) "
              f"{part('conv_bf16_wgmma_kernel'):.3f} ms, LayerNorm passes "
              f"{part('ln_act_kernel'):.3f} ms [{card}]")
    return total


# ---------------------------------------------------------------------------
# Phase 14: training the flagship
# ---------------------------------------------------------------------------

# the deployed B0 configuration the JAX package trains (config.py:444-474):
# frozen stage 1, contour and distance branches, the boundary-aware loss;
# batch 8 x 8 ROIs, bf16 compute, AdamW with a cosine-and-warmup schedule,
# clip 5.0. Its image_size field is 640 x 640; the flagship's is 480 x 640.
TRAIN_CONFIG = ("rgb_hierarchical_unet_v2_fullimage_pretrained_peopleseg_r64x48m128x96_"
                "disttrans_contdet_baware_from_b0")
TRAIN_STEPS = 5
TRAIN_MODS = {"model": {"image_size": list(IMAGE_HW)}}
TRAIN_KERNELS = {"pallas_tail": True, "encoder_fused_blocks": 6}
# launches of each stage-1 kernel in one train step (one stage-1 forward)
TRAIN_PER_STEP = {"mbconv_sums": 6, "mbconv_apply": 6, "tail": 1}
# stage-1 logits of the kernel path against the same weights with both
# switches off, float32: the tail's own error (TOL_TAIL: 2e-5 + 1e-5 |x|)
# plus the six fused blocks' 2e-5 each (TOL_MBCONV) carried through the
# rest of stage 1 at a gain of about one (LeCun-scaled weights and BN keep
# activations at unit scale): atol 2e-5 + 6 * 2e-5, rtol 1e-5. The loss and
# the stage-2 gradients are held to twice what a stage-1 error of that size
# moves them on the plain path (the largest of a uniform shift by the
# tolerance and a random-sign one), since stage 2 is the same code on both
# paths and sees the two only through the stage-1 logits.
TOL_STAGE1_F32 = (1.4e-4, 1e-5)
TRAIN_PROFILE_STEPS = 3


# device time of a train step by kind of kernel: the first kind whose words
# appear in the kernel's name
TRAIN_KERNEL_KINDS = (
    ("fused stage-1 kernels", ("mbconv", "tail_kernel", "tail_bf16_kernel")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("convolutions and GEMMs", ("conv2d", "convolve", "gemm", "xmma", "cutlass", "cudnn", "dgrad",
                                "wgrad", "sm90_", "implicit", "nchwToNhwc", "nhwcToNchw")),
    ("reductions", ("reduce_kernel",)),
    ("copies and dtype casts", ("copy_kernel", "CopyKernel")),
    ("elementwise", ("elementwise",)),
)


def _kernel_kind(key: str) -> str:
    return next((k for k, words in TRAIN_KERNEL_KINDS if any(w in key for w in words)), "other")


def _kernel_label(key: str) -> str:
    """A kernel's name with what tells elementwise and reduction kernels
    apart (their functor or op) kept."""
    key = key.replace("void ", "").replace("at::native::", "")
    found = re.findall(r"(\w+(?:Functor|Ops|Op|_kernel_cuda|_impl|Backward\w*|kernel\w*))", key)
    head = re.match(r"[\w:]+", key)
    names = [head.group(0)] if head else []
    names += [f for f in dict.fromkeys(found) if f not in names][:3]
    return "/".join(names)[:110]


def train_counters() -> dict:
    from human_instance_segmentation_tpu_torch.ops import cuda_mbconv, cuda_tail

    return {"mbconv_sums": cuda_mbconv.mbconv_sums, "mbconv_apply": cuda_mbconv.mbconv_apply,
            "tail": cuda_tail.tail}


def train_batches(n: int, seed: int):
    from human_instance_segmentation_tpu_torch.config import ConfigManager
    from human_instance_segmentation_tpu_torch.training.loop import synthetic_batches

    cfg = ConfigManager.get_config(TRAIN_CONFIG)
    gen = synthetic_batches(cfg.training.batch_size, cfg.data.rois_per_image, IMAGE_HW, MASK_HW,
                            seed=seed)
    return [next(gen) for _ in range(n)]


def train_entry_point(card: str, rng) -> dict:
    """Phase 14 (a): ``run_training`` on the deployed B0 config at 480 x 640,
    synthetic, bf16, 5 steps, with the fused tail and the six fused encoder
    blocks. Gates: every step finite (``skipped == 0``), the launches of the
    run (5 train steps, the 2 validation batches and the end-of-run picture,
    one stage-1 forward each), the last checkpoint restoring into a fresh state to an equal
    state, and the trained model served through ``InferenceEngine(bf16,
    fused_head=True)`` passing the phase 4 gates against its own plain path.
    Returns the launch counts of the run."""
    import shutil

    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.config import (ConfigManager, _deep_merge,
                                                              model_from_config)
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine
    from human_instance_segmentation_tpu_torch.training.checkpoint import restore_checkpoint
    from human_instance_segmentation_tpu_torch.training.loop import run_training
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      constant_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    out = ROOT / "build" / "phase14_run"
    shutil.rmtree(out, ignore_errors=True)
    counters = train_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics, state = run_training(TRAIN_CONFIG, steps=TRAIN_STEPS, synthetic=True,
                                  output_dir=str(out), config_modifications=TRAIN_MODS,
                                  model_overrides=TRAIN_KERNELS, return_state=True)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    forwards = TRAIN_STEPS + 2 + 1  # + the two validation batches and the end-of-run picture
    want = {k: n * forwards for k, n in TRAIN_PER_STEP.items()}
    rows = [json.loads(line) for f in sorted((out / "logs").glob("*.jsonl"))
            for line in f.read_text().splitlines()]
    losses = [r["total_loss"] for r in rows if "total_loss" in r]
    print(f"run_training {TRAIN_CONFIG} {IMAGE_HW[0]}x{IMAGE_HW[1]}, {TRAIN_STEPS} steps, bf16, "
          f"synthetic: "
          f"{wall:.1f} s (model build, steps, validation, checkpoints); logged losses {losses}, "
          f"skipped {state.skipped}, val mIoU {metrics['val_miou']:.4f}; launches {launches} "
          f"(expected {want}: {TRAIN_PER_STEP} per stage-1 forward x {forwards}) [{card}]")
    if state.skipped or state.step != TRAIN_STEPS or not losses or not np.isfinite(losses).all():
        raise AssertionError(f"training went wrong: step {state.step}, skipped {state.skipped}, "
                             f"losses {losses}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")

    # the checkpoint restores to an equal state
    cfg = _deep_merge(ConfigManager.get_config(TRAIN_CONFIG), TRAIN_MODS)
    fresh = TrainState.create(model_from_config(cfg, seed=1, **TRAIN_KERNELS),
                              build_optimizer(constant_schedule(0.0)), seed=2)
    fresh, step = restore_checkpoint(str(out / "checkpoints"), fresh)
    a, b = state.model.state_dict(), fresh.model.state_dict()
    same = (step == TRAIN_STEPS and fresh.step == state.step and fresh.skipped == state.skipped
            and a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
            and fresh.optimizer.count == state.optimizer.count
            and all(torch.equal(state.optimizer.mu[k], fresh.optimizer.mu[k])
                    and torch.equal(state.optimizer.nu[k], fresh.optimizer.nu[k])
                    for k in state.optimizer.mu)
            and all(torch.equal(v, fresh.loss_state.state_dict()[k])
                    for k, v in state.loss_state.state_dict().items())
            and torch.equal(state.generator.get_state(), fresh.generator.get_state()))
    print(f"checkpoint of step {step} restored into a fresh state: equal {same}")
    if not same:
        raise AssertionError("the restored state differs from the trained one")
    del fresh, a, b

    # the trained model served, held to its own plain path (phase 4's gates)
    trained = state.model

    def engine(dtype, kernels: bool):
        e = InferenceEngine(trained, dilation_pixels=1, dtype=dtype, fused_head=kernels,
                            kernels=kernels)
        e.model.pallas_roi_align = kernels
        return e

    engines = {"served bf16": engine(torch.bfloat16, True),
               "plain bf16": engine(torch.bfloat16, False),
               "served f32": engine(torch.float32, True),
               "plain f32": engine(torch.float32, False)}
    for images, rois in (make_request(rng, 4, 3), make_request(rng, 8, 8)):
        o = {name: e(images, rois) for name, e in engines.items()}
        tag = f"trained model batch {images.shape[0]} x {rois.shape[0]} rois"
        inst, binary = o["served bf16"]
        if inst.shape != (rois.shape[0], *MASK_HW, 1) or binary.shape != (images.shape[0],
                                                                           *IMAGE_HW, 1):
            raise AssertionError(f"bad output shapes {inst.shape}, {binary.shape}")
        if not all(np.isfinite(x).all() for pair in o.values() for x in pair):
            raise AssertionError("non-finite outputs")
        bin_f32 = float(np.abs(o["served f32"][1] - o["plain f32"][1]).max())
        agree_f32 = _agreement(o["served f32"][0], o["plain f32"][0])
        bin_bf16 = float(np.abs(binary - o["plain bf16"][1]).max())
        agree_k = _agreement(inst, o["plain f32"][0])
        agree_p = _agreement(o["plain bf16"][0], o["plain f32"][0])
        print(f"{tag}: f32 served vs plain binary max_abs_err {bin_f32:.3e} (tol 1e-2), instance "
              f"agreement {agree_f32:.6f} (min {MIN_AGREE}); bf16 served vs plain binary "
              f"{bin_bf16:.3e} (tol 1e-2), vs f32 plain: served {agree_k:.6f}, plain bf16 "
              f"{agree_p:.6f} (served >= plain - 0.002); fg share {inst.mean():.4f}")
        if not (bin_f32 <= 1e-2 and agree_f32 >= MIN_AGREE):
            raise AssertionError(f"{tag}: f32 served path disagrees with its plain path")
        if not (bin_bf16 <= 1e-2 and agree_k >= agree_p - 0.002):
            raise AssertionError(f"{tag}: bf16 served path is further from f32 than its plain path")
    del engines, state, trained
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _train_models():
    """The flagship at mid 256 with the two stage-1 kernels, and the same
    weights with both switches off."""
    import torch

    from human_instance_segmentation_tpu_torch.inference import create_flagship

    def build(kernels: bool):
        return create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                               image_size=IMAGE_HW, mid_channels=256, seed=0,
                               pallas_roi_align=False, pallas_tail=kernels,
                               encoder_fused_blocks=6 if kernels else 0)

    mk, mp = build(True), build(False)
    a, b = mk.state_dict(), mp.state_dict()
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("the two models do not hold the same weights")
    return mk, mp


def _loss_and_grads(model, loss_cfg, batch, dtype: str, delta=None):
    """One evaluation of the train step's loss and its stage-2 gradients (the
    dropout masks drawn from a generator seeded alike on both paths), and the
    stage-1 logits it saw, as ``(B, H, W)``; ``delta(x1)`` is added to the
    stage-1 logits when given."""
    import torch

    from human_instance_segmentation_tpu_torch.losses.hierarchical import HierarchicalLossState
    from human_instance_segmentation_tpu_torch.training import steps

    seen = {}

    def hook(module, inputs, out):
        form, x1 = out
        if delta is not None:
            x1 = x1 + delta(x1).to(x1.dtype)
        seen["x1"] = (x1 if form == "dense" else x1[:, 0]).float()
        return form, x1

    handle = model.pretrained_unet.register_forward_hook(hook)
    try:
        model.train()
        loss, _ = steps.make_loss_fn(model, loss_cfg, dtype)(
            HierarchicalLossState.create("cuda"), torch.Generator(device="cuda").manual_seed(5),
            steps.batch_to(batch, "cuda"))
        names = [n for n, p in model.named_parameters() if not n.startswith(
            ("pretrained_unet.", "unet_wrapper."))]
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    finally:
        handle.remove()
    flat = torch.cat([(g if g is not None else torch.zeros_like(params[n])).flatten()
                      for n, g in zip(names, grads)])
    return float(loss.detach()), flat.detach(), seen["x1"]


def train_step_kernels(card: str, rng) -> None:
    """Phase 14 (b): ``make_train_step`` on the flagship at mid 256 with
    ``pallas_tail=True, encoder_fused_blocks=6`` against the same weights and
    batch with both switches off, TF32 off. Launches per
    step asserted (6 ``mbconv_sums``, 6 ``mbconv_apply``, 1 ``tail``); in
    float32 the stage-1 logits within ``TOL_STAGE1_F32`` and the loss and
    stage-2 gradients within twice the effect of a stage-1 error at that
    tolerance; in bf16 the kernel path no further from the float32 plain
    path than twice the bf16 plain path's own distance from it (plus the
    float32 bound). After an optimizer step that decays the frozen weights
    by 10% the kernels still equal their plain versions: stage 1 in float32
    against the switches-off model with the decayed weights, and in bf16
    every kernel call against its plain version on that call's operands."""
    import torch

    from human_instance_segmentation_tpu_torch.config import (ConfigManager,
                                                              loss_config_from_experiment)
    from human_instance_segmentation_tpu_torch.ops import cuda_mbconv, cuda_tail
    from human_instance_segmentation_tpu_torch.training import steps
    from human_instance_segmentation_tpu_torch.training.optim import Transform, constant_schedule
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    loss_cfg = loss_config_from_experiment(ConfigManager.get_config(TRAIN_CONFIG))
    batch = train_batches(1, seed=3)[0]
    mk, mp = _train_models()
    counters = train_counters()
    for dtype in ("float32", "bfloat16"):
        state = TrainState.create(mk, Transform("adamw", constant_schedule(0.0), 1e-4, 5.0))
        c0 = {k: f.launches for k, f in counters.items()}
        state, metrics = steps.make_train_step(mk, loss_cfg, dtype)(state, batch)
        d = {k: f.launches - c0[k] for k, f in counters.items()}
        print(f"train step {dtype}, mid 256, batch 8 x 8 rois: launches {d} (expected "
              f"{TRAIN_PER_STEP}), loss {float(metrics['total_loss']):.6f}")
        if d != TRAIN_PER_STEP or state.skipped:
            raise AssertionError(f"train step {dtype}: launches {d}, skipped {state.skipped}")

    res = {(path, dtype): _loss_and_grads(m, loss_cfg, batch, dtype)
           for path, m in (("kernels", mk), ("plain", mp)) for dtype in ("float32", "bfloat16")}
    lk, gk, xk = res[("kernels", "float32")]
    lp, gp, xp = res[("plain", "float32")]
    atol, rtol = TOL_STAGE1_F32
    x_err = (xk - xp).abs()
    x_ok = bool((x_err <= atol + rtol * xp.abs()).all())
    gen = torch.Generator(device="cuda").manual_seed(11)

    def shift(x):
        return atol + rtol * x.abs()

    def random_sign(x):
        s = torch.randint(0, 2, x.shape, generator=gen, device=x.device) * 2 - 1
        return s * (atol + rtol * x.abs())

    effects = [_loss_and_grads(mp, loss_cfg, batch, "float32", delta) for delta in
               (shift, random_sign)]
    l_bound = 2 * max(abs(le - lp) for le, _, _ in effects)
    g_bound = 2 * max(float((ge - gp).norm()) for _, ge, _ in effects)
    l_err, g_err = abs(lk - lp), float((gk - gp).norm())
    print(f"train step float32, kernels vs switches off: stage-1 logits max_abs_err "
          f"{float(x_err.max()):.3e} (tol {atol} + {rtol} |x|, max |x| {float(xp.abs().max()):.2f}); "
          f"loss {lk:.7f} vs {lp:.7f}, |diff| {l_err:.3e} = {l_err / abs(lp):.2e} relative "
          f"(bound {l_bound:.3e} = {l_bound / abs(lp):.2e}); stage-2 gradients |diff| {g_err:.3e} "
          f"of |g| {float(gp.norm()):.3e} (bound {g_bound:.3e})")
    if not (x_ok and l_err <= l_bound and g_err <= g_bound):
        raise AssertionError("float32 train step: the kernel path is outside its bound")
    lkb, gkb, _ = res[("kernels", "bfloat16")]
    lpb, gpb, _ = res[("plain", "bfloat16")]
    lb_bound = 2 * abs(lpb - lp) + l_bound
    gb_bound = 2 * float((gpb - gp).norm()) + g_bound
    lb_err, gb_err = abs(lkb - lp), float((gkb - gp).norm())
    print(f"train step bfloat16 vs the float32 plain path: kernels loss {lkb:.6f}, |diff| "
          f"{lb_err:.3e} (bound {lb_bound:.3e}: twice the bf16 plain path's {abs(lpb - lp):.3e} "
          f"plus the float32 bound); stage-2 gradients |diff| {gb_err:.3e} (bound {gb_bound:.3e}: "
          f"twice the bf16 plain path's {float((gpb - gp).norm()):.3e} plus the float32 bound)")
    if not (lb_err <= lb_bound and gb_err <= gb_bound):
        raise AssertionError("bf16 train step: the kernel path is outside its bound")
    del res, effects

    # an optimizer step that decays every frozen weight by 10% (lr 0.1, wd 1)
    w = mk.pretrained_unet.encoder.stage1_block0.project_conv.weight
    before = w.detach().clone()
    state = TrainState.create(mk, Transform("adamw", constant_schedule(0.1), 1.0, 5.0))
    steps.make_train_step(mk, loss_cfg, "bfloat16")(state, batch)
    ratio = float((w.detach() / before).mean())
    mp.load_state_dict(mk.state_dict())
    images = torch.tensor(batch["images"], device="cuda")
    x_err = (mk.stage1(images) - mp.stage1(images)).abs()
    ref = mp.stage1(images).abs()
    ok = bool((x_err <= atol + rtol * ref).all())
    print(f"after a step with decay (frozen weights x {ratio:.4f}): float32 stage 1 kernels vs the "
          f"switches-off model with the same weights, max_abs_err {float(x_err.max()):.3e}")
    if not (abs(ratio - 0.9) < 1e-3 and ok):
        raise AssertionError("after the decay the kernels disagree with the decayed weights")

    real_mb, real_tail = cuda_mbconv.fused_mbconv, cuda_tail.tail
    errs = {"fused_mbconv": [], "tail": []}

    def spy_mbconv(x, *ops, **kw):
        y = real_mb(x, *ops, **kw)
        yp = cuda_mbconv.fused_mbconv_plain(x, *ops, **kw)
        atol_, rtol_ = TOL_MBCONV["bfloat16"]
        errs["fused_mbconv"].append(bool(((y.float() - yp.float()).abs()
                                          <= atol_ + rtol_ * yp.float().abs()).all()))
        return y

    def spy_tail(x, *ops, packed=None):
        cuda_tail.tail = real_tail  # the wrapper counts its launches on its own name
        try:
            y = real_tail(x, *ops, packed=packed)
        finally:
            cuda_tail.tail = spy_tail
        yp = cuda_tail.tail_plain(x, *ops)
        atol_, rtol_ = TOL_TAIL["bfloat16"]
        errs["tail"].append(bool(((y.float() - yp.float()).abs()
                                  <= atol_ + rtol_ * yp.float().abs()).all()))
        return y

    cuda_mbconv.fused_mbconv, cuda_tail.tail = spy_mbconv, spy_tail
    try:
        with torch.no_grad():
            steps.forward(mk, images, steps.rois_from_boxes(
                torch.tensor(batch["boxes"], device="cuda")), "bfloat16")
    finally:
        cuda_mbconv.fused_mbconv, cuda_tail.tail = real_mb, real_tail
    print(f"after the decay, bf16 train forward: each kernel call against its plain version on "
          f"its operands: {errs}")
    if [len(errs["fused_mbconv"]), len(errs["tail"])] != [6, 1] or not all(
            all(v) for v in errs.values()):
        raise AssertionError(f"a kernel call disagrees with its plain version: {errs}")
    del mk, mp, state
    torch.cuda.empty_cache()


def time_train_steps(card: str) -> None:
    """Phase 14 (c): ms per bf16 train step and images per second (median of
    10 steps after 3 of warmup, the two paths in turns, batches already on
    the card), kernels against plain stage 1; device busy time and idle
    share over 3 steps (``torch.profiler``) with the 12 kernels that take
    the most device time; peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from human_instance_segmentation_tpu_torch.config import (ConfigManager,
                                                              loss_config_from_experiment)
    from human_instance_segmentation_tpu_torch.training import steps
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      build_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    cfg = ConfigManager.get_config(TRAIN_CONFIG)
    t = cfg.training
    loss_cfg = loss_config_from_experiment(cfg)
    batches = [steps.batch_to(b, "cuda") for b in train_batches(4, seed=7)]
    images_per_step = batches[0]["images"].shape[0]
    models = dict(zip(("kernels", "plain"), _train_models()))
    runs = {}
    for name, m in models.items():
        tx = build_optimizer(build_schedule(t.learning_rate, t.num_epochs, 100, t.scheduler,
                                            t.min_lr, t.warmup_epochs),
                             t.optimizer, t.weight_decay, t.gradient_clip)
        runs[name] = [TrainState.create(m, tx), steps.make_train_step(m, loss_cfg,
                                                                      t.compute_dtype)]
    torch.cuda.synchronize()
    peak = {}
    for name, run in runs.items():
        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            run[0], _ = run[1](run[0], batches[i % len(batches)])
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    times = {name: [] for name in runs}
    for i in range(10):
        for name in (("kernels", "plain") if i % 2 == 0 else ("plain", "kernels")):
            run = runs[name]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run[0], _ = run[1](run[0], batches[i % len(batches)])
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    for name, run in runs.items():
        med = statistics.median(times[name])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(TRAIN_PROFILE_STEPS):
                run[0], _ = run[1](run[0], batches[i % len(batches)])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in events) / (TRAIN_PROFILE_STEPS * 1e3)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        parts = {}
        for e in events:
            kind = _kernel_kind(e.key)
            parts[kind] = parts.get(kind, 0.0) + e.self_device_time_total / (
                TRAIN_PROFILE_STEPS * 1e3)
        print(f"train step bf16, B0 480x640, batch {images_per_step} x 8 rois, mid 256, "
              f"{name} stage 1: {med:.3f} ms/step, {images_per_step / med * 1e3:.1f} img/s "
              f"(median of 10 steps after 3 of warmup, CUDA events; all {times[name]}); device "
              f"busy {busy:.3f} ms per step ({100 * (1 - busy / med):.1f}% idle), "
              f"{sum(e.count for e in events) // TRAIN_PROFILE_STEPS} kernels per step; peak "
              f"memory {peak[name]:.2f} GiB (max_memory_allocated) [{card}]")
        print(f"  device ms per step by kind ({name}): " + "; ".join(
            f"{k} {v:.3f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
        print(f"  12 largest kernels by device time per step ({name}): " + "; ".join(
            f"{_kernel_label(e.key)} [{_kernel_kind(e.key)}] "
            f"{e.self_device_time_total / (TRAIN_PROFILE_STEPS * 1e3):.3f} ms "
            f"x{e.count // TRAIN_PROFILE_STEPS}" for e in top))
        if run[0].skipped:
            raise AssertionError(f"{name}: {run[0].skipped} timed steps were skipped")
    del runs, models
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 15: the pure-RGB and ROI-pretrained families, the flagship with the
# refinement flags and an unfrozen stage 1
# ---------------------------------------------------------------------------

# the registry's pure-RGB config at its published sizes (JAX config.py:338-345):
# 640 x 640 images, 64 x 64 ROIs and masks, head mid 256, base 96, depth 3,
# the attention module; its group- and batch-norm ablations (:347-376)
RGB_CONFIG = "rgb_hierarchical_unet_v2_attention_r64m64"
RGB_ABLATIONS = (
    "rgb_hierarchical_unet_v2_attention_r64m64_refined_contour_activecontourloss_distance_"
    "groupnorm",
    "rgb_hierarchical_unet_v2_attention_r64x48m64x48_refined_batchnorm",
)
# the ROI-pretrained config (:379-384): B3 stage 1 on every 64 x 48 crop, not
# frozen, its BatchNorms trained; 640 x 640, batch 8 x 8 ROIs, bf16
ROI_CONFIG = "rgb_hierarchical_unet_v2_pretrained_peopleseg_r64x48m64x48"
# the deployed B0 flagship with the attention module, the boundary
# refinement and stage 1 unfrozen, at the flagship's 480 x 640
A3_MODS = {"model": {"image_size": list(IMAGE_HW), "use_attention_module": True,
                     "use_boundary_refinement": True, "freeze_pretrained_weights": False}}
PHASE15_STEPS = 3
# conv_ln_act launches in one forward of the EnhancedUNet bottleneck (bott_res0,
# bott_res1: two units each; bott_cna: one) at 16 x 16 (or 16 x 12) x 384
BOTTLENECK_UNITS = 5


def _gates(tag: str, o: dict) -> None:
    """Phase 4's gates on the four engines' outputs ``{name: (instance,
    binary or None, float32 logits)}``: float32 served vs plain logits
    max-abs <= 1e-2 (and binary where there is one) and instance agreement
    >= MIN_AGREE; bf16 served no further from the float32 plain path than
    the bf16 plain path is, in instance agreement less 0.002 (C4) and in
    logits at most twice as far plus 1e-2 (phase 14's bf16 rule)."""
    import numpy as np

    for name, (inst, binary, logits) in o.items():
        if not (np.isfinite(inst).all() and np.isfinite(logits).all()
                and (binary is None or np.isfinite(binary).all())):
            raise AssertionError(f"{tag} {name}: non-finite outputs")
        if not set(np.unique(inst)) <= {0.0, 1.0}:
            raise AssertionError(f"{tag} {name}: instance masks are not binary")
    logit_f32 = float(np.abs(o["served f32"][2] - o["plain f32"][2]).max())
    logit_k = float(np.abs(o["served bf16"][2] - o["plain f32"][2]).max())
    logit_p = float(np.abs(o["plain bf16"][2] - o["plain f32"][2]).max())
    agree_f32 = _agreement(o["served f32"][0], o["plain f32"][0])
    agree_k = _agreement(o["served bf16"][0], o["plain f32"][0])
    agree_p = _agreement(o["plain bf16"][0], o["plain f32"][0])
    bins = ""
    ok_bin = True
    if o["plain f32"][1] is not None:
        bin_f32 = float(np.abs(o["served f32"][1] - o["plain f32"][1]).max())
        bin_bf16 = float(np.abs(o["served bf16"][1] - o["plain bf16"][1]).max())
        bins = f"binary max_abs_err f32 {bin_f32:.3e}, bf16 {bin_bf16:.3e} (tol 1e-2); "
        ok_bin = bin_f32 <= 1e-2 and bin_bf16 <= 1e-2
    print(f"{tag}: f32 served vs plain logits max_abs_err {logit_f32:.3e} (tol 1e-2), instance "
          f"agreement {agree_f32:.6f} (min {MIN_AGREE}); {bins}bf16 vs f32 plain: served "
          f"{agree_k:.6f}, plain bf16 {agree_p:.6f} (served >= plain - 0.002), logits "
          f"max_abs_err served {logit_k:.3e}, plain bf16 {logit_p:.3e} (served <= 2 x plain + "
          f"1e-2); fg share {o['served bf16'][0].mean():.4f}")
    if not (ok_bin and logit_f32 <= 1e-2 and agree_f32 >= MIN_AGREE):
        raise AssertionError(f"{tag}: the float32 served path disagrees with its plain path")
    if not (agree_k >= agree_p - 0.002 and logit_k <= 2 * logit_p + 1e-2):
        raise AssertionError(f"{tag}: bf16 served path is further from f32 than its plain path")


def _serve(engine, images, rois):
    """(instance, binary or None, float32 logits) of one request, numpy."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.inference import pad_rois, roi_bucket

    n = rois.shape[0]
    bucket = roi_bucket(n, max_bucket=engine.max_bucket)
    images_t = torch.as_tensor(images).to(engine.device, engine.dtype)
    rois_t = torch.as_tensor(pad_rois(np.asarray(rois, np.float32), bucket)).to(engine.device)
    inst, binary, logits = engine.forward(images_t, rois_t)
    return (inst[:n].float().cpu().numpy(),
            None if binary is None else binary.float().cpu().numpy(),
            logits[:n].float().cpu().numpy())


def serve_rgb_family(card: str, rng) -> dict:
    """Phase 15a: the pure-RGB config served through ``InferenceEngine`` at
    its sizes, batch 8 x 8 ROIs, with the fused unit on (``conv_ln_act``
    at the bottleneck, 5 launches a forward) against the same weights with
    it off, under phase 4's gates in float32 and bf16; ms per forward; the
    group- and batch-norm ablations one eval forward each. Returns the
    launch counts."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.config import (ConfigManager, _as_hw,
                                                              model_from_config)
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine, pad_rois
    from human_instance_segmentation_tpu_torch.ops import cuda_head

    cfg = ConfigManager.get_config(RGB_CONFIG)
    model = model_from_config(cfg, seed=0)
    hw = _as_hw(cfg.model.image_size)

    def engine(dtype, kernels: bool):
        # at these random weights every pixel is class 1 (the instance gates
        # hold trivially), so the logits gates carry the comparison
        return InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=kernels,
                               kernels=kernels)

    engines = {"served bf16": engine(torch.bfloat16, True),
               "plain bf16": engine(torch.bfloat16, False),
               "served f32": engine(torch.float32, True),
               "plain f32": engine(torch.float32, False)}
    cuda_head.conv_ln_act.launches = 0
    for images, rois in (make_request(rng, 8, 8, hw), make_request(rng, 8, 64, hw)):
        tag = f"{RGB_CONFIG} batch {images.shape[0]} x {rois.shape[0]} rois"
        o = {}
        for name, e in engines.items():
            c0 = cuda_head.conv_ln_act.launches
            o[name] = _serve(e, images, rois)
            dc = cuda_head.conv_ln_act.launches - c0
            want = BOTTLENECK_UNITS if name.startswith("served") else 0
            if dc != want:
                raise AssertionError(f"{tag} {name}: {dc} conv_ln_act launches, expected {want}")
        print(f"{tag}: {BOTTLENECK_UNITS} conv_ln_act launches per served forward (f32 and bf16)")
        if o["served bf16"][0].shape != (rois.shape[0], *_as_hw(cfg.model.mask_size), 1):
            raise AssertionError(f"bad output shape {o['served bf16'][0].shape}")
        _gates(tag, o)
    launches = {"conv_ln_act": cuda_head.conv_ln_act.launches}

    images, rois = make_request(rng, 8, 64, hw)
    images_t = torch.as_tensor(images).to("cuda", torch.bfloat16)
    rois_t = torch.as_tensor(pad_rois(rois, 64)).to("cuda")
    times = {"served": [], "plain": []}
    for name in ("served", "plain", "plain", "served"):
        e = engines[f"{name} bf16"]
        times[name].append(median_ms(lambda: e.forward(images_t, rois_t), reps=TIMING_REPS // 2))
    for name, ms in times.items():
        med = statistics.median(ms)
        print(f"{RGB_CONFIG} forward, bf16, batch 8 x 64 rois (8 a image), fused unit "
              f"{'on' if name == 'served' else 'off'}: {med:.3f} ms per forward "
              f"(median of per-round medians {ms}, {TIMING_REPS // 2} forwards each, CUDA "
              f"events) [{card}]")
    del engines, model
    torch.cuda.empty_cache()

    for name in RGB_ABLATIONS:
        cfg = ConfigManager.get_config(name)
        e = InferenceEngine(model_from_config(cfg, seed=1), dilation_pixels=1,
                            dtype=torch.bfloat16, fused_head=True)
        images, rois = make_request(rng, 8, 64, _as_hw(cfg.model.image_size))
        inst, binary, logits = _serve(e, images, rois)
        mask = _as_hw(cfg.model.mask_size)
        ok = (inst.shape == (64, *mask, 1) and binary is None
              and logits.shape == (64, *mask, 3) and np.isfinite(logits).all())
        print(f"{name} ({cfg.model.normalization_type}): one eval forward, batch 8 x 64 rois, "
              f"bf16: instance {inst.shape}, logits {logits.shape}, finite and shaped {ok}, "
              f"fg share {inst.mean():.4f}")
        if not ok:
            raise AssertionError(f"{name}: bad eval forward")
        del e
    torch.cuda.empty_cache()
    return launches


def _stage1_stats(model) -> dict:
    from human_instance_segmentation_tpu_torch.ops.norms import running_stat_modules

    mods = running_stat_modules(model.pretrained_unet)
    return {f"{n}.{b}": getattr(m, b).detach().clone()
            for n, m in model.pretrained_unet.named_modules() if m in mods
            for b in ("running_mean", "running_var")}


def _time_steps(model, cfg, batches, steps: int = 5, warmup: int = 2):
    """ms per train step (CUDA events, median of ``steps`` after ``warmup``)
    of ``model`` in the config's compute dtype, batches on the card."""
    import torch

    from human_instance_segmentation_tpu_torch.config import loss_config_from_experiment
    from human_instance_segmentation_tpu_torch.training import steps as tsteps
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      build_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    t = cfg.training
    tx = build_optimizer(build_schedule(t.learning_rate, t.num_epochs, 100, t.scheduler,
                                        t.min_lr, t.warmup_epochs),
                         t.optimizer, t.weight_decay, t.gradient_clip)
    state = TrainState.create(model, tx)
    step = tsteps.make_train_step(model, loss_config_from_experiment(cfg), t.compute_dtype)
    times = []
    for i in range(warmup + steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, batches[i % len(batches)])
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    if state.skipped:
        raise AssertionError(f"{state.skipped} timed steps were skipped")
    return statistics.median(times), times, state


def train_roi_family(card: str, rng) -> None:
    """Phase 15b: ``run_training`` on the ROI-pretrained config (B3 stage 1
    unfrozen, 640 x 640, batch 8 x 8 ROIs, bf16), 3 steps, synthetic: every
    step finite, stage 1's BN running statistics moved, the checkpoint
    restored equal; then ms per step. The family has no fused stage-1 route
    (nor has the JAX one), so the train-mode gate of the fused kernels is
    held in 15c, on a model built with them."""
    import shutil

    import torch

    from human_instance_segmentation_tpu_torch.config import (ConfigManager, _as_hw,
                                                              model_from_config)
    from human_instance_segmentation_tpu_torch.training import steps as tsteps
    from human_instance_segmentation_tpu_torch.training.checkpoint import restore_checkpoint
    from human_instance_segmentation_tpu_torch.training.loop import (run_training,
                                                                    synthetic_batches)
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      constant_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    cfg = ConfigManager.get_config(ROI_CONFIG)
    out = ROOT / "build" / "phase15b_run"
    shutil.rmtree(out, ignore_errors=True)
    start_stats = _stage1_stats(model_from_config(cfg, seed=0))
    t0 = time.perf_counter()
    metrics, state = run_training(ROI_CONFIG, steps=PHASE15_STEPS, synthetic=True,
                                  output_dir=str(out), return_state=True)
    wall = time.perf_counter() - t0
    moved = _stage1_stats(state.model)
    n_moved = sum(not torch.equal(v, start_stats[k]) for k, v in moved.items())
    print(f"run_training {ROI_CONFIG}, {PHASE15_STEPS} steps, bf16, 640x640, batch "
          f"{cfg.training.batch_size} x {cfg.data.rois_per_image} rois, stage 1 "
          f"{cfg.model.encoder_name} unfrozen: {wall:.1f} s; loss {metrics['total_loss']:.4f}, "
          f"skipped {state.skipped}; stage-1 running statistics moved: {n_moved} of "
          f"{len(moved)} [{card}]")
    if state.skipped or state.step != PHASE15_STEPS:
        raise AssertionError(f"training went wrong: step {state.step}, skipped {state.skipped}")
    if n_moved != len(moved) or not moved:
        raise AssertionError("stage 1's running statistics did not all move")
    fresh = TrainState.create(model_from_config(cfg, seed=1),
                              build_optimizer(constant_schedule(0.0)), seed=2)
    fresh, step = restore_checkpoint(str(out / "checkpoints"), fresh)
    a, b = state.model.state_dict(), fresh.model.state_dict()
    same = (step == PHASE15_STEPS and a.keys() == b.keys()
            and all(torch.equal(a[k], b[k]) for k in a)
            and all(torch.equal(state.optimizer.mu[k], fresh.optimizer.mu[k])
                    for k in state.optimizer.mu))
    print(f"checkpoint of step {step} restored into a fresh state: equal {same}")
    if not same:
        raise AssertionError("the restored state differs from the trained one")
    del fresh, a, b, state
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    gen = synthetic_batches(cfg.training.batch_size, cfg.data.rois_per_image,
                            _as_hw(cfg.model.image_size), _as_hw(cfg.model.mask_size), seed=11)
    batches = [tsteps.batch_to(next(gen), "cuda") for _ in range(3)]
    med, times, _ = _time_steps(model_from_config(cfg, seed=0), cfg, batches)
    n = cfg.training.batch_size
    print(f"train step {ROI_CONFIG}, bf16, batch {n} x {cfg.data.rois_per_image} rois: "
          f"{med:.3f} ms/step, {n / med * 1e3:.1f} img/s (median of {len(times)} steps after 2 "
          f"of warmup, CUDA events; all {times}) [{card}]")
    torch.cuda.empty_cache()


def train_and_serve_a3_flagship(card: str, rng) -> dict:
    """Phase 15c: the deployed B0 flagship with the attention module, the
    boundary refinement and stage 1 unfrozen, built with ``pallas_tail`` and
    ``encoder_fused_blocks=6``: 3 bf16 train steps with no stage-1 kernel
    launched and stage 1's statistics moved; the trained model's own
    stage 1, served through its kept fused caches in float32, against a
    model without the kernels holding the same weights (the caches must
    follow the trained statistics); then served through
    ``InferenceEngine(bf16, fused_head=True)`` against its plain path under
    phase 4's gates, with launch counts per forward; ms per step. Returns
    the serving launch counts."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.config import (ConfigManager, _deep_merge,
                                                              loss_config_from_experiment,
                                                              model_from_config)
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine
    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align
    from human_instance_segmentation_tpu_torch.training import steps as tsteps
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      build_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    cfg = _deep_merge(ConfigManager.get_config(TRAIN_CONFIG), A3_MODS)
    model = model_from_config(cfg, seed=0, **TRAIN_KERNELS)
    images = torch.as_tensor(make_request(rng, 4, 4)[0], device="cuda")
    with torch.no_grad():
        model.eval().stage1(images)  # the fused caches fold the initial statistics
    before = _stage1_stats(model)
    batches = [tsteps.batch_to(b, "cuda") for b in train_batches(3, seed=13)]
    t = cfg.training
    tx = build_optimizer(build_schedule(t.learning_rate, t.num_epochs, 100, t.scheduler,
                                        t.min_lr, t.warmup_epochs),
                         t.optimizer, t.weight_decay, t.gradient_clip)
    state = TrainState.create(model, tx)
    step = tsteps.make_train_step(model, loss_config_from_experiment(cfg), t.compute_dtype)
    counters = train_counters()
    for f in counters.values():
        f.launches = 0
    losses = []
    for b in batches[:PHASE15_STEPS]:
        state, m = step(state, b)
        losses.append(float(m["total_loss"]))
    launches = {k: f.launches for k, f in counters.items()}
    moved = _stage1_stats(model)
    n_moved = sum(not torch.equal(v, before[k]) for k, v in moved.items())
    print(f"flagship B0 {IMAGE_HW[0]}x{IMAGE_HW[1]} + attention module + boundary refinement, "
          f"stage 1 unfrozen, {PHASE15_STEPS} bf16 steps, batch 8 x 8 rois: losses {losses}, "
          f"skipped {state.skipped}; stage-1 statistics moved {n_moved} of {len(moved)}; fused "
          f"stage-1 launches inside the steps {launches} [{card}]")
    if state.skipped or not np.isfinite(losses).all():
        raise AssertionError(f"training went wrong: skipped {state.skipped}, losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"a fused stage-1 kernel ran in a training step: {launches}")
    if n_moved != len(moved):
        raise AssertionError("stage 1's running statistics did not all move")

    plain = model_from_config(cfg, seed=5)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        for f in counters.values():
            f.launches = 0
        got = model.eval().stage1(images)
        stage1_launches = {k: f.launches for k, f in counters.items()}
        err = float((got - plain.eval().stage1(images)).abs().max())
    atol, rtol = TOL_STAGE1_F32
    print(f"trained model's stage 1 through its kept caches (launches {stage1_launches}) vs a "
          f"model without the kernels on the same weights, float32: max_abs_err {err:.3e} "
          f"(tol {atol} + {rtol} |x|)")
    if stage1_launches != {k: n for k, n in TRAIN_PER_STEP.items()} or not (
            err <= atol + rtol * float(got.abs().max())):
        raise AssertionError("the fused stage-1 caches did not follow the trained weights")
    del plain, state, step

    def engine(dtype, kernels: bool):
        e = InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=kernels,
                            kernels=kernels)
        e.model.pallas_roi_align = kernels
        return e

    engines = {"served bf16": engine(torch.bfloat16, True),
               "plain bf16": engine(torch.bfloat16, False),
               "served f32": engine(torch.float32, True),
               "plain f32": engine(torch.float32, False)}
    serving = {"conv_ln_act": cuda_head.conv_ln_act, "roi_align": cuda_roi_align.roi_align,
               **counters}
    per_forward = {"conv_ln_act": BOTTLENECK_UNITS, "roi_align": 1, **TRAIN_PER_STEP}
    for f in serving.values():
        f.launches = 0
    for images_np, rois in (make_request(rng, 4, 3), make_request(rng, 8, 8)):
        tag = f"A3 flagship, trained, batch {images_np.shape[0]} x {rois.shape[0]} rois"
        o = {}
        for name, e in engines.items():
            before_n = {k: f.launches for k, f in serving.items()}
            o[name] = _serve(e, images_np, rois)
            got_n = {k: f.launches - before_n[k] for k, f in serving.items()}
            want = per_forward if name.startswith("served") else dict.fromkeys(serving, 0)
            if got_n != want:
                raise AssertionError(f"{tag} {name}: launches {got_n}, expected {want}")
        print(f"{tag}: launches per served forward {per_forward}")
        _gates(tag, o)
    served_launches = {k: f.launches for k, f in serving.items()}
    del engines
    torch.cuda.empty_cache()

    med, times, _ = _time_steps(model, cfg, batches)
    print(f"train step, flagship B0 + attention + boundary refinement, stage 1 unfrozen, bf16, "
          f"batch 8 x 8 rois, mid 256: {med:.3f} ms/step, {8 / med * 1e3:.1f} img/s (median of "
          f"{len(times)} steps after 2 of warmup, CUDA events; all {times}) [{card}]")
    del model
    torch.cuda.empty_cache()
    return served_launches


# ---------------------------------------------------------------------------
# Phase 16: training on COCO data
# ---------------------------------------------------------------------------

PHASE16_DIR = ROOT / "build" / "phase16_coco"
# the synthetic COCO trees of 16a, written by the port's generator at the
# flagship's 480 x 640: (images, seed); the val seed gives images with 1, 2,
# 3 and 5 instances, so every curated scene is there
COCO_TRAIN = (64, 0)
COCO_VAL = (16, 1)
COCO_MAX_INSTANCES = 5
PHASE16_STEPS = 16  # two epochs of 64 // 8 steps
# 16d: steps of each fed run per round, the first FED_DRAIN untimed (they
# drain what the loader built while another run had the card); four rounds
# a feed, in an order that gives each the same neighbours
FED_DRAIN = 6
FED_STEPS = 8
FED_ROUNDS = ("loader", "on card", "loader + prefetch", "loader + prefetch", "on card",
              "loader") * 2
# the batch contract (training/steps.py) at the deployed config
BATCH_CONTRACT = {"images": ((8, *IMAGE_HW, 3), "float32"), "boxes": ((8, 8, 4), "float32"),
                  "masks": ((8, 8, *MASK_HW), "int32"), "valid": ((8, 8), "float32"),
                  "image_id": ((8,), "int64")}


def coco_tree(card: str) -> dict:
    """Phase 16 (a): write the train and val trees with the port's
    ``generate_synthetic_coco``; print how long it took, the val set's
    instance counts and whether the native codec loaded (it must)."""
    import shutil
    from collections import Counter

    from human_instance_segmentation_tpu_torch.data import COCOIndex, native
    from human_instance_segmentation_tpu_torch.data.synthetic import generate_synthetic_coco

    shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    tree = {}
    sizes = (COCO_TRAIN, COCO_VAL)
    for split, (n, seed) in zip(("train", "val"), sizes):
        ann, imgs = generate_synthetic_coco(str(PHASE16_DIR / split), n_images=n,
                                            image_size=IMAGE_HW,
                                            max_instances=COCO_MAX_INSTANCES, seed=seed)
        tree[split] = (ann, imgs)
    wall = time.perf_counter() - t0
    lib = native.get_lib()
    val = COCOIndex(tree["val"][0])
    counts = Counter(len(val.get_ann_ids(i, iscrowd=False)) for i in val.get_img_ids())
    print(f"synthetic COCO at {IMAGE_HW[0]}x{IMAGE_HW[1]}: {sizes[0][0]} train + {sizes[1][0]} val "
          f"images (max {COCO_MAX_INSTANCES} instances) written in {wall:.3f} s; val images by "
          f"instance count {dict(sorted(counts.items()))}; native codec "
          f"{'loaded: ' + lib._name if lib is not None else 'NOT loaded: ' + str(native.build_error)}"
          f" [{card}]")
    if lib is None:
        raise AssertionError(f"the native mask codec did not load: {native.build_error}")
    return tree


def coco_config(tree: dict):
    """The deployed config at 480 x 640 on the tree of 16a."""
    from human_instance_segmentation_tpu_torch.config import ConfigManager, _deep_merge

    return _deep_merge(ConfigManager.get_config(TRAIN_CONFIG), coco_mods(tree))


def coco_mods(tree: dict) -> dict:
    mods = json.loads(json.dumps(TRAIN_MODS))
    mods.setdefault("data", {}).update(
        train_annotation=tree["train"][0], train_img_dir=tree["train"][1],
        val_annotation=tree["val"][0], val_img_dir=tree["val"][1])
    mods.setdefault("training", {})["validate_every"] = 1
    return mods


def coco_dataset(cfg, split: str, augment: bool):
    from human_instance_segmentation_tpu_torch.config import _as_hw
    from human_instance_segmentation_tpu_torch.data import (AugmentConfig,
                                                            COCOInstanceSegmentationDataset,
                                                            DatasetConfig)

    d = cfg.data
    ann, imgs = ((d.train_annotation, d.train_img_dir) if split == "train"
                 else (d.val_annotation, d.val_img_dir))
    ds_cfg = DatasetConfig(image_size=_as_hw(cfg.model.image_size),
                           mask_size=_as_hw(cfg.model.mask_size),
                           rois_per_image=d.rois_per_image, roi_padding=d.roi_padding)
    aug = (AugmentConfig(heavy=d.use_heavy_augmentation)
           if augment and d.use_augmentation else None)
    return COCOInstanceSegmentationDataset(ann, imgs, ds_cfg, augment=aug)


def loader_alone(card: str, tree: dict) -> list:
    """Phase 16 (b): ``ThreadedLoader`` over the train set with the config's
    workers, prefetch and augmentation, one epoch: images per second, ms per
    batch, the batch contract's shapes and dtypes; then the same batches
    through ``prefetch_to_device(size=2)``, equal on the card to the host's.
    Returns the host batches."""
    import torch

    from human_instance_segmentation_tpu_torch.data.loader import (ThreadedLoader,
                                                                   prefetch_to_device)

    cfg = coco_config(tree)
    ds = coco_dataset(cfg, "train", augment=True)
    bs = cfg.training.batch_size
    loader = ThreadedLoader(ds, bs, num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch)
    t0 = time.perf_counter()
    host = list(loader.epoch(0))
    wall = time.perf_counter() - t0
    n_img = len(host) * bs
    print(f"ThreadedLoader, {cfg.data.num_workers} workers, prefetch {cfg.data.prefetch}, "
          f"augmentation {'heavy' if cfg.data.use_heavy_augmentation else 'light'}: one epoch of "
          f"{len(host)} batches x {bs} images ({IMAGE_HW[0]}x{IMAGE_HW[1]}, "
          f"{cfg.data.rois_per_image} rois, masks {MASK_HW[0]}x{MASK_HW[1]}) in {wall:.3f} s: "
          f"{n_img / wall:.1f} images/s, "
          f"{1e3 * wall / len(host):.2f} ms per batch (host clock, threads started cold) [{card}]")
    if len(host) != len(ds) // bs:
        raise AssertionError(f"{len(host)} batches, expected {len(ds) // bs}")
    for b in host:
        got = {k: (tuple(v.shape), str(v.dtype)) for k, v in b.items()}
        want = {k: (tuple(s), d) for k, (s, d) in BATCH_CONTRACT.items()}
        if got != want:
            raise AssertionError(f"batch {got} does not meet the contract {want}")
    t0 = time.perf_counter()
    on_dev = list(prefetch_to_device(iter(host), size=2, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = len(on_dev) == len(host) and all(
        v.is_cuda and torch.equal(v.cpu(), torch.from_numpy(h[k]))
        for d, h in zip(on_dev, host) for k, v in d.items())
    print(f"prefetch_to_device(size=2) of the {len(host)} batches to the card: {wall:.3f} s, equal "
          f"to the host batches {same}")
    if not same:
        raise AssertionError("prefetch_to_device changed a batch")
    return host


def stage1_forwards_of_run(cfg, steps: int, validations: int, curated: int) -> int:
    """Stage-1 forwards in ``run_training`` on COCO data: one a train step;
    at each validation one a padded val batch and one a curated render; one
    for the end-of-run picture."""
    import math

    val_batches = math.ceil(len(coco_dataset(cfg, "val", augment=False)) /
                            cfg.training.batch_size)
    return steps + validations * (val_batches + curated) + 1


def train_on_coco(card: str, tree: dict) -> dict:
    """Phase 16 (c): ``run_training`` of the deployed config on the tree of
    16a, 2 epochs of 8 steps with ``validate_every=1``. Gates: every loss
    finite and ``skipped == 0``; ``val_miou`` logged at both epochs; a
    curated grid and its ``_aux.png`` for every label at both epochs;
    ``val_step16.png``; the last and the best checkpoints restored into a
    fresh state, the last equal to the trained state, the best at its
    logged validation; the launches of the fused stage-1 kernels equal to
    the run's stage-1 forwards times their launches a forward; and the
    trained model's metric sums on one val batch, ``training.metrics`` on
    the card against the same on the CPU (``bincount`` counts exact).
    Returns the launches."""
    import json as _json
    import shutil

    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.config import model_from_config
    from human_instance_segmentation_tpu_torch.data import padded_batch_iterator
    from human_instance_segmentation_tpu_torch.training import metrics as tmetrics
    from human_instance_segmentation_tpu_torch.training import steps as tsteps
    from human_instance_segmentation_tpu_torch.training.checkpoint import restore_checkpoint
    from human_instance_segmentation_tpu_torch.training.loop import curated_scenes, run_training
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      constant_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    cfg = coco_config(tree)
    steps = PHASE16_STEPS
    out = ROOT / "build" / "phase16_run"
    shutil.rmtree(out, ignore_errors=True)
    counters = train_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics, state = run_training(TRAIN_CONFIG, steps=steps, output_dir=str(out), device="cuda",
                                  config_modifications=coco_mods(tree),
                                  model_overrides=TRAIN_KERNELS, return_state=True)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    val_ds = coco_dataset(cfg, "val", augment=False)
    labels = [lab for lab, _ in curated_scenes(val_ds.samples)]
    spe = len(coco_dataset(cfg, "train", augment=False)) // cfg.training.batch_size
    epochs = steps // spe
    forwards = stage1_forwards_of_run(cfg, steps, epochs, len(labels))
    want = {k: n * forwards for k, n in TRAIN_PER_STEP.items()}
    rows = [_json.loads(line) for f in sorted((out / "logs").glob("*.jsonl"))
            for line in f.read_text().splitlines()]
    losses = [r["total_loss"] for r in rows if "total_loss" in r]
    val_rows = [(r["step"], r["val_miou"]) for r in rows if "val_miou" in r]
    viz = out / "visualizations"
    pictures = sorted(p.name for p in viz.glob("*.png"))
    want_pictures = sorted([f"epoch{e:04d}_{lab}{s}.png" for e in range(epochs) for lab in labels
                            for s in ("", "_aux")] + [f"val_step{steps}.png"])
    print(f"run_training {TRAIN_CONFIG} on COCO ({len(val_ds)} val images; curated {labels}), "
          f"{IMAGE_HW[0]}x{IMAGE_HW[1]}, {steps} steps = {epochs} epochs of {spe}, "
          f"{cfg.training.compute_dtype}: {wall:.1f} s (model build, loader, steps, validation, "
          f"renders, checkpoints); logged losses {losses}, skipped {state.skipped}, val mIoU by "
          f"step {val_rows}; {len(pictures)} pictures; launches {launches} (expected {want}: "
          f"{TRAIN_PER_STEP} per stage-1 forward x {forwards} = {steps} steps + {epochs} x "
          f"(val batches + {len(labels)} curated) + 1 end-of-run) [{card}]")
    if state.skipped or state.step != steps or not losses or not np.isfinite(losses).all():
        raise AssertionError(f"training went wrong: step {state.step}, skipped {state.skipped}, "
                             f"losses {losses}")
    if [s for s, _ in val_rows] != [spe * (e + 1) for e in range(epochs)]:
        raise AssertionError(f"val_miou not logged at every epoch: {val_rows}")
    if pictures != want_pictures or len(labels) != 4:
        raise AssertionError(f"pictures {pictures}, expected {want_pictures}")
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")

    def fresh_restored(directory):
        fresh = TrainState.create(model_from_config(cfg, seed=1, device="cuda", **TRAIN_KERNELS),
                                  build_optimizer(constant_schedule(0.0)), seed=2)
        return restore_checkpoint(str(directory), fresh)

    def equal(a_state, b_state) -> bool:
        a, b = a_state.model.state_dict(), b_state.model.state_dict()
        return (a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                and a_state.step == b_state.step and a_state.skipped == b_state.skipped
                and all(torch.equal(a_state.optimizer.mu[k], b_state.optimizer.mu[k])
                        and torch.equal(a_state.optimizer.nu[k], b_state.optimizer.nu[k])
                        for k in a_state.optimizer.mu)
                and torch.equal(a_state.generator.get_state(), b_state.generator.get_state()))

    last, last_step = fresh_restored(out / "checkpoints")
    best, best_step = fresh_restored(out / "checkpoints_best")
    best_meta = _json.loads((out / "checkpoints_best" / f"metadata_{best_step}.json").read_text())
    top_step, top = max(val_rows, key=lambda r: (r[1], -r[0]))
    ok = (last_step == steps and equal(last, state) and best_step == top_step
          and best_meta["val_miou"] == top and (best_step != steps or equal(best, state)))
    print(f"last checkpoint (step {last_step}) restored equal to the trained state "
          f"{equal(last, state)}; best checkpoint step {best_step}, val mIoU "
          f"{best_meta['val_miou']} (the best logged: step {top_step}, {top})"
          f"{', equal to the trained state' if best_step == steps else ''}")
    if not ok:
        raise AssertionError("a checkpoint does not restore to what the run logged")
    del last, best

    # the validation metrics on the card against the CPU on the same logits
    vb = tsteps.batch_to(next(padded_batch_iterator(val_ds, cfg.training.batch_size)), "cuda")
    logits, _ = tsteps.eval_forward(state.model, vb["images"], vb["boxes"])
    mh, mw = vb["masks"].shape[-2:]
    targets, valid = vb["masks"].reshape(-1, mh, mw), vb["valid"].reshape(-1)
    on_dev = tmetrics.batch_metrics(logits, targets, valid)
    on_cpu = tmetrics.batch_metrics(logits.cpu(), targets.cpu(), valid.cpu())
    exact = all(torch.equal(on_dev[k].cpu(), on_cpu[k]) for k in ("cm3", "cm_bgfg", "cm_tnt"))
    rel = max(float((on_dev[k].cpu() - on_cpu[k]).abs() / on_cpu[k].abs().clamp(min=1e-30))
              for k in on_cpu if on_cpu[k].dim() == 0)
    print(f"training.metrics.batch_metrics on the card vs the CPU on one val batch of "
          f"{targets.numel()} pixels: confusion matrices equal {exact} (cm3 "
          f"{on_dev['cm3'].long().tolist()}), largest relative difference of the sums {rel:.2e} "
          f"(tol 1e-6); finalize_metrics target_miou "
          f"{tmetrics.finalize_metrics(on_dev)['target_miou']:.4f}")
    if not exact or rel > 1e-6:
        raise AssertionError("the metric sums on the card differ from the CPU's")
    del state
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def fed_step_times(card: str, tree: dict, host: list) -> None:
    """Phase 16 (d): the deployed bf16 train step (kernels, mid 256) fed by
    ``ThreadedLoader(...).forever()`` over the train set (augmentation on),
    by batches already on the card (phase 14c's way), and by the loader
    through ``prefetch_to_device(size=2)``, in turns in one call: the median
    ms per step and its quartiles (host clock from the request for a batch
    to the step's end, synchronised), the host's wait in ``next(batches)``,
    and the device idle share: busy time from ``torch.profiler`` over 3
    steps of each against the median step (phase 14c's rule; the profiled
    steps themselves run slower, since the profiler records every host op).
    A difference of two feeds' medians is printed as resolved only where it
    is larger than the spread between quartiles of each feed."""
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from human_instance_segmentation_tpu_torch.config import (loss_config_from_experiment,
                                                              model_from_config)
    from human_instance_segmentation_tpu_torch.data.loader import (ThreadedLoader,
                                                                   prefetch_to_device)
    from human_instance_segmentation_tpu_torch.training import steps as tsteps
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      build_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    cfg = coco_config(tree)
    t = cfg.training
    model = model_from_config(cfg, seed=0, device="cuda", **TRAIN_KERNELS)
    tx = build_optimizer(build_schedule(t.learning_rate, t.num_epochs, len(host), t.scheduler,
                                        t.min_lr, t.warmup_epochs),
                         t.optimizer, t.weight_decay, t.gradient_clip)
    state = TrainState.create(model, tx)
    step = tsteps.make_train_step(model, loss_config_from_experiment(cfg), t.compute_dtype)

    def loader_stream():
        return ThreadedLoader(coco_dataset(cfg, "train", augment=True), t.batch_size,
                              num_workers=cfg.data.num_workers,
                              prefetch=cfg.data.prefetch).forever()

    feeds = {"loader": loader_stream(),
             "on card": itertools.cycle([tsteps.batch_to(b, "cuda") for b in host[:4]]),
             "loader + prefetch": prefetch_to_device(loader_stream(), size=2, device="cuda")}
    step_ms = {name: [] for name in feeds}
    wait_ms = {name: [] for name in feeds}

    def run(name: str, n: int, keep: bool) -> None:
        nonlocal state
        for _ in range(n):
            t0 = time.perf_counter()
            batch = next(feeds[name])
            t1 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if keep:
                step_ms[name].append(1e3 * (t2 - t0))
                wait_ms[name].append(1e3 * (t1 - t0))

    for name in FED_ROUNDS:
        run(name, FED_DRAIN, keep=False)
        run(name, FED_STEPS, keep=True)
    quartiles = {name: statistics.quantiles(step_ms[name], n=4) for name in feeds}
    for name in feeds:
        run(name, FED_DRAIN, keep=False)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(name, TRAIN_PROFILE_STEPS, keep=False)
            wall = 1e3 * (time.perf_counter() - t0) / TRAIN_PROFILE_STEPS
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in events) / (TRAIN_PROFILE_STEPS * 1e3)
        q1, med, q3 = quartiles[name]
        print(f"train step {t.compute_dtype} fed by {name}, B0 {IMAGE_HW[0]}x{IMAGE_HW[1]}, "
              f"batch {t.batch_size} x {cfg.data.rois_per_image} rois, mid 256, fused stage 1: "
              f"{med:.3f} ms/step, {t.batch_size / med * 1e3:.1f} img/s (median of "
              f"{len(step_ms[name])} steps in {FED_ROUNDS.count(name)} rounds after {FED_DRAIN} "
              f"each, host clock to the synchronised end; quartiles {q1:.3f} / {q3:.3f}, spread "
              f"{q3 - q1:.3f}; all {[round(x, 3) for x in step_ms[name]]}); host wait in "
              f"next(batches) median {statistics.median(wait_ms[name]):.3f} ms, max "
              f"{max(wait_ms[name]):.3f}; device busy {busy:.3f} ms per step "
              f"({100 * (1 - busy / med):.1f}% idle against the median step; {wall:.3f} ms per "
              f"profiled step) [{card}]")
    for a, b in (("loader", "on card"), ("loader + prefetch", "loader"),
                 ("loader + prefetch", "on card")):
        diff = quartiles[a][1] - quartiles[b][1]
        spread = max(quartiles[a][2] - quartiles[a][0], quartiles[b][2] - quartiles[b][0])
        print(f"fed by {a} against {b}: medians differ by {diff:+.3f} ms "
              f"({100 * diff / quartiles[b][1]:+.1f}%), the larger spread between quartiles "
              f"{spread:.3f} ms: {'resolved' if abs(diff) > spread else 'unresolved'}")
    if state.skipped:
        raise AssertionError(f"{state.skipped} fed steps were skipped")
    for name in ("loader", "loader + prefetch"):  # stops the loaders' threads
        feeds[name].close()
    del feeds, state, model, step
    torch.cuda.empty_cache()


def learnability(card: str) -> None:
    """Phase 16 (e): the JAX package's ``tests/test_learnability.py`` on the
    port: the tiny flagship with every part trainable, synthetic COCO of 8
    images at 64 x 64 (2 instances at most), Adam 3e-3 with clip 1.0 in
    float32, 15 epochs at batch 4. Gates (the JAX test's): the last loss
    below 0.7 x the first, target mIoU above 0.25."""
    import numpy as np

    from human_instance_segmentation_tpu_torch.data import (COCOInstanceSegmentationDataset,
                                                            DatasetConfig, batch_iterator)
    from human_instance_segmentation_tpu_torch.data.synthetic import generate_synthetic_coco
    from human_instance_segmentation_tpu_torch.inference import create_flagship
    from human_instance_segmentation_tpu_torch.losses.hierarchical import RefinedLossConfig
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      constant_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState
    from human_instance_segmentation_tpu_torch.training.steps import (make_eval_step,
                                                                      make_train_step)

    root = ROOT / "build" / "phase16_learn"
    ann, img_dir = generate_synthetic_coco(str(root), n_images=8, image_size=(64, 64),
                                           max_instances=2)
    ds = COCOInstanceSegmentationDataset(ann, img_dir, DatasetConfig(
        image_size=(64, 64), mask_size=(32, 24), rois_per_image=2, min_roi_size=4))
    if len(ds) != 8:
        raise AssertionError(f"{len(ds)} samples, expected 8")
    model = create_flagship(variant="tiny", roi_size=(16, 12), mask_size=(32, 24),
                            image_size=(64, 64), base_channels=16, depth=2, mid_channels=32,
                            feature_dim=32, unet_decoder_channels=(32, 24, 16, 16, 8),
                            freeze_pretrained=False, seed=0, device="cuda")
    state = TrainState.create(model, build_optimizer(constant_schedule(3e-3), "adam", 0.0, 1.0))
    step = make_train_step(model, RefinedLossConfig())
    eval_step = make_eval_step(model)
    t0 = time.perf_counter()
    losses = []
    for epoch in range(15):
        for batch in batch_iterator(ds, batch_size=4, shuffle=True, seed=epoch):
            state, m = step(state, batch)
            losses.append(float(m["total_loss"]))
    sums = None
    for batch in batch_iterator(ds, batch_size=4, shuffle=True, seed=99):
        s = {k: float(v) for k, v in eval_step(batch).items()}
        sums = s if sums is None else {k: sums[k] + s[k] for k in sums}
    miou = sums["iou_sum"] / max(sums["n"], 1.0)
    print(f"learnability (tiny flagship, all trainable, 8 synthetic images at 64x64, Adam 3e-3, "
          f"15 epochs = {len(losses)} steps, float32): {time.perf_counter() - t0:.1f} s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (gate < 0.7 x first = "
          f"{0.7 * losses[0]:.4f}), target mIoU {miou:.4f} (gate > 0.25), skipped "
          f"{state.skipped} [{card}]")
    if not (np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0] and miou > 0.25):
        raise AssertionError("the tiny model did not learn")


# ---------------------------------------------------------------------------
# Phase 17: the deployment tools (export, harness, validate)
# ---------------------------------------------------------------------------

PHASE17_DIR = ROOT / "build" / "phase17"
EXPORT_BUCKETS = (1, 2, 4, 8, 16)
# the served "_fast" family's head width (bench.py), with the stage-1 kernels
DEPLOY_MID = 128
DEPLOY_KERNELS = {"pallas_tail": True, "encoder_fused_blocks": 6}
# an artifact (float32 plain path, BatchNorm folded) against the live
# unfolded float32 plain path: the JAX export test's atol on the person
# probability, and instance masks equal or agreeing on MIN_AGREE of pixels
EXPORT_ATOL = 2e-4


def deployed_flagship():
    """The deployed B0 flagship at 480 x 640, head mid 128, with the fused
    tail and six fused encoder blocks, seeded; its stage-1 running
    statistics moved off 0 and 1 (seeded) so that the fold changes every
    BatchNorm."""
    import torch

    from human_instance_segmentation_tpu_torch.inference import create_flagship
    from human_instance_segmentation_tpu_torch.ops.norms import BatchNorm2d

    model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                            image_size=IMAGE_HW, mid_channels=DEPLOY_MID, seed=0,
                            **DEPLOY_KERNELS)
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.running_mean.numel()
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return model


def _live_plain(model, images, rois, dilation: int):
    """The deployed outputs of ``export.plain_copy(model)`` (float32, every
    kernel route off) on one padded bucket, numpy."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.export import DeployedForward, plain_copy
    from human_instance_segmentation_tpu_torch.inference import pad_rois, roi_bucket

    fn = DeployedForward(plain_copy(model), dilation)
    n = rois.shape[0]
    rois_p = torch.as_tensor(pad_rois(np.asarray(rois, np.float32), roi_bucket(n))).cuda()
    with torch.no_grad():
        inst, binary = fn(torch.as_tensor(images).cuda(), rois_p)
    return inst[:n].cpu().numpy(), binary.cpu().numpy()


def deployment_tools(card: str, rng, tree: dict) -> dict:
    """Phase 17 on the deployed B0 flagship at 480 x 640 (:func:`deployed_flagship`):
    (a) ``export.fold_batch_stats`` on a copy, the folded model served with
    the kernels (bf16 and float32, ``fused_head``, the fused tail, six fused
    blocks) against the unfolded one on its plain path under phase 4's
    gates, launches per forward asserted; (b) ``export_model`` with buckets
    (1, 2, 4, 8, 16) on the card, its time printed; (c) ``load_exported``
    against the live float32 plain path (binary within ``EXPORT_ATOL``,
    instance masks equal or agreeing on ``MIN_AGREE``), 33 ROIs chunked equal
    to the in-bucket calls; (d) ms per artifact call beside the engine's;
    (e) ``run_harness`` with the artifact and with ``--config``, and
    ``run_validation``, over phase 16a's val tree. Returns the launch counts
    of the served forwards."""
    import copy
    import shutil

    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.export import (collect_bn_eps, export_model,
                                                              fold_batch_stats, load_exported)
    from human_instance_segmentation_tpu_torch.harness import run_harness
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine
    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align
    from human_instance_segmentation_tpu_torch.validate import run_validation

    shutil.rmtree(PHASE17_DIR, ignore_errors=True)
    model = deployed_flagship()
    eps = collect_bn_eps(model)
    folded = fold_batch_stats(copy.deepcopy(model), eps)
    print(f"fold_batch_stats: {len(eps)} BatchNorms (eps {sorted(set(eps.values()))})")

    def engine(m, dtype, kernels: bool):
        e = InferenceEngine(m, dilation_pixels=1, dtype=dtype, fused_head=kernels,
                            kernels=kernels)
        e.model.pallas_roi_align = kernels
        return e

    engines = {"served bf16": engine(folded, torch.bfloat16, True),
               "plain bf16": engine(model, torch.bfloat16, False),
               "served f32": engine(folded, torch.float32, True),
               "plain f32": engine(model, torch.float32, False)}
    counters = dict(train_counters(), conv_ln_act=cuda_head.conv_ln_act,
                    roi_align=cuda_roi_align.roi_align)
    for f in counters.values():
        f.launches = 0
    served_forwards = 0
    for images, rois in (make_request(rng, 4, 3), make_request(rng, 8, 8)):
        o = {name: _serve(e, images, rois) for name, e in engines.items()}
        served_forwards += 2
        _gates(f"folded model with the kernels vs unfolded plain, batch {images.shape[0]} x "
               f"{rois.shape[0]} rois", o)
    launches = {k: f.launches for k, f in counters.items()}
    per_forward = {"mbconv_sums": 6, "mbconv_apply": 6, "tail": 1,
                   "conv_ln_act": BOTTLENECK_UNITS, "roi_align": 1}
    want = {k: n * served_forwards for k, n in per_forward.items()}
    print(f"served folded forwards: launches {launches} (expected {want}: {per_forward} per "
          f"forward x {served_forwards})")
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    del engines, folded
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    art = export_model(str(PHASE17_DIR / "artifact"), model, IMAGE_HW, ROI_HW, MASK_HW,
                       dilation_pixels=1, roi_buckets=EXPORT_BUCKETS, config_name=TRAIN_CONFIG)
    export_s = time.perf_counter() - t0
    sizes = {p.name: p.stat().st_size for p in sorted(Path(art).iterdir())}
    print(f"export_model on the card, buckets {EXPORT_BUCKETS}: {export_s:.2f} s (one trace with "
          f"the ROI count dynamic, saved per bucket); files {sizes} [{card}]")
    t0 = time.perf_counter()
    call, meta = load_exported(art, device="cuda")
    images, rois = make_request(rng, 1, 3)
    call(images, rois)  # loads the bucket of 4
    print(f"load_exported + first call: {time.perf_counter() - t0:.2f} s; metadata keys "
          f"{sorted(meta)}")
    for n in (3, 16):
        images, rois = make_request(rng, 1, n)
        inst, binary = call(images, rois)
        ref_inst, ref_bin = _live_plain(model, images, rois, 1)
        err = float(np.abs(binary - ref_bin).max())
        agree = _agreement(inst, ref_inst)
        print(f"artifact vs the live float32 plain path, 1 x {n} rois: binary max_abs_err "
              f"{err:.3e} (tol {EXPORT_ATOL}), instance agreement {agree:.6f} (min {MIN_AGREE}), "
              f"fg share {inst.mean():.4f}")
        if inst.shape != (n, *MASK_HW, 1) or binary.shape != (1, *IMAGE_HW, 1):
            raise AssertionError(f"bad artifact output shapes {inst.shape}, {binary.shape}")
        if not (err <= EXPORT_ATOL and agree >= MIN_AGREE):
            raise AssertionError("the artifact disagrees with the live plain path")
    images, rois = make_request(rng, 1, 33)
    inst, binary = call(images, rois)
    chunks_equal = inst.shape == (33, *MASK_HW, 1) and all(
        np.array_equal(inst[s:s + 16], call(images, rois[s:s + 16])[0]) for s in (0, 16, 32))
    print(f"33 rois over buckets {EXPORT_BUCKETS}: chunked, equal to the in-bucket calls chunk by "
          f"chunk: {chunks_equal}")
    if not chunks_equal:
        raise AssertionError("the chunked artifact call differs from the in-bucket calls")

    images, rois = make_request(rng, 1, 4)
    timed = {"artifact (float32 plain, folded)": lambda: call(images, rois)}
    for name, dtype, kernels in (("engine bf16 with the kernels", torch.bfloat16, True),
                                 ("engine float32 plain", torch.float32, False)):
        e = engine(model, dtype, kernels)
        e(images, rois)
        timed[name] = (lambda e=e: e(images, rois))
    times = {name: median_ms(fn, reps=10) for name, fn in timed.items()}
    print("ms per call, 1 x 4 rois at 480x640, numpy in and out (host copies included): "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" [{card}]")
    del timed
    torch.cuda.empty_cache()

    val_ann, val_dir = tree["val"]
    n_img = min(8, len(list(Path(val_dir).glob("*.jpg"))))
    for label, kw in (("artifact", dict(artifact=art)), ("--config", {})):
        t0 = time.perf_counter()
        written = run_harness(val_dir, str(PHASE17_DIR / f"harness_{label.strip('-')}"),
                              annotations_path=val_ann, dilation=1, device="cuda", **kw)
        print(f"run_harness ({label}) over the val tree: {len(written)} PNGs in "
              f"{time.perf_counter() - t0:.2f} s")
        if len(written) != n_img or not all(Path(w).stat().st_size for w in written):
            raise AssertionError(f"run_harness ({label}) wrote {len(written)} of {n_img} PNGs")
    t0 = time.perf_counter()
    report = run_validation(TRAIN_CONFIG, annotations=val_ann, image_dir=val_dir, batch_size=4,
                            device="cuda", cm_png_dir=str(PHASE17_DIR / "cm"))
    print(f"run_validation over the val tree: {time.perf_counter() - t0:.2f} s, target mIoU "
          f"{report['target_miou']:.4f}, {report['num_samples']:.0f} rois")
    pngs = sorted(p.name for p in (PHASE17_DIR / "cm").glob("*.png"))
    if not (np.isfinite([v for v in report.values() if isinstance(v, float)]).all()
            and report["num_samples"] > 0 and pngs == ["cm3.png", "cm_bgfg.png", "cm_tnt.png"]):
        raise AssertionError(f"run_validation went wrong: {report}, {pngs}")
    del model, call
    shutil.rmtree(PHASE17_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 18: distillation
# ---------------------------------------------------------------------------

DISTILL_CONFIG = "rgb_hierarchical_unet_v2_distillation_b0_from_b7_temp_prog"
DISTILL_EPOCHS, DISTILL_SPE = 2, 4
DISTILL_MODS = {"distillation": {"unfreeze_schedule": {"1": 2}}}
DISTILL_VAL_BATCHES = 2  # the synthetic run's held-out batches
# bench.py's hierarchical KD shapes (scripts/exp_b0_fast_deployed.py:41-44)
HIER_TEACHER_MID, HIER_STUDENT_MID, HIER_BATCH, HIER_ROIS = 256, 128, 4, 2
# launches in one distillation step, filled by phase 18 (a) and (d)
DISTILL_PER_STEP: dict = {}


def admissible_fused_blocks(variant: str) -> int:
    """The largest N such that each of the first N MBConv blocks of the
    ``variant`` encoder fits the fused kernel's shared memory in both passes
    and both dtypes (``ops/cuda_mbconv._SMEM_LIMIT``)."""
    from human_instance_segmentation_tpu_torch.models.efficientnet import EfficientNetEncoder
    from human_instance_segmentation_tpu_torch.ops import _build, cuda_mbconv

    lib = _build.library()
    enc = EfficientNetEncoder(variant)
    n = 0
    for name in (nm for names in enc.stages for nm in names):
        b = getattr(enc, name)
        expand = b.expand_conv is not None
        ci = b.expand_conv.weight.shape[1] if expand else b.dw_conv.weight.shape[0]
        co = b.project_conv.weight.shape[0]
        need = max(lib.mbconv_smem_bytes_for(ci, c, b.kernel, b.stride, elem, int(expand), apply)
                   for elem in (4, 2) for apply, c in ((0, 0), (1, co)))
        if need > cuda_mbconv._SMEM_LIMIT:
            break
        n += 1
    return n


def distill_teacher_kernels() -> dict:
    """The binary teacher's route flags: the fused tail and the largest
    admissible number of fused blocks of B7, printed with B3's."""
    n7, n3 = admissible_fused_blocks("b7"), admissible_fused_blocks("b3")
    print(f"fused MBConv blocks every block admits (shared memory): B7 {n7}, B3 {n3}")
    if n7 < 1:
        raise AssertionError("no B7 block admits the fused MBConv kernel")
    return {"pallas_tail": True, "encoder_fused_blocks": n7}


def distillation_run(card: str, teacher_kernels: dict) -> dict:
    """Phase 18 (a): ``run_distillation`` on ``DISTILL_CONFIG`` at its own
    sizes (B0 student, B7 teacher, 640 x 640, batch 8, bf16), synthetic, 2
    epochs x 4 steps, an unfreeze of 2 stages at epoch 1, the teacher with
    the fused tail and the admissible fused blocks. Gates: every step
    finite, the temperature of each epoch the schedule's, the fused stage-1
    launches equal to a teacher forward per step plus one teacher sweep of
    the validation batches, the optimizer rebuilt at epoch 1 (its step count
    is epoch 1's), the run's newest checkpoint restored with its
    distillation state (equal to the final state where it is the last
    epoch's) and the final state through a checkpoint equal to itself.
    Returns the launch counts of the run."""
    import shutil

    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.config import ConfigManager, _deep_merge
    from human_instance_segmentation_tpu_torch.losses.distillation import (DistillationConfig,
                                                                           DistillationState,
                                                                           scheduled_temperature)
    from human_instance_segmentation_tpu_torch.training.checkpoint import (latest_step,
                                                                          restore_checkpoint,
                                                                          save_checkpoint)
    from human_instance_segmentation_tpu_torch.training.distill import build_student_teacher
    from human_instance_segmentation_tpu_torch.training.distill_loop import (DECODER,
                                                                            run_distillation)
    from human_instance_segmentation_tpu_torch.training.optim import (constant_schedule,
                                                                      distillation_optimizer)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    out = ROOT / "build" / "phase18_run"
    shutil.rmtree(out, ignore_errors=True)
    cfg = _deep_merge(ConfigManager.get_config(DISTILL_CONFIG), DISTILL_MODS)
    counters = train_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics, state = run_distillation(DISTILL_CONFIG, epochs=DISTILL_EPOCHS,
                                      steps_per_epoch=DISTILL_SPE, synthetic=True,
                                      output_dir=str(out), config_modifications=DISTILL_MODS,
                                      teacher_overrides=teacher_kernels, return_state=True)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    n = teacher_kernels["encoder_fused_blocks"]
    per_forward = {"mbconv_sums": n, "mbconv_apply": n, "tail": 1}
    steps = DISTILL_EPOCHS * DISTILL_SPE
    want = {k: v * (steps + DISTILL_VAL_BATCHES) for k, v in per_forward.items()}
    rows = [json.loads(line) for f in sorted((out / "logs").glob("*.jsonl"))
            for line in f.read_text().splitlines()]
    temps = [r["temperature"] for r in rows if "temperature" in r]
    kd = DistillationConfig(initial_temperature=cfg.distillation.initial_temperature,
                            final_temperature=cfg.distillation.final_temperature,
                            schedule_type=cfg.distillation.temperature_schedule)
    want_t = [scheduled_temperature(kd, e, DISTILL_EPOCHS) for e in range(DISTILL_EPOCHS)]
    log = "".join(f.read_text() for f in (out / "logs").glob("*.log"))
    print(f"run_distillation {DISTILL_CONFIG} (B0 from B7, {cfg.model.image_size}, batch "
          f"{cfg.training.batch_size}, {cfg.training.compute_dtype}), synthetic, {DISTILL_EPOCHS} "
          f"epochs x {DISTILL_SPE} steps, teacher {teacher_kernels}: {wall:.1f} s (models, steps, "
          f"validation, checkpoints); losses by epoch {[r.get('total_loss') for r in rows]}, "
          f"temperatures {temps} (schedule {want_t}), best student mIoU "
          f"{metrics['best_student_miou']:.4f}, teacher mIoU {metrics['teacher_miou']:.4f}, "
          f"eliminated {metrics['eliminated']}, skipped {state.skipped}; launches {launches} "
          f"(expected {want}: {per_forward} per teacher forward x ({steps} steps + "
          f"{DISTILL_VAL_BATCHES} validation batches, one sweep)); optimizer steps "
          f"{state.optimizer.count} [{card}]")
    if state.skipped or state.step != steps or not all(
            np.isfinite(r["total_loss"]) for r in rows if "total_loss" in r):
        raise AssertionError(f"distillation went wrong: step {state.step}, skipped "
                             f"{state.skipped}, rows {rows}")
    if temps != [float(np.float32(t)) for t in want_t]:
        raise AssertionError(f"temperatures {temps}, expected {want_t}")
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    if not ("epoch 1: unfroze last 2 encoder stages" in log
            and state.optimizer.count["encoder_train"] == DISTILL_SPE
            and state.optimizer.count["train"] == DISTILL_SPE):
        raise AssertionError(f"the optimizer was not rebuilt at epoch 1: {state.optimizer.count}")
    DISTILL_PER_STEP.update(per_forward)

    def fresh(num_unfrozen: int):
        student, _ = build_student_teacher(cfg.distillation.student_encoder, "tiny",
                                           device="cuda", decoder_channels=DECODER)
        return TrainState.create(student, distillation_optimizer(
            student, constant_schedule(0.0), num_unfrozen), seed=9,
            distill_state=DistillationState.create())

    def equal(a, b) -> bool:
        sa, sb = a.model.state_dict(), b.model.state_dict()
        oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
        return (a.step == b.step and a.skipped == b.skipped and sa.keys() == sb.keys()
                and all(torch.equal(sa[k], sb[k]) for k in sa) and oa["count"] == ob["count"]
                and all(oa[s].keys() == ob[s].keys()
                        and all(torch.equal(oa[s][k], ob[s][k]) for k in oa[s])
                        for s in ("mu", "nu"))
                and all(torch.equal(v, b.distill_state.state_dict()[k])
                        for k, v in a.distill_state.state_dict().items()))

    saved = latest_step(str(out / "checkpoints"))
    meta = json.loads((out / "checkpoints" / f"metadata_{saved}.json").read_text())
    restored, _ = restore_checkpoint(str(out / "checkpoints"), fresh(meta["num_unfrozen"]))
    last = saved == DISTILL_EPOCHS
    ok = equal(restored, state) if last else restored.step == saved * DISTILL_SPE
    save_checkpoint(str(out / "final"), state, steps)
    again, _ = restore_checkpoint(str(out / "final"), fresh(2))
    print(f"newest checkpoint: epoch {saved} (metadata {meta}), restored with its distillation "
          f"state {restored.distill_state.state_dict()}: "
          f"{'equal to the final state' if last else 'at its step'} {ok}; the final state "
          f"through a checkpoint equal: {equal(again, state)}")
    if not (ok and equal(again, state)):
        raise AssertionError("a restored distillation state differs")
    del state, restored, again
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _distill_models(teacher_kernels: dict):
    """The B0 student and the B7 teacher at the config's widths, and the same
    teacher weights without the kernel flags (no fused tail, no fused
    blocks: its forward reaches no hand kernel)."""
    import torch

    from human_instance_segmentation_tpu_torch.training.distill import build_student_teacher
    from human_instance_segmentation_tpu_torch.training.distill_loop import DECODER

    student, teacher = build_student_teacher("b0", "b7", device="cuda", decoder_channels=DECODER,
                                             teacher_overrides=teacher_kernels)
    _, plain = build_student_teacher("tiny", "b7", device="cuda", decoder_channels=DECODER)
    a, b = teacher.state_dict(), plain.state_dict()
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("the two teachers do not hold the same weights")
    return student, teacher, plain


def _distill_batches(n: int, seed: int):
    from human_instance_segmentation_tpu_torch.config import ConfigManager, _as_hw
    from human_instance_segmentation_tpu_torch.training.distill_loop import (
        synthetic_binary_batches)

    cfg = ConfigManager.get_config(DISTILL_CONFIG)
    gen = synthetic_binary_batches(cfg.training.batch_size, _as_hw(cfg.model.image_size), seed)
    return [next(gen) for _ in range(n)]


def _distill_loss_and_grads(student, teacher, batch, dtype: str, delta=None):
    """One evaluation of the binary KD loss and the student's gradients
    (its statistics handed over, not written), and the teacher logits it
    saw as (B, H, W); ``delta(t)`` is added to the teacher logits when
    given."""
    import torch

    from human_instance_segmentation_tpu_torch.losses.distillation import (DistillationConfig,
                                                                           DistillationState)
    from human_instance_segmentation_tpu_torch.training import distill

    t = distill.teacher_copy(teacher, dtype)
    seen = {}

    def hook(module, inputs, out):
        form, y = out
        if delta is not None:
            y = y + delta(y).to(y.dtype)
        seen["t"] = (y if form == "dense" else y[:, 0]).float()
        return form, y

    handle = t.register_forward_hook(hook)
    try:
        student.train()
        loss, _ = distill.make_distill_loss_fn(student, t, DistillationConfig(), dtype)(
            DistillationState.create(4.0, 0.5, 0.3, device="cuda"),
            distill.batch_to(batch, "cuda"))
        params = list(student.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        handle.remove()
    flat = torch.cat([(g if g is not None else torch.zeros_like(p)).flatten()
                      for p, g in zip(params, grads)])
    return float(loss.detach()), flat.detach(), seen["t"]


def distill_step_kernels(card: str, teacher_kernels: dict) -> None:
    """Phase 18 (b): the binary KD step's loss and student gradients with
    the teacher's kernels against the same teacher weights without them,
    TF32 off, by phase 14b's rule: in float32 the teacher logits within
    ``TOL_STAGE1_F32`` and the loss and gradients within twice the effect
    of a teacher-logit error at that tolerance; in bf16 the kernel path no
    further from the float32 plain path than twice the bf16 plain path's own
    distance plus the float32 bound."""
    import torch

    student, teacher, plain = _distill_models(teacher_kernels)
    batch = _distill_batches(1, seed=3)[0]
    res = {(path, dtype): _distill_loss_and_grads(student, t, batch, dtype)
           for path, t in (("kernels", teacher), ("plain", plain))
           for dtype in ("float32", "bfloat16")}
    lk, gk, xk = res[("kernels", "float32")]
    lp, gp, xp = res[("plain", "float32")]
    atol, rtol = TOL_STAGE1_F32
    x_err = (xk - xp).abs()
    x_ok = bool((x_err <= atol + rtol * xp.abs()).all())
    gen = torch.Generator(device="cuda").manual_seed(11)

    def shift(x):
        return atol + rtol * x.abs()

    def random_sign(x):
        s = torch.randint(0, 2, x.shape, generator=gen, device=x.device) * 2 - 1
        return s * (atol + rtol * x.abs())

    effects = [_distill_loss_and_grads(student, plain, batch, "float32", d)
               for d in (shift, random_sign)]
    l_bound = 2 * max(abs(le - lp) for le, _, _ in effects)
    g_bound = 2 * max(float((ge - gp).norm()) for _, ge, _ in effects)
    l_err, g_err = abs(lk - lp), float((gk - gp).norm())
    print(f"distill step float32 (B0 from B7, batch 8, 640x640), teacher kernels vs plain: "
          f"teacher logits max_abs_err {float(x_err.max()):.3e} (tol {atol} + {rtol} |x|, max "
          f"|x| {float(xp.abs().max()):.2f}); loss {lk:.7f} vs {lp:.7f}, |diff| {l_err:.3e} "
          f"(bound {l_bound:.3e}); student gradients |diff| {g_err:.3e} of |g| "
          f"{float(gp.norm()):.3e} (bound {g_bound:.3e})")
    if not (x_ok and l_err <= l_bound and g_err <= g_bound):
        raise AssertionError("float32 distill step: the kernel path is outside its bound")
    lkb, gkb, _ = res[("kernels", "bfloat16")]
    lpb, gpb, _ = res[("plain", "bfloat16")]
    lb_bound = 2 * abs(lpb - lp) + l_bound
    gb_bound = 2 * float((gpb - gp).norm()) + g_bound
    lb_err, gb_err = abs(lkb - lp), float((gkb - gp).norm())
    print(f"distill step bfloat16 vs the float32 plain path: kernels loss {lkb:.6f}, |diff| "
          f"{lb_err:.3e} (bound {lb_bound:.3e}: twice the bf16 plain path's {abs(lpb - lp):.3e} "
          f"plus the float32 bound); student gradients |diff| {gb_err:.3e} (bound "
          f"{gb_bound:.3e})")
    if not (lb_err <= lb_bound and gb_err <= gb_bound):
        raise AssertionError("bf16 distill step: the kernel path is outside its bound")
    del res, effects, student, teacher, plain
    torch.cuda.empty_cache()


def _timed_steps(runs: dict, batches, reps: int = 10) -> dict:
    """Median ms per step of each ``{name: [state, step]}``, CUDA events,
    the runs in turns, after 3 steps of warmup each."""
    import torch

    for run in runs.values():
        for i in range(3):
            run[0], _ = run[1](run[0], batches[i % len(batches)])
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    names = list(runs)
    for i in range(reps):
        for name in (names if i % 2 == 0 else names[::-1]):
            run = runs[name]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run[0], _ = run[1](run[0], batches[i % len(batches)])
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    for name, run in runs.items():
        if run[0].skipped:
            raise AssertionError(f"{name}: {run[0].skipped} timed steps were skipped")
    return {name: statistics.median(t) for name, t in times.items()}


def _busy_ms(run, batches, steps: int = TRAIN_PROFILE_STEPS):
    """Over ``steps`` steps under ``torch.profiler``, per step: the summed
    device time of the kernels (and copies), the kernels, the host-clock
    wall time of the profiled steps themselves (tracing can lengthen them),
    the device busy time as the union of the kernels' time ranges (no
    instant counted twice where kernels overlap) and the number of CUDA
    streams the kernels ran on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            run[0], _ = run[1](run[0], batches[i % len(batches)])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type.name == "CUDA")
    streams = {e.device_resource_id for e in prof.events() if e.device_type.name == "CUDA"}
    union, reach = 0.0, float("-inf")
    for start, end in ranges:
        if end > reach:
            union += end - max(start, reach)
            reach = end
    return (sum(e.self_device_time_total for e in events) / (steps * 1e3),
            sum(e.count for e in events) // steps, wall, union / (steps * 1e3), len(streams))


def time_distill_steps(card: str, teacher_kernels: dict) -> None:
    """Phase 18 (c): ms per bf16 binary KD step (B0 from B7, batch 8, 640 x
    640; median of 10 after 3 of warmup, batches on the card), the teacher
    with its kernels and plain in turns; the teacher's bf16 forward alone
    and its share of the step; device busy time and idle share over 3
    steps; peak memory."""
    import torch

    from human_instance_segmentation_tpu_torch.config import ConfigManager, _as_hw
    from human_instance_segmentation_tpu_torch.losses.distillation import (DistillationConfig,
                                                                           DistillationState)
    from human_instance_segmentation_tpu_torch.training import distill
    from human_instance_segmentation_tpu_torch.training.distill_loop import DECODER
    from human_instance_segmentation_tpu_torch.training.optim import (build_schedule,
                                                                      distillation_optimizer)
    from human_instance_segmentation_tpu_torch.training.state import TrainState
    from human_instance_segmentation_tpu_torch.training.steps import batch_to

    cfg = ConfigManager.get_config(DISTILL_CONFIG)
    t = cfg.training
    batches = [batch_to(b, "cuda") for b in _distill_batches(4, seed=7)]
    student, teacher, plain = _distill_models(teacher_kernels)
    runs = {}
    for name, tch in (("kernels", teacher), ("plain", plain)):
        # one student per route (the same seed): a step updates its model
        s = student if name == "kernels" else distill.build_student_teacher(
            "b0", "tiny", device="cuda", decoder_channels=DECODER)[0]
        opt = distillation_optimizer(s, build_schedule(t.learning_rate, t.num_epochs, 100,
                                                       t.scheduler, t.min_lr), 0)
        runs[name] = [TrainState.create(s, opt, distill_state=DistillationState.create(
            10.0, 0.7, 0.3)), distill.make_distill_train_step(s, tch, DistillationConfig(),
                                                               t.compute_dtype)]
    torch.cuda.reset_peak_memory_stats()
    med = _timed_steps(runs, batches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    images = batches[0]["images"].to(torch.bfloat16)
    teacher_ms = {}
    for name, tch in (("kernels", teacher), ("plain", plain)):
        t16 = distill.teacher_copy(tch, "bfloat16")
        with torch.no_grad():
            teacher_ms[name] = median_ms(lambda: distill.unet_logits(t16, images), reps=10)
        del t16
    n_img = batches[0]["images"].shape[0]
    for name, run in runs.items():
        busy_sum, kernels, wall, busy, streams = _busy_ms(run, batches)
        print(f"distill step bf16, B0 from B7 at {_as_hw(cfg.model.image_size)}, batch {n_img}, "
              f"teacher {name}: {med[name]:.3f} ms/step, {n_img / med[name] * 1e3:.1f} img/s "
              f"(median of 10 after 3 of warmup, CUDA events); teacher bf16 forward alone "
              f"{teacher_ms[name]:.3f} ms ({100 * teacher_ms[name] / med[name]:.1f}% of the "
              f"step); profiled: {wall:.3f} ms wall, {busy:.3f} ms device busy (union of kernel "
              f"times; {busy_sum:.3f} summed, on {streams} streams) per step, "
              f"{100 * (1 - busy / wall):.1f}% idle, {kernels} kernels per step [{card}]")
    print(f"  peak memory over both routes' timed steps {peak:.2f} GiB (max_memory_allocated)")
    del runs, student, teacher, plain
    torch.cuda.empty_cache()


def hierarchical_distill(card: str, rng) -> dict:
    """Phase 18 (d): ``make_hierarchical_distill_step`` at bench.py's shapes
    (B0 at 480 x 640, roi 64 x 48, mask 128 x 96, batch 4 x 2 ROIs): the
    teacher flagship at mid 256 and the student at mid 128 with its frozen
    stage 1, both with the fused tail and six fused blocks, the teacher's
    crops through the RoIAlign kernel. Gates: finite steps, launches per
    step (both stage 1s, the teacher's crop), every kernel call of a step
    against its plain version on that call's operands (float32; phase 9 and
    12's tolerances, the crops within ``TOL_ROI_F32``); ms per step against
    the same models without the kernels. Returns the launch counts of the
    timed and checked steps."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.config import (ConfigManager,
                                                              loss_config_from_experiment)
    from human_instance_segmentation_tpu_torch.inference import create_flagship
    from human_instance_segmentation_tpu_torch.ops import cuda_mbconv, cuda_roi_align, cuda_tail
    from human_instance_segmentation_tpu_torch.ops.sampling import roi_align as roi_align_plain
    from human_instance_segmentation_tpu_torch.training.distill import (
        make_hierarchical_distill_step)
    from human_instance_segmentation_tpu_torch.training.loop import synthetic_batches
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      build_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState
    from human_instance_segmentation_tpu_torch.training.steps import batch_to

    loss_cfg = loss_config_from_experiment(ConfigManager.get_config(TRAIN_CONFIG))
    gen = synthetic_batches(HIER_BATCH, HIER_ROIS, IMAGE_HW, MASK_HW, seed=5)
    batches = [next(gen) for _ in range(4)]

    def build(mid: int, seed: int, kernels: bool):
        return create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                               image_size=IMAGE_HW, mid_channels=mid, seed=seed,
                               pallas_roi_align=kernels, pallas_tail=kernels,
                               encoder_fused_blocks=6 if kernels else 0)

    runs = {}
    for kernels in (True, False):
        student = build(HIER_STUDENT_MID, 0, kernels)
        teacher = build(HIER_TEACHER_MID, 1, kernels)
        tx = build_optimizer(build_schedule(1e-3, 1, 100, "cosine", 1e-6), "adamw", 1e-4, 5.0)
        runs["kernels" if kernels else "plain"] = [
            TrainState.create(student, tx), make_hierarchical_distill_step(
                student, teacher, loss_cfg, temperature=4.0, alpha=0.7, aux_weight=0.3)]

    counters = dict(train_counters(), roi_align=cuda_roi_align.roi_align)
    real = (cuda_mbconv.fused_mbconv, cuda_tail.tail, cuda_roi_align.roi_align_pair)
    checks = {"fused_mbconv": [], "tail": [], "roi_align_pair": []}

    def within(y, yp, tol):
        atol_, rtol_ = tol
        return float(((y.float() - yp.float()).abs() - atol_ - rtol_ * yp.float().abs()).max())

    def spy_mbconv(x, *ops, **kw):
        y = real[0](x, *ops, **kw)
        checks["fused_mbconv"].append(within(y, cuda_mbconv.fused_mbconv_plain(x, *ops, **kw),
                                             TOL_MBCONV["float32"]) <= 0)
        return y

    def spy_tail(x, *ops, packed=None):
        cuda_tail.tail = real[1]  # the wrapper counts its launches on its own name
        try:
            y = real[1](x, *ops, packed=packed)
        finally:
            cuda_tail.tail = spy_tail
        checks["tail"].append(within(y, cuda_tail.tail_plain(x, *ops), TOL_TAIL["float32"]) <= 0)
        return y

    def spy_pair(first, second, rois, oh, ow, spatial_scale=(640.0, 640.0), aligned=False):
        a, b = real[2](first, second, rois, oh, ow, spatial_scale=spatial_scale, aligned=aligned)
        for got, m in ((a, first), (b, second)):
            want = roi_align_plain(m, rois, oh, ow, spatial_scale=spatial_scale, aligned=aligned)
            checks["roi_align_pair"].append(float((got - want).abs().max()) <= TOL_ROI_F32)
        return a, b

    for f in counters.values():
        f.launches = 0
    cuda_mbconv.fused_mbconv, cuda_tail.tail, cuda_roi_align.roi_align_pair = (
        spy_mbconv, spy_tail, spy_pair)
    try:
        run = runs["kernels"]
        losses = []
        for b in batches[:2]:
            run[0], m = run[1](run[0], b)
            losses.append(float(m["total_loss"]))
    finally:
        cuda_mbconv.fused_mbconv, cuda_tail.tail, cuda_roi_align.roi_align_pair = real
    launches = {k: f.launches for k, f in counters.items()}
    per_step = {"mbconv_sums": 12, "mbconv_apply": 12, "tail": 2, "roi_align": 1}
    want = {k: 2 * v for k, v in per_step.items()}
    print(f"hierarchical KD, teacher mid {HIER_TEACHER_MID} -> student mid {HIER_STUDENT_MID}, "
          f"B0 {IMAGE_HW[0]}x{IMAGE_HW[1]}, batch {HIER_BATCH} x {HIER_ROIS} rois: losses "
          f"{losses}, launches {launches} (expected {want}: {per_step} per step x 2); each "
          f"kernel call within its plain version's tolerance: "
          f"{ {k: f'{sum(v)}/{len(v)}' for k, v in checks.items()} }")
    if not np.isfinite(losses).all() or run[0].skipped:
        raise AssertionError(f"hierarchical KD steps went wrong: {losses}")
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    if [len(checks[k]) for k in checks] != [24, 4, 4] or not all(
            all(v) for v in checks.values()):
        raise AssertionError(f"a kernel call disagrees with its plain version: {checks}")
    DISTILL_PER_STEP["roi_align"] = per_step["roi_align"]
    dev_batches = [batch_to(b, "cuda") for b in batches]
    med = _timed_steps(runs, dev_batches)
    for name, r in runs.items():
        busy_sum, kernels, wall, busy, streams = _busy_ms(r, dev_batches)
        print(f"hierarchical KD step float32, {name} stage-1 routes: {med[name]:.3f} ms/step "
              f"(median of 10 after 3 of warmup, CUDA events); profiled: {wall:.3f} ms wall, "
              f"{busy:.3f} ms device busy (union; {busy_sum:.3f} summed, on {streams} streams), "
              f"{100 * (1 - busy / wall):.1f}% idle, {kernels} kernels per step [{card}]")
    del runs
    torch.cuda.empty_cache()
    return launches


# Phase 19: the other model families and the YOLO-feature distillation, at
# the registry's 640 x 640. The multi-scale RGB model is the pure-RGB
# config with three crops (the JAX default sizes, concat fusion); the
# variable-ROI model is the baseline config with the three YOLO taps at
# their own crop sizes.
A8_BASE = "rgb_hierarchical_unet_v2"
A8_MS_MODS = {"model": {"multi_scale": True, "roi_sizes": [56, 42, 28], "fusion_method": "concat"}}
A8_VAR_MODS = {"model": {"variable_roi_sizes": {"layer_3": 56, "layer_22": 42, "layer_34": 28}}}
A8_BATCH, A8_ROIS = 8, 64  # 8 images x 8 rois each
A8_HEAD_FEATS = (64, 28, 28, 256)
A8_TRAIN_STEPS = 5
YOLO_EPOCHS, YOLO_SPE, YOLO_BATCH = 2, 4, 4
# launches of conv_ln_act in one served forward of each new family, and of
# the stage-1 kernels in one YOLO distillation step, as phase 19 saw them
A8_PER_FORWARD: dict = {}
YOLO_PER_STEP: dict = {}


def fused_units(model, call) -> list:
    """``(Ci, Co, H, W, launches)`` of every unit under ``model`` that the
    fused head's gate admits while ``call()`` runs, read from the gate itself
    on each unit's input (``models.blocks``: eval mode, LayerNorm2d + ReLU,
    a stride-1 k = 1 or 3 conv with bias, ``cuda_head.fusable_shape``): one
    launch for a ConvNormAct, two for a ResidualBlock."""
    from human_instance_segmentation_tpu_torch.models.blocks import ConvNormAct, ResidualBlock
    from human_instance_segmentation_tpu_torch.ops import cuda_head

    units = []

    def pre(m, args):
        _, ci, h, w = args[0].shape
        if isinstance(m, ConvNormAct):
            ok, n = m.stride == 1 and m.kernel in (1, 3) and m.conv.bias is not None, 1
        else:
            ok, n = ci == m.features, 2
        if (ok and not m.training and m.norm_type == "layernorm2d" and m.activation == "relu"
                and cuda_head.fusable_shape(h, w, ci, m.features)):
            units.append((ci, m.features, h, w, n))

    handles = [m.register_forward_pre_hook(pre) for m in model.modules()
               if isinstance(m, (ConvNormAct, ResidualBlock))]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    return units


class ConvLnActSpy:
    """While active, every ``cuda_head.conv_ln_act`` call launches the kernel
    (counted on the wrapper, as in a forward without the spy) and is held
    against ``conv_ln_act_plain`` on the same inputs (no launch): per shape
    ``(Ci, Co, H x W, k, dtype)`` the calls, the max abs error and whether
    each is within ``TOL_CONV``."""

    def __init__(self):
        from human_instance_segmentation_tpu_torch.ops import cuda_head

        self.cuda_head = cuda_head
        self.real = cuda_head.conv_ln_act
        self.shapes: dict = {}

    def __call__(self, x, w, b, gamma, beta, residual=None, **kw):
        self.cuda_head.conv_ln_act = self.real  # the wrapper counts on its own name
        try:
            y = self.real(x, w, b, gamma, beta, residual, **kw)
        finally:
            self.cuda_head.conv_ln_act = self
        plain_kw = {k: v for k, v in kw.items() if k not in ("height", "width")}
        yp = self.cuda_head.conv_ln_act_plain(x, w, b, gamma, beta, residual, **plain_kw)
        dtype = str(x.dtype).replace("torch.", "")
        atol, rtol = TOL_CONV[dtype]
        err = (y.float() - yp.float()).abs()
        key = (x.shape[-1], w.shape[-1], f"{x.shape[1]}x{x.shape[2]}", kw.get("kernel", 3), dtype)
        rec = self.shapes.setdefault(key, {"calls": 0, "max_abs_err": 0.0, "within": True})
        rec["calls"] += 1
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
        rec["within"] &= bool((err <= atol + rtol * yp.float().abs()).all())
        return y

    @property
    def launches(self) -> int:
        return self.real.launches

    def __enter__(self):
        self.cuda_head.conv_ln_act = self
        return self

    def __exit__(self, *exc):
        self.cuda_head.conv_ln_act = self.real

    def report(self, tag: str) -> None:
        for (ci, co, hw, k, dtype), r in sorted(self.shapes.items(), key=str):
            print(f"  {tag} conv_ln_act Ci {ci} Co {co} HxW {hw} k {k} {dtype}: {r['calls']} "
                  f"calls, max_abs_err vs conv_ln_act_plain {r['max_abs_err']:.3e} (tol "
                  f"{TOL_CONV[dtype][0]} + {TOL_CONV[dtype][1]:.4g} |y|), within {r['within']}")
        bad = [key for key, r in self.shapes.items() if not r["within"]]
        if bad:
            raise AssertionError(f"{tag}: conv_ln_act outside its tolerance at {bad}")


class StageKernelSpy:
    """While active, every call of the fused MBConv (``cuda_mbconv.fused_mbconv``),
    the crop pair (``cuda_roi_align.roi_align_pair``) and the int8 tail
    (``cuda_tail.tail_q``) runs the kernel (counted on its wrapper, as
    without the spy) and is held against its plain version on the same
    inputs by the rules of phases 3 and 12: the MBConv within
    ``TOL_MBCONV``, each crop within ``TOL_ROI_F32`` (float32) or one bf16
    ulp, the tail's interior equal and its border within ``TOL_TAIL``.
    ``calls[kernel][shape]`` holds the calls and the max abs error."""

    def __init__(self):
        from human_instance_segmentation_tpu_torch.ops import cuda_mbconv, cuda_roi_align, cuda_tail

        self.sites = {"fused_mbconv": (cuda_mbconv, self._mbconv),
                      "roi_align_pair": (cuda_roi_align, self._crops),
                      "tail_q": (cuda_tail, self._tail_q)}
        self.real = {name: getattr(mod, name) for name, (mod, _) in self.sites.items()}
        self.calls: dict = {name: {} for name in self.sites}

    def _wrap(self, name):
        mod, check = self.sites[name]
        real = self.real[name]

        def call(*args, **kwargs):
            setattr(mod, name, real)  # a wrapper counts its launches on its own name
            try:
                y = real(*args, **kwargs)
            finally:
                setattr(mod, name, call)
            key, err = check(y, *args, **kwargs)
            rec = self.calls[name].setdefault(key, [0, 0.0])
            rec[0] += 1
            rec[1] = max(rec[1], err)
            return y

        return call

    @staticmethod
    def _mbconv(y, x, *ops, **kw):
        from human_instance_segmentation_tpu_torch.ops import cuda_mbconv

        ref = cuda_mbconv.fused_mbconv_plain(x, *ops, **kw)
        diff = (y.float() - ref.float()).abs()
        atol, rtol = TOL_MBCONV[str(y.dtype).split(".")[1]]
        key = (x.shape[1], y.shape[1], x.shape[2], x.shape[3], kw["kernel"], kw["stride"],
               kw["residual"])
        if y.shape != ref.shape or not bool((diff <= atol + rtol * ref.float().abs()).all()):
            raise AssertionError(f"fused_mbconv {key} in the forward: {diff.max().item()}")
        return key, diff.max().item()

    @staticmethod
    def _crops(y, first, second, rois, oh, ow, **kw):
        import torch

        from human_instance_segmentation_tpu_torch.ops import cuda_roi_align

        err = 0.0
        for got, m in zip(y, (first, second)):
            ref = cuda_roi_align.roi_align_plain(m, rois, oh, ow, **kw)
            diff = (got.float() - ref.float()).abs()
            ok = (bool((diff <= TOL_ROI_F32).all()) if got.dtype == torch.float32
                  else bool((diff <= 1e-6 + ROI_BF16_RTOL * ref.float().abs()).all()))
            if got.shape != ref.shape or not ok:
                raise AssertionError(f"roi_align_pair {tuple(m.shape)} -> {oh}x{ow} in the "
                                     f"forward: {diff.max().item()}")
            err = max(err, diff.max().item())
        return (oh, ow, first.shape[-1], second.shape[-1], str(first.dtype)), err

    @staticmethod
    def _tail_q(y, x, *ops, **kw):
        from human_instance_segmentation_tpu_torch.ops import cuda_tail

        ref = cuda_tail.tail_q_plain(x, *ops, **{k: v for k, v in kw.items() if k != "packed"})
        diff = (y.float() - ref.float()).abs()
        bd = cuda_tail.BORDER
        inner = diff[:, bd:-bd, bd:-bd]
        atol, rtol = TOL_TAIL[str(y.dtype).split(".")[1]]
        key = (*x.shape, str(x.dtype))
        if (y.shape != ref.shape or (inner.numel() and inner.max().item() != 0.0)
                or not bool((diff <= atol + rtol * ref.float().abs()).all())):
            raise AssertionError(f"tail_q {key} in the forward: interior "
                                 f"{inner.max().item()}, border {diff.max().item()}")
        return key, diff.max().item()

    def __enter__(self):
        for name, (mod, _) in self.sites.items():
            setattr(mod, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, (mod, _) in self.sites.items():
            setattr(mod, name, self.real[name])

    def counts(self) -> dict:
        return {name: sum(r[0] for r in by.values()) for name, by in self.calls.items()}


def serve_a8_family(card: str, rng, name: str, cfg) -> int:
    """Phase 19a/b: one family built by ``model_from_config`` from ``cfg``
    served through ``InferenceEngine`` at batch 8 x 8 ROIs a image: the
    fused head (``conv_ln_act`` at every unit the gate admits, each call
    held against its plain version) against the same weights with it off,
    under phase 4's gates in float32 and bf16; the launches of a served
    forward equal to the gate's count; ms per bf16 forward of both paths in
    turns. Returns the launches per served forward."""
    import torch

    from human_instance_segmentation_tpu_torch.config import _as_hw, model_from_config
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine, pad_rois
    from human_instance_segmentation_tpu_torch.ops import cuda_head

    model = model_from_config(cfg, seed=0)
    hw = _as_hw(cfg.model.image_size)

    def engine(dtype, kernels: bool):
        return InferenceEngine(model, dilation_pixels=1, dtype=dtype, fused_head=kernels,
                               kernels=kernels)

    engines = {"served bf16": engine(torch.bfloat16, True),
               "plain bf16": engine(torch.bfloat16, False),
               "served f32": engine(torch.float32, True),
               "plain f32": engine(torch.float32, False)}
    images, rois = make_request(rng, A8_BATCH, A8_ROIS, hw)
    units = fused_units(engines["plain f32"].model,
                        lambda: _serve(engines["plain f32"], images, rois))
    per_forward = sum(u[-1] for u in units)
    tag = f"{name} ({type(model).__name__}) batch {A8_BATCH} x {A8_ROIS // A8_BATCH} rois a image"
    print(f"{tag}: the gate admits {len(units)} units, {per_forward} conv_ln_act launches a "
          f"forward: {sorted(set(units))} (Ci, Co, H, W, launches)"
          + ("; no unit of this family passes the gate (Ci, Co >= 256 at H x W <= 512), so "
             "its forward runs no fused kernel" if not units else ""))
    o = {}
    spy = ConvLnActSpy()
    with spy:
        for ename, e in engines.items():
            c0 = cuda_head.conv_ln_act.launches
            o[ename] = _serve(e, images, rois)
            dc = cuda_head.conv_ln_act.launches - c0
            want = per_forward if ename.startswith("served") else 0
            if dc != want:
                raise AssertionError(f"{tag} {ename}: {dc} conv_ln_act launches, expected {want}")
    spy.report(tag)
    mask = _as_hw(cfg.model.mask_size)
    if o["served bf16"][0].shape != (A8_ROIS, *mask, 1) or o["served bf16"][1] is not None:
        raise AssertionError(f"{tag}: bad outputs {o['served bf16'][0].shape}")
    _gates(tag, o)

    images_t = torch.as_tensor(images).to("cuda", torch.bfloat16)
    rois_t = torch.as_tensor(pad_rois(rois, A8_ROIS)).to("cuda")
    times = {"served": [], "plain": []}
    for path in ("served", "plain", "plain", "served"):
        e = engines[f"{path} bf16"]
        times[path].append(median_ms(lambda: e.forward(images_t, rois_t), reps=TIMING_REPS // 4))
    for path, ms in times.items():
        print(f"{tag}, bf16 forward, fused head {'on' if path == 'served' else 'off'}: "
              f"{statistics.median(ms):.3f} ms per forward (median of per-round medians {ms}, "
              f"{TIMING_REPS // 4} forwards each, CUDA events) [{card}]")
    del engines, model
    torch.cuda.empty_cache()
    return per_forward


def serve_head_variants(card: str, rng) -> dict:
    """Phase 19c: heads V1, V3 and V4 at mid 256 on (64, 28, 28, 256)
    features, mask 56 x 56, eval mode, the fused unit on against off in
    float32 and bf16 (every fused call held against ``conv_ln_act_plain``
    by shape), launches equal to the gate's count. Gates: float32 fused vs
    plain logits within 1e-2 and argmax agreement >= MIN_AGREE; bf16 fused
    no further from the float32 plain logits than twice the bf16 plain
    path's distance plus 1e-2. Returns the launches per forward by head."""
    import copy

    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.inference import init_weights
    from human_instance_segmentation_tpu_torch.models import heads
    from human_instance_segmentation_tpu_torch.models.blocks import set_head_fusion
    from human_instance_segmentation_tpu_torch.ops import cuda_head

    n, h, w, c = A8_HEAD_FEATS
    feats = torch.as_tensor(rng.standard_normal((n, c, h, w)).astype(np.float32)).cuda()
    out = {}
    for name, cls in (("V1", heads.HierarchicalHeadV1), ("V3", heads.HierarchicalHeadV3),
                      ("V4", heads.HierarchicalHeadV4)):
        m = cls(c, mid_channels=256, mask_size=(56, 56))
        init_weights(m, seed=5)
        models = {"float32": m.cuda().eval(), "bfloat16": copy.deepcopy(m).to(torch.bfloat16)}
        logits = {}
        units = None
        spy = ConvLnActSpy()
        for dtype, mod in models.items():
            x = feats.to(mod.shared_in.conv.weight.dtype)
            for fused in (True, False):
                set_head_fusion(mod, fused)
                c0 = cuda_head.conv_ln_act.launches
                with torch.inference_mode(), spy:
                    if units is None:
                        set_head_fusion(mod, False)
                        units = fused_units(mod, lambda: mod(x))
                        set_head_fusion(mod, fused)
                    logits[(dtype, fused)] = mod(x)[0].float()
                dc = cuda_head.conv_ln_act.launches - c0
                want = sum(u[-1] for u in units) if fused else 0
                if dc != want:
                    raise AssertionError(f"head {name} {dtype} fused={fused}: {dc} launches, "
                                         f"expected {want}")
        per_forward = sum(u[-1] for u in units)
        print(f"head {name}, mid 256, features {A8_HEAD_FEATS} (N, H, W, C), mask 56x56: the gate "
              f"admits {len(units)} units, {per_forward} conv_ln_act launches a forward: "
              f"{sorted(set(units))} (Ci, Co, H, W, launches)")
        spy.report(f"head {name}")
        ref = logits[("float32", False)]
        f32_err = float((logits[("float32", True)] - ref).abs().max())
        agree = float((logits[("float32", True)].argmax(1) == ref.argmax(1)).float().mean())
        k_err = float((logits[("bfloat16", True)] - ref).abs().max())
        p_err = float((logits[("bfloat16", False)] - ref).abs().max())
        print(f"head {name}: float32 fused vs plain logits max_abs_err {f32_err:.3e} (tol 1e-2), "
              f"argmax agreement {agree:.6f} (min {MIN_AGREE}); bf16 vs float32 plain logits "
              f"max_abs_err fused {k_err:.3e}, plain bf16 {p_err:.3e} (fused <= 2 x plain + "
              f"1e-2); max |logit| {float(ref.abs().max()):.3f}")
        if not (np.isfinite([f32_err, k_err, p_err]).all() and f32_err <= 1e-2
                and agree >= MIN_AGREE and k_err <= 2 * p_err + 1e-2):
            raise AssertionError(f"head {name}: the fused path is outside its gates")
        times = {True: [], False: []}
        x16 = feats.to(torch.bfloat16)
        mod = models["bfloat16"]
        for fused in (True, False, False, True):
            set_head_fusion(mod, fused)
            with torch.inference_mode():
                times[fused].append(median_ms(lambda: mod(x16), reps=TIMING_REPS // 4))
        print(f"head {name} bf16 forward, {n} rois: fused {statistics.median(times[True]):.3f} ms, "
              f"unfused {statistics.median(times[False]):.3f} ms (median of per-round medians "
              f"{times}, CUDA events) [{card}]")
        out[name] = per_forward
        del models, m, logits
        torch.cuda.empty_cache()
    return out


def train_multiscale_rgb(card: str) -> None:
    """Phase 19d: ``run_training`` on the multi-scale RGB config (640 x 640,
    batch 8 x 8 ROIs, bf16, synthetic), 5 steps: every step finite, none
    skipped, the checkpoint restored equal; then ms per step."""
    import shutil

    import torch

    from human_instance_segmentation_tpu_torch.config import (ConfigManager, _as_hw,
                                                              _deep_merge, model_from_config)
    from human_instance_segmentation_tpu_torch.training import steps as tsteps
    from human_instance_segmentation_tpu_torch.training.checkpoint import restore_checkpoint
    from human_instance_segmentation_tpu_torch.training.loop import (run_training,
                                                                    synthetic_batches)
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      constant_schedule)
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    cfg = _deep_merge(ConfigManager.get_config(A8_BASE), A8_MS_MODS)
    out = ROOT / "build" / "phase19d_run"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    metrics, state = run_training(A8_BASE, steps=A8_TRAIN_STEPS, synthetic=True,
                                  output_dir=str(out), config_modifications=A8_MS_MODS,
                                  return_state=True)
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for f in sorted((out / "logs").glob("*.jsonl"))
            for line in f.read_text().splitlines()]
    losses = [r["total_loss"] for r in rows if "total_loss" in r]
    print(f"run_training {A8_BASE} + multi_scale (roi sizes {cfg.model.roi_sizes}, "
          f"{cfg.model.fusion_method}), {A8_TRAIN_STEPS} steps, {cfg.training.compute_dtype}, "
          f"640x640, batch {cfg.training.batch_size} x {cfg.data.rois_per_image} rois: "
          f"{wall:.1f} s; logged losses {losses}, val mIoU {metrics.get('val_miou')}, skipped "
          f"{state.skipped} [{card}]")
    if state.skipped or state.step != A8_TRAIN_STEPS or not losses or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f"training went wrong: step {state.step}, skipped {state.skipped}")
    fresh = TrainState.create(model_from_config(cfg, seed=1),
                              build_optimizer(constant_schedule(0.0)), seed=2)
    fresh, step = restore_checkpoint(str(out / "checkpoints"), fresh)
    a, b = state.model.state_dict(), fresh.model.state_dict()
    same = (step == A8_TRAIN_STEPS and a.keys() == b.keys()
            and all(torch.equal(a[k], b[k]) for k in a)
            and all(torch.equal(state.optimizer.mu[k], fresh.optimizer.mu[k])
                    for k in state.optimizer.mu))
    print(f"checkpoint of step {step} restored into a fresh state: equal {same}")
    if not same:
        raise AssertionError("the restored state differs from the trained one")
    del fresh, a, b, state
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    gen = synthetic_batches(cfg.training.batch_size, cfg.data.rois_per_image,
                            _as_hw(cfg.model.image_size), _as_hw(cfg.model.mask_size), seed=11)
    batches = [tsteps.batch_to(next(gen), "cuda") for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    med, times, _ = _time_steps(model_from_config(cfg, seed=0), cfg, batches)
    n = cfg.training.batch_size
    print(f"train step multi-scale RGB, bf16, batch {n} x {cfg.data.rois_per_image} rois: "
          f"{med:.3f} ms/step, {n / med * 1e3:.1f} img/s (median of {len(times)} steps after 2 "
          f"of warmup, CUDA events; all {times}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    torch.cuda.empty_cache()


def _yolo_models(teacher_kernels: dict):
    """The B0 YOLO student and the B7 teacher with the kernel flags, and the
    same teacher weights without them (its forward reaches no hand
    kernel)."""
    import torch

    from human_instance_segmentation_tpu_torch.models.yolo_distill import (
        YOLOFeatureDistillStudent)
    from human_instance_segmentation_tpu_torch.training.distill import build_student_teacher
    from human_instance_segmentation_tpu_torch.training.distill_loop import DECODER

    kw = dict(device="cuda", decoder_channels=DECODER, student_cls=YOLOFeatureDistillStudent)
    student, teacher = build_student_teacher("b0", "b7", teacher_overrides=teacher_kernels, **kw)
    _, plain = build_student_teacher("tiny", "b7", **kw)
    a, b = teacher.state_dict(), plain.state_dict()
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("the two teachers do not hold the same weights")
    return student, teacher, plain


def _yolo_loss_and_grads(student, teacher, batch, delta=None):
    """One evaluation of the YOLO distillation loss (float32, T = 3) and
    the student's gradients (its statistics handed over, not written), and
    the teacher logits it saw as (B, H, W); ``delta(t)`` is added to the
    teacher logits when given."""
    import torch

    from human_instance_segmentation_tpu_torch.training import yolo_distill
    from human_instance_segmentation_tpu_torch.training.steps import batch_to

    seen = {}

    def hook(module, inputs, out):
        form, y = out
        if delta is not None:
            y = y + delta(y).to(y.dtype)
        seen["t"] = (y if form == "dense" else y[:, 0]).float()
        return form, y

    handle = teacher.register_forward_hook(hook)
    try:
        student.train()
        loss, _ = yolo_distill.make_yolo_loss_fn(student, teacher)(3.0, batch_to(batch, "cuda"))
        params = [p for n, p in student.named_parameters() if not n.startswith("encoder.")]
        grads = torch.autograd.grad(loss, params)
    finally:
        handle.remove()
    return float(loss.detach()), torch.cat([g.flatten() for g in grads]).detach(), seen["t"]


def yolo_distillation(card: str, teacher_kernels: dict) -> dict:
    """Phase 19e: ``run_yolo_feature_distillation`` (B0 student, B7 teacher
    with the fused tail and the admissible fused blocks, 640 x 640, batch
    4): 2 epochs x 4 steps on synthetic batches, and 1 epoch x 2 steps from
    a directory of 640 x 640 ``write_golden_fixture`` files. Gates: every
    step finite, the temperature 3 -> 1, the stage-1 launches equal to one
    teacher forward a step (validation runs the student only), the best
    checkpoint written; the teacher's float32 logits with the kernels within
    ``TOL_STAGE1_F32`` of the plain teacher's and the step's loss and
    gradients within twice that error's effect (phase 18b's rule); ms per
    step with the kernel teacher and the plain teacher in turns, each
    teacher's float32 forward alone, device busy time and idle share over
    profiled steps, peak memory. Returns the launches of the runs."""
    import shutil

    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.data.yolo_features import write_golden_fixture
    from human_instance_segmentation_tpu_torch.models.yolo_distill import (
        YOLOFeatureDistillStudent)
    from human_instance_segmentation_tpu_torch.training import yolo_distill
    from human_instance_segmentation_tpu_torch.training.distill import (build_student_teacher,
                                                                       unet_logits)
    from human_instance_segmentation_tpu_torch.training.distill_loop import DECODER
    from human_instance_segmentation_tpu_torch.training.state import TrainState
    from human_instance_segmentation_tpu_torch.training.steps import batch_to

    out = ROOT / "build" / "phase19e_run"
    shutil.rmtree(out, ignore_errors=True)
    counters = train_counters()
    n = teacher_kernels["encoder_fused_blocks"]
    per_step = {"mbconv_sums": n, "mbconv_apply": n, "tail": 1}
    fixtures = out / "fixtures"
    t0 = time.perf_counter()
    for i in range(2):
        write_golden_fixture(str(fixtures / f"dump{i}.npz"), batch=YOLO_BATCH, image_hw=(640, 640),
                             layers=("layer_34",), seed=i)
    print(f"two 640x640 golden fixtures of {YOLO_BATCH} images (layer_34 at 80x80x1024) written in "
          f"{time.perf_counter() - t0:.2f} s")
    total = {k: 0 for k in counters}
    for source, epochs, spe, kw in (("synthetic", YOLO_EPOCHS, YOLO_SPE, {}),
                                    ("fixtures", 1, 2, {"feature_dir": str(fixtures)})):
        for f in counters.values():
            f.launches = 0
        run_dir = out / source
        t0 = time.perf_counter()
        metrics, state = yolo_distill.run_yolo_feature_distillation(
            epochs=epochs, steps_per_epoch=spe, batch=YOLO_BATCH, output_dir=str(run_dir),
            teacher_overrides=teacher_kernels, return_state=True, **kw)
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        want = {k: v * epochs * spe for k, v in per_step.items()}
        rows = [json.loads(line) for f in sorted((run_dir / "logs").glob("*.jsonl"))
                for line in f.read_text().splitlines()]
        temps = [r["temperature"] for r in rows if "temperature" in r]
        want_t = [3.0, 1.0] if epochs == 2 else [1.0]
        metas = sorted((run_dir / "checkpoints").glob("metadata_*.json"))
        print(f"run_yolo_feature_distillation ({source}, B0 from B7, 640x640, batch {YOLO_BATCH}, "
              f"float32), {epochs} epochs x {spe} steps, teacher {teacher_kernels}: {wall:.1f} s; "
              f"losses by epoch {[r.get('total_loss') for r in rows]}, feature losses "
              f"{[r.get('feature_loss') for r in rows]}, temperatures {temps}, best student "
              f"mIoU {metrics['best_student_miou']:.4f}, checkpoints {[m.name for m in metas]}; "
              f"launches {launches} (expected {want}: {per_step} per step) [{card}]")
        if state.step != epochs * spe or not all(
                np.isfinite(r["total_loss"]) for r in rows if "total_loss" in r):
            raise AssertionError(f"YOLO distillation went wrong: step {state.step}, rows {rows}")
        if temps != want_t:
            raise AssertionError(f"temperatures {temps}, expected {want_t}")
        if launches != want:
            raise AssertionError(f"expected launches {want}, got {launches}")
        if metrics["best_student_miou"] > 0 and not metas:
            raise AssertionError("no checkpoint of the best student")
        for k, v in launches.items():
            total[k] += v
        del state
        torch.cuda.empty_cache()
    YOLO_PER_STEP.update(per_step)

    student, teacher, plain = _yolo_models(teacher_kernels)
    batches = [next(yolo_distill.synthetic_yolo_batches(YOLO_BATCH, (640, 640), seed=s))
               for s in (3, 4, 5)]
    lk, gk, xk = _yolo_loss_and_grads(student, teacher, batches[0])
    lp, gp, xp = _yolo_loss_and_grads(student, plain, batches[0])
    atol, rtol = TOL_STAGE1_F32
    x_err = (xk - xp).abs()
    x_ok = bool((x_err <= atol + rtol * xp.abs()).all())
    gen = torch.Generator(device="cuda").manual_seed(11)

    def shift(x):
        return atol + rtol * x.abs()

    def random_sign(x):
        s = torch.randint(0, 2, x.shape, generator=gen, device=x.device) * 2 - 1
        return s * (atol + rtol * x.abs())

    effects = [_yolo_loss_and_grads(student, plain, batches[0], d) for d in (shift, random_sign)]
    l_bound = 2 * max(abs(le - lp) for le, _, _ in effects)
    g_bound = 2 * max(float((ge - gp).norm()) for _, ge, _ in effects)
    l_err, g_err = abs(lk - lp), float((gk - gp).norm())
    print(f"YOLO step float32 (B0 from B7, batch {YOLO_BATCH}, 640x640), teacher kernels vs "
          f"plain: teacher logits max_abs_err {float(x_err.max()):.3e} (tol {atol} + {rtol} |x|, "
          f"max |x| {float(xp.abs().max()):.2f}); loss {lk:.7f} vs {lp:.7f}, |diff| {l_err:.3e} "
          f"(bound {l_bound:.3e}); student gradients outside the frozen encoder |diff| "
          f"{g_err:.3e} of |g| {float(gp.norm()):.3e} (bound {g_bound:.3e})")
    if not (x_ok and l_err <= l_bound and g_err <= g_bound):
        raise AssertionError("YOLO step: the kernel teacher is outside its bound")
    del effects, gk, gp

    runs = {}
    for name, tch in (("kernels", teacher), ("plain", plain)):
        s = student if name == "kernels" else build_student_teacher(
            "b0", "tiny", device="cuda", decoder_channels=DECODER,
            student_cls=YOLOFeatureDistillStudent)[0]
        step = yolo_distill.make_yolo_train_step(s, tch)
        runs[name] = [TrainState.create(s, yolo_distill.yolo_optimizer(s, 1e-3)),
                      lambda st, b, step=step: step(st, b, 3.0)]
    dev = [batch_to(b, "cuda") for b in batches]
    torch.cuda.reset_peak_memory_stats()
    med = _timed_steps(runs, dev)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    images = dev[0]["images"]
    for name, run in runs.items():
        tch = teacher if name == "kernels" else plain
        with torch.no_grad():
            t_ms = median_ms(lambda: unet_logits(tch, images), reps=10)
            t_ms5 = median_ms(lambda: unet_logits(tch, images), reps=5, calls=5)
        busy_sum, kernels, wall, busy, streams = _busy_ms(run, dev)
        print(f"YOLO step float32, B0 from B7 at 640x640, batch {YOLO_BATCH}, teacher {name}: "
              f"{med[name]:.3f} ms/step, {YOLO_BATCH / med[name] * 1e3:.1f} img/s (median of 10 "
              f"after 3 of warmup, CUDA events, the two teachers in turns); teacher float32 "
              f"forward alone {t_ms:.3f} ms one call, {t_ms5:.3f} five in a row "
              f"({100 * t_ms / med[name]:.1f}% of the step); profiled: {wall:.3f} ms wall, "
              f"{busy:.3f} ms device busy (union of kernel times; {busy_sum:.3f} summed, on "
              f"{streams} streams) per step, {100 * (1 - busy / wall):.1f}% idle, {kernels} "
              f"kernels per step [{card}]")
    print(f"  peak memory over both routes' timed steps {peak:.2f} GiB (max_memory_allocated)")
    del runs, student, teacher, plain
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def other_families(card: str, rng) -> dict:
    """Phase 19: a, b, c, d and e above, with the time each took. Returns
    the launches of the phase's main-path runs."""
    from human_instance_segmentation_tpu_torch.config import ConfigManager, _deep_merge

    t_phase = time.perf_counter()
    launches = {"conv_ln_act": 0}
    cfgs = (("multi-scale RGB", _deep_merge(ConfigManager.get_config(A8_BASE), A8_MS_MODS)),
            ("variable-ROI", _deep_merge(ConfigManager.get_config("baseline"), A8_VAR_MODS)),
            ("baseline", ConfigManager.get_config("baseline")))
    for name, cfg in cfgs:
        t0 = time.perf_counter()
        per_forward = serve_a8_family(card, rng, name, cfg)
        A8_PER_FORWARD[name] = per_forward
        launches["conv_ln_act"] += 2 * per_forward  # one served forward in f32, one in bf16
        print(f"phase 19 {name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, per_forward in serve_head_variants(card, rng).items():
        A8_PER_FORWARD[f"head {name}"] = per_forward
        launches["conv_ln_act"] += 2 * per_forward
    print(f"phase 19c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_multiscale_rgb(card)
    print(f"phase 19d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in yolo_distillation(card, distill_teacher_kernels()).items():
        launches[name] = launches.get(name, 0) + n
    print(f"phase 19e: {time.perf_counter() - t0:.1f} s")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


# ---------------------------------------------------------------------------
# Phase 20: data parallelism on the card (parallel/, the mesh steps, the mesh
# engine, ROI sharding, the dry run, the multi-process worker, int8 accuracy)
# ---------------------------------------------------------------------------

PHASE20_STEPS = 3
# 20c, float32 mesh serving against the single-device engine (ROADMAP C2):
# the binary masks within MESH_ATOL, JAX's dry-run tolerance. A rank runs
# stage 1 on its slice of the images and stage 2 on its slice of the ROI
# bucket, shapes at which cuDNN may sum in another order than at the whole
# request's. The witness (:func:`_shard_witness`) is the single-device
# model at the ranks' shapes, with ``torch.cat`` where the mesh gathers:
# the mesh's logits are held within MESH_ATOL of it, and within
# max(MESH_ATOL, 2 x its distance from the single-device engine) of the
# engine; the instance masks equal the engine's on every pixel that is not
# within that tolerance of a tie (:func:`_stable_pixels`)
MESH_ATOL = 1e-5
# serving requests of 20c: bench.py's shapes, one ROI an image at N = 32, and
# N = 6 (bucket 8, which 2 ranks divide while the batch shards too); N = 1
# (bucket 1) for the REPLICATED warning
PHASE20_REQUESTS = {"N=32": 32, "N=6": 6, "N=1": 1}
# launches of a kernel per rank step (20b) and per mesh-served forward on
# each rank (20c), as phase 20 saw them
DP_PER_RANK: dict = {}


def _dp_setup() -> None:
    """A rank's numerics as the main process sets them: TF32 off, and
    cuDNN's deterministic algorithms, so that two runs of one step on the
    same inputs compute the same bits."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _dp_model(dropout: bool = True):
    """Phase 14's config at 480 x 640 with both stage-1 kernels, seeded
    weights (the same on every rank), dropout off where asked."""
    from human_instance_segmentation_tpu_torch.config import (ConfigManager, _deep_merge,
                                                              model_from_config)
    from human_instance_segmentation_tpu_torch.models.blocks import Dropout2d

    cfg = _deep_merge(ConfigManager.get_config(TRAIN_CONFIG), TRAIN_MODS)
    model = model_from_config(cfg, seed=0, device="cuda", **TRAIN_KERNELS)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout2d):
                m.p = 0.0
    return cfg, model


def _dp_tx(cfg):
    from human_instance_segmentation_tpu_torch.training.optim import (build_optimizer,
                                                                      build_schedule)

    t = cfg.training
    return build_optimizer(build_schedule(t.learning_rate, t.num_epochs, 100, t.scheduler,
                                          t.min_lr, t.warmup_epochs),
                           t.optimizer, t.weight_decay, t.gradient_clip)


def _digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _run_steps(state, step, batches, counters=None):
    """Each batch through ``step``: losses, ms per step (CUDA events) and the
    kernels' launches per step."""
    import torch

    losses, ms, per_step = [], [], []
    for b in batches:
        c0 = {k: f.launches for k, f in (counters or {}).items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, b)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["total_loss"]))
        per_step.append({k: f.launches - c0[k] for k, f in (counters or {}).items()})
    return state, losses, ms, per_step


def dp_world_one_rank(rank: int) -> dict:
    """20a, in a rank of an NCCL group of one: the DP train step of phase
    14's model (bf16, batch 8 x 8 ROIs, dropout off) against the same step
    without a mesh from the same weights and batches, 3 steps each; then 5
    more steps of each in turns for the time."""
    import torch

    from human_instance_segmentation_tpu_torch.config import loss_config_from_experiment
    from human_instance_segmentation_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from human_instance_segmentation_tpu_torch.training import steps
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    _dp_setup()
    mesh = create_mesh(1, device="cuda")
    backend = torch.distributed.get_backend()
    batches = train_batches(PHASE20_STEPS, seed=7)
    out = {"backend": backend}
    runs = {}
    for name, m in (("mesh", mesh), ("no mesh", None)):
        # dropout off: under a mesh each rank draws its own stream (the JAX
        # step folds the axis index into its key), so at world size 1 the
        # masks are not the ones the step without a mesh draws
        cfg, model = _dp_model(dropout=False)
        state = TrainState.create(model, _dp_tx(cfg), seed=1)
        step = steps.make_train_step(model, loss_config_from_experiment(cfg),
                                     cfg.training.compute_dtype, m)
        feed = [shard_batch(mesh, b) if m is not None else steps.batch_to(b, "cuda")
                for b in batches]
        state, losses, ms, _ = _run_steps(state, step, feed)
        runs[name] = [state, step, feed, model]
        out[name] = {"losses": losses, "skipped": state.skipped, "dtype": cfg.training.compute_dtype}
    pm = dict(runs["mesh"][3].named_parameters())
    diffs = [float((p.detach().float() - pm[n].detach().float()).abs().max())
             for n, p in runs["no mesh"][3].named_parameters()]
    out["params_equal"] = all(torch.equal(p, pm[n])
                              for n, p in runs["no mesh"][3].named_parameters())
    out["params_max_abs"] = max(diffs)
    times = {name: [] for name in runs}
    for i in range(5):
        for name in (("mesh", "no mesh") if i % 2 == 0 else ("no mesh", "mesh")):
            r = runs[name]
            r[0], _, ms, _ = _run_steps(r[0], r[1], r[2][i % len(r[2]):][:1])
            times[name] += ms
    out["ms"] = times
    return out


def _capture_first_update():
    """Patch ``steps._apply_step``, for the rest of this rank's process, to
    keep the loss and the gradients of the first update it applies (after
    the mesh average)."""
    from human_instance_segmentation_tpu_torch.training import steps

    real = steps._apply_step
    seen = {}

    def apply(state, grads, new_loss_state, new_stats, loss):
        if not seen:
            seen["loss"] = float(loss)
            seen["grads"] = [None if g is None else g.detach().clone() for g in grads]
        return real(state, grads, new_loss_state, new_stats, loss)

    steps._apply_step = apply
    return seen


def _stage2_flat(model, grads):
    """The stage-2 gradients in ``_loss_and_grads``' order, flat."""
    import torch

    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    keep = [i for i, n in enumerate(names) if not n.startswith(("pretrained_unet.",
                                                                "unet_wrapper."))]
    return torch.cat([(grads[i] if grads[i] is not None else torch.zeros_like(params[names[i]]))
                      .flatten() for i in keep])


def dp_two_ranks_gloo(rank: int) -> dict:
    """20b, in each of two Gloo ranks sharing the card: 3 float32 DP steps
    of phase 14's model (dropout off) on the global batch 4 + 4; the first
    update's averaged loss and stage-2 gradients, the losses, the launches
    of the stage-1 kernels per rank step, ms per step, and a digest of the
    parameters after."""
    from human_instance_segmentation_tpu_torch.config import loss_config_from_experiment
    from human_instance_segmentation_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from human_instance_segmentation_tpu_torch.training import steps
    from human_instance_segmentation_tpu_torch.training.state import TrainState

    _dp_setup()
    mesh = create_mesh(2, device="cuda")
    cfg, model = _dp_model(dropout=False)
    state = TrainState.create(model, _dp_tx(cfg), seed=1)
    step = steps.make_train_step(model, loss_config_from_experiment(cfg), "float32", mesh)
    seen = _capture_first_update()
    counters = train_counters()
    feed = [shard_batch(mesh, b) for b in train_batches(PHASE20_STEPS, seed=7)]
    state, losses, ms, per_step = _run_steps(state, step, feed, counters)
    return {"losses": losses, "ms": ms, "per_step": per_step, "skipped": state.skipped,
            "digest": _digest(model), "loss0": seen["loss"],
            "grads0": _stage2_flat(model, seen["grads"]).cpu(),
            "shard": tuple(feed[0]["images"].shape)}


class _Warnings:
    """Collects the engine's warnings while installed."""

    def __enter__(self):
        import logging

        self.messages = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.messages.append(record.getMessage())

        self.handler = Handler(logging.WARNING)
        logging.getLogger("human_instance_segmentation_tpu_torch.inference").addHandler(
            self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("human_instance_segmentation_tpu_torch.inference").removeHandler(
            self.handler)
        return False


def _watch_shards():
    """Patch the crop launcher and the s8 fused unit to record the ROI count
    each call covers; returns the record and an undo."""
    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align

    seen = {"roi_align": [], "conv_ln_act_s8": []}
    real_launch, real_s8 = cuda_roi_align._launch, cuda_head.conv_ln_act_s8

    def launch(maps, rois, *a, **k):
        seen["roi_align"].append(int(rois.shape[0]))
        return real_launch(maps, rois, *a, **k)

    def s8(x, *a, **k):
        seen["conv_ln_act_s8"].append(int(x.shape[0]))
        return real_s8(x, *a, **k)

    s8.launches = real_s8.launches  # the wrapper counts on its module name while patched
    cuda_roi_align._launch, cuda_head.conv_ln_act_s8 = launch, s8

    def undo():
        real_s8.launches = s8.launches
        cuda_roi_align._launch, cuda_head.conv_ln_act_s8 = real_launch, real_s8

    return seen, undo


def _shard_witness(engine, images, rois, world: int = 2):
    """The single-device ``engine``'s float32 logits of a request computed
    at the shapes a mesh of ``world`` ranks computes them at, with no
    collective: stage 1 on each rank's slice of the images, concatenated
    where the mesh gathers, and stage 2 on each rank's slice of the ROI
    bucket (the whole bucket where ``world`` does not divide it), each
    slice through ``engine.forward``. Numpy logits of the real ROIs."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.inference import pad_rois, roi_bucket

    n = rois.shape[0]
    bucket = roi_bucket(n, max_bucket=engine.max_bucket)
    padded = torch.as_tensor(pad_rois(np.asarray(rois, np.float32), bucket)).to(engine.device)
    images_t = torch.as_tensor(images).to(engine.device, engine.dtype)
    model = engine.model

    def halves_forward(images_b, rois_b):
        per = images_b.shape[0] // world
        raw = [model.stage1_raw(images_b[r * per:(r + 1) * per]) for r in range(world)]
        x1 = torch.cat([x for _, x in raw])
        return (*model.from_stage1(images_b, raw[0][0], x1, rois_b), rois_b)

    parts = padded.chunk(world) if bucket % world == 0 else (padded,)
    engine._model_forward = halves_forward
    try:
        logits = torch.cat([engine.forward(images_t, part)[2] for part in parts])
    finally:
        del engine._model_forward
    return logits[:n].float().cpu().numpy()


def _stable_pixels(logits, tol: float, dilation: int = 1):
    """(N, mh, mw) bool: the instance pixels whose value no change of the
    float32 ``logits`` (N, mh, mw, 3) within ``tol`` can flip. Each
    probability moves by at most ``tol / 2`` and the dilation gap (dilated
    minus own target probability) by at most ``tol``, so a pixel is stable
    where its argmax margin after the dilation boost and its gap to the
    boost's 0.1 threshold both exceed ``2 tol``."""
    import torch

    from human_instance_segmentation_tpu_torch.models.postprocess import (
        mask_dilation_logit_boost)
    from human_instance_segmentation_tpu_torch.ops.morphology import dilate

    x = torch.as_tensor(logits, dtype=torch.float64)
    target = torch.softmax(x, dim=-1)[..., 1:2]
    gap = (dilate(target, dilation) - target - 0.1)[..., 0]
    boosted = mask_dilation_logit_boost(x, dilation)
    margin = boosted[..., 1] - torch.maximum(boosted[..., 0], boosted[..., 2])
    return ((margin.abs() > 2 * tol) & (gap.abs() > 2 * tol)).numpy()


def dp_mesh_serving(rank: int) -> dict:
    """20c, in each of two Gloo ranks sharing the card: bench.py's engine (B0,
    mid 128, ``fused_head``, dilation 1) given the mesh, in float32, bf16
    and int8, and int8 with ``pallas_tail`` (the s8 tail), at batch 32 x 32,
    32 x 6 and 32 x 1 ROIs; ``make_roi_sharded_infer`` at 32 x 6. Gates
    (module docstring, phase 20); returns what each rank saw."""
    import numpy as np
    import torch

    from human_instance_segmentation_tpu_torch.inference import (InferenceEngine,
                                                                 create_flagship,
                                                                 deployed_outputs, pad_rois)
    from human_instance_segmentation_tpu_torch.ops import cuda_head, cuda_roi_align, cuda_tail, quant
    from human_instance_segmentation_tpu_torch.parallel.mesh import create_mesh
    from human_instance_segmentation_tpu_torch.parallel.roi_sharding import (
        make_roi_sharded_infer, shard_rois)

    _dp_setup()
    mesh = create_mesh(2, device="cuda")
    rng = np.random.default_rng(20)
    requests = {k: make_request(rng, 32, n, IMAGE_HW) for k, n in PHASE20_REQUESTS.items()}

    def engine(dtype, kernels=True, on_mesh=True, quantize=None, scales=None, **kw):
        model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                                image_size=IMAGE_HW, mid_channels=128, seed=0,
                                pallas_roi_align=kernels, **kw)
        # int8: the fused unit in both paths, as phase 7's engines
        e = InferenceEngine(model, dilation_pixels=1, dtype=dtype,
                            fused_head=kernels or quantize is not None, quantize=quantize,
                            kernels=kernels, mesh=mesh if on_mesh else None)
        e.scales = dict(scales) if scales is not None else None
        return e

    out = {"rank": rank, "checks": []}
    f32_mesh, f32_one = engine(torch.float32), engine(torch.float32, on_mesh=False)
    bf16_mesh = engine(torch.bfloat16)
    # the plain path of the same graph on the same mesh: kernels and plain
    # versions see the same shard shapes
    plain = {"plain f32": engine(torch.float32, False),
             "plain bf16": engine(torch.bfloat16, False)}
    for key, (images, rois) in requests.items():
        with _Warnings() as w:
            o = {"served f32": _serve(f32_mesh, images, rois)}
            c0 = (cuda_head.conv_ln_act.launches, cuda_roi_align.roi_align.launches)
            o["served bf16"] = _serve(bf16_mesh, images, rois)
            d = (cuda_head.conv_ln_act.launches - c0[0], cuda_roi_align.roi_align.launches - c0[1])
        if d != (5, 1):
            raise AssertionError(f"rank {rank} {key}: bf16 mesh forward launched conv_ln_act and "
                                 f"roi_align {d} times, expected (5, 1)")
        if key == "N=32":
            DP_PER_RANK.update({"serve conv_ln_act": d[0], "serve roi_align": d[1]})
        one = _serve(f32_one, images, rois)
        witness = _shard_witness(f32_one, images, rois)
        reading = float(np.abs(witness - one[2]).max())
        tol = max(MESH_ATOL, 2 * reading)
        mesh_logits, mesh_inst = o["served f32"][2], o["served f32"][0][..., 0]
        witness_err = float(np.abs(mesh_logits - witness).max())
        logit_err = float(np.abs(mesh_logits - one[2]).max())
        bin_err = float(np.abs(o["served f32"][1] - one[1]).max())
        stable = _stable_pixels(one[2], tol)
        differ = mesh_inst != one[0][..., 0]
        flips_stable, flips = int(differ[stable].sum()), int(differ.sum())
        out["checks"].append(
            f"{key}: float32 mesh vs single-device engine: binary max_abs_err {bin_err:.3e} (atol "
            f"{MESH_ATOL}); logits vs the witness at the shard shapes {witness_err:.3e} (atol "
            f"{MESH_ATOL}), the witness vs the engine {reading:.3e}, the mesh vs the engine "
            f"{logit_err:.3e} (atol {tol:.3e}); instance pixels differing {flips} of "
            f"{differ.size}, {flips_stable} of the {int(stable.sum())} not within {tol:.3e} of a "
            f"tie (must be 0); warnings {sorted(set(w.messages))}")
        if not (bin_err <= MESH_ATOL and witness_err <= MESH_ATOL and logit_err <= tol
                and flips_stable == 0):
            raise AssertionError(f"rank {rank} {key}: the mesh engine disagrees with one device: "
                                 f"{out['checks'][-1]}")
        o.update({name: _serve(e, images, rois) for name, e in plain.items()})
        _gates(f"phase 20c rank {rank} {key} mesh vs plain", o)
        bucket = 1 if key == "N=1" else 32 if key == "N=32" else 8
        want = ["roi bucket"] if bucket % 2 else []
        if [m for m in ("batch=", "roi bucket") if any(m in x for x in w.messages)] != want:
            raise AssertionError(f"rank {rank} {key}: warnings {w.messages}, expected {want}")
    del f32_one, plain
    torch.cuda.empty_cache()

    # int8: calibrated on the mesh (the maximum over the ranks), held against
    # its plain path on the mesh with the same scales, as phase 7 holds it
    images, rois = requests["N=32"]
    int8_mesh = engine(torch.bfloat16, quantize="int8")
    int8_mesh.calibrate(images, rois)
    scales = int8_mesh.scales
    others = {"served f32": engine(torch.float32, quantize="int8", scales=scales),
              "plain f32": engine(torch.float32, False, quantize="int8", scales=scales),
              "plain bf16": engine(torch.bfloat16, False, quantize="int8", scales=scales)}
    counters = {"conv_ln_act_s8": cuda_head.conv_ln_act_s8, "roi_align": cuda_roi_align.roi_align,
                "qconv": quant.qconv2d, "tail_q": cuda_tail.tail_q}
    for key, (images, rois) in requests.items():
        seen, undo = _watch_shards()
        c0 = {k: f.launches for k, f in counters.items()}
        try:
            served = _serve(int8_mesh, images, rois)
        finally:
            undo()
        d = {k: f.launches - c0[k] for k, f in counters.items()}
        n_local = {"N=32": 16, "N=6": 4, "N=1": 1}[key]
        out["checks"].append(f"{key} int8 mesh forward on rank {rank}: launches {d}; ROIs a "
                             f"crop call {seen['roi_align']}, a conv_ln_act_s8 call "
                             f"{sorted(set(seen['conv_ln_act_s8']))} (this rank's shard "
                             f"{n_local})")
        if (d["conv_ln_act_s8"], d["roi_align"]) != (5, 1) or seen["roi_align"] != [n_local] \
                or set(seen["conv_ln_act_s8"]) != {n_local}:
            raise AssertionError(f"rank {rank} {key}: the kernels did not cover the shard: {d} "
                                 f"{seen}")
        if key == "N=32":
            DP_PER_RANK.update({f"serve {k}": v for k, v in d.items()})
        o = {"served bf16": served}
        o.update({name: _serve(e, images, rois) for name, e in others.items()})
        _gates(f"phase 20c rank {rank} {key} int8 mesh vs plain", o)
    del others
    torch.cuda.empty_cache()

    # int8 with the s8 tail on the mesh against the same engine on one device
    tail_mesh = engine(torch.bfloat16, quantize="int8", pallas_tail=True)
    tail_one = engine(torch.bfloat16, quantize="int8", pallas_tail=True, on_mesh=False)
    images, rois = requests["N=32"]
    tail_mesh.calibrate(images, rois)
    tail_one.scales = dict(tail_mesh.scales)
    c0 = cuda_tail.tail_q.launches
    a = _serve(tail_mesh, images, rois)
    d_tail = cuda_tail.tail_q.launches - c0
    b = _serve(tail_one, images, rois)
    agree = _agreement(a[0], b[0])
    bin_err = float(np.abs(a[1] - b[1]).max())
    out["checks"].append(f"int8 + pallas_tail mesh vs one device: tail_q launches {d_tail} a rank "
                         f"forward (16 images), instance agreement {agree:.6f}, binary max_abs_err "
                         f"{bin_err:.3e}")
    if d_tail != 1 or agree < MIN_AGREE or bin_err > 1e-2:
        raise AssertionError(f"rank {rank}: int8 + pallas_tail on the mesh: {out['checks'][-1]}")
    DP_PER_RANK["serve tail_q"] = d_tail
    del tail_mesh, tail_one

    # ROI sharding: the whole batch on every rank, stage 2 on a rank's 3 ROIs
    images, rois = requests["N=6"]
    model = create_flagship(variant="b0", roi_size=ROI_HW, mask_size=MASK_HW,
                            image_size=IMAGE_HW, mid_channels=128, seed=0)
    infer = make_roi_sharded_infer(model, mesh, dilation_pixels=1)
    local, n = shard_rois(mesh, rois)
    images_t = torch.as_tensor(images).cuda()
    inst, binary = infer(images_t, local)
    padded = torch.as_tensor(pad_rois(rois, inst.shape[0])).cuda()
    with torch.inference_mode():
        ref_inst, ref_bin = deployed_outputs(*model.eval()(images_t, padded), padded, 1)
    err_i = float((inst - ref_inst).abs().max())
    err_b = float((binary - ref_bin).abs().max())
    out["checks"].append(f"make_roi_sharded_infer 32 x 6 ROIs (padded to {inst.shape[0]}, "
                         f"{local.shape[0]} a rank): instance max_abs_err {err_i:.3e}, binary "
                         f"{err_b:.3e} against one device (atol 1e-5)")
    if inst.shape[0] != 6 or local.shape[0] != 3 or err_i > 1e-5 or err_b > 1e-5:
        raise AssertionError(f"rank {rank}: ROI sharding: {out['checks'][-1]}")
    out["per_rank"] = dict(DP_PER_RANK)
    return out


def _dp_reference(batch) -> dict:
    """20b's one-process reference: each half of the first global batch
    through the float32 loss and gradients in turn (``_loss_and_grads``),
    averaged, and phase 14b's bounds: twice the averaged effect of a
    stage-1 error at ``TOL_STAGE1_F32`` on the loss and the gradients."""
    import torch

    from human_instance_segmentation_tpu_torch.config import loss_config_from_experiment

    _dp_setup()
    cfg, model = _dp_model(dropout=False)
    loss_cfg = loss_config_from_experiment(cfg)
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in batch.items()} for i in range(2)]
    atol, rtol = TOL_STAGE1_F32
    gen = torch.Generator(device="cuda").manual_seed(11)

    def shift(x):
        return atol + rtol * x.abs()

    def random_sign(x):
        s = torch.randint(0, 2, x.shape, generator=gen, device=x.device) * 2 - 1
        return s * (atol + rtol * x.abs())

    def mean_of(delta):
        runs = [_loss_and_grads(model, loss_cfg, h, "float32", delta) for h in halves]
        return (runs[0][0] + runs[1][0]) / 2, (runs[0][1] + runs[1][1]) / 2

    loss, grads = mean_of(None)
    effects = [mean_of(d) for d in (shift, random_sign)]
    return {"loss": loss, "grads": grads.cpu(),
            "l_bound": 2 * max(abs(le - loss) for le, _ in effects),
            "g_bound": 2 * max(float((ge.cpu() - grads.cpu()).norm()) for _, ge in effects)}


def data_parallel(card: str) -> None:
    """Phase 20: (a) one NCCL rank against no mesh, bit for bit; (b) two Gloo
    ranks on the card against each other (bit for bit) and against the
    one-process reference (phase 14b's rule); (c) mesh serving and ROI
    sharding on two Gloo ranks; (d) the dry run, the multi-process worker
    twice and the int8 accuracy check on the card."""
    import os
    import statistics
    import subprocess

    import torch

    from human_instance_segmentation_tpu_torch import int8_accuracy
    from human_instance_segmentation_tpu_torch.parallel import dryrun, launch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    a = launch.spawn(dp_world_one_rank, 1, device="cuda", timeout=600)[0]
    print(f"phase 20a: DP train step at world size 1 over {a['backend']} vs no mesh, "
          f"{a['mesh']['dtype']}, batch 8 x 8 ROIs, {PHASE20_STEPS} steps: losses mesh "
          f"{a['mesh']['losses']} / no mesh {a['no mesh']['losses']}; parameters equal "
          f"{a['params_equal']} (max abs diff {a['params_max_abs']:.3e})")
    for name in ("mesh", "no mesh"):
        print(f"phase 20a {name}: {statistics.median(a['ms'][name]):.3f} ms a step (median of "
              f"{len(a['ms'][name])} in turns: {[round(v, 3) for v in a['ms'][name]]}) [{card}]")
    if a["backend"] != "nccl" or a["mesh"]["losses"] != a["no mesh"]["losses"] \
            or not a["params_equal"] or a["mesh"]["skipped"] or a["no mesh"]["skipped"]:
        raise AssertionError("phase 20a: world size 1 is not the step without a mesh bit for bit")
    print(f"phase 20a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    b = launch.spawn(dp_two_ranks_gloo, 2, device="cuda", backend="gloo", timeout=600)
    ref = _dp_reference(train_batches(1, seed=7)[0])
    l_err = abs(b[0]["loss0"] - ref["loss"])
    g_err = float((b[0]["grads0"] - ref["grads"]).norm())
    per_step = b[0]["per_step"]
    print(f"phase 20b: two Gloo ranks on one card, float32, shards {b[0]['shard']}: losses "
          f"{b[0]['losses']} / {b[1]['losses']}; parameters after {PHASE20_STEPS} steps equal "
          f"across ranks {b[0]['digest'] == b[1]['digest']}; launches per rank step "
          f"{per_step} (expected {TRAIN_PER_STEP})")
    print(f"phase 20b vs the one-process reference (each half in turn, averaged): loss "
          f"{b[0]['loss0']:.7f} vs {ref['loss']:.7f}, |diff| {l_err:.3e} (bound "
          f"{ref['l_bound']:.3e}); stage-2 gradients |diff| {g_err:.3e} of |g| "
          f"{float(ref['grads'].norm()):.3e} (bound {ref['g_bound']:.3e})")
    for r in b:
        print(f"phase 20b rank: ms a step {[round(v, 3) for v in r['ms']]} (the first with "
              f"warm-up) [{card}]")
    if b[0]["losses"] != b[1]["losses"] or b[0]["digest"] != b[1]["digest"] \
            or any(r["skipped"] for r in b):
        raise AssertionError("phase 20b: the ranks disagree")
    if any(s != TRAIN_PER_STEP for r in b for s in r["per_step"]):
        raise AssertionError(f"phase 20b: launches per rank step {[r['per_step'] for r in b]}")
    if not (l_err <= ref["l_bound"] and g_err <= ref["g_bound"]):
        raise AssertionError("phase 20b: outside phase 14b's bound against the reference")
    DP_PER_RANK.update({f"train {k}": v for k, v in TRAIN_PER_STEP.items()})
    del ref
    torch.cuda.empty_cache()
    print(f"phase 20b: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    c = launch.spawn(dp_mesh_serving, 2, device="cuda", backend="gloo", timeout=600)
    for r in c:
        for line in r["checks"]:
            print(f"phase 20c rank {r['rank']}: {line}")
    DP_PER_RANK.update(c[0]["per_rank"])
    print(f"phase 20c: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rep = dryrun.run_dryrun(2, device="cuda", backend="gloo", timeout=300)
    port = launch.free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # each worker writes to a file of its own: a worker blocked on a full
    # pipe would hold the other in a collective
    logs = [ROOT / "build" / f"phase20_multihost_{i}.log" for i in range(2)]
    logs[0].parent.mkdir(parents=True, exist_ok=True)
    files = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "human_instance_segmentation_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i),
         "--device", "cuda", "--backend", "gloo"], cwd=ROOT, env=env, stdout=f,
        stderr=subprocess.STDOUT) for i, f in enumerate(files)]
    deadline = time.monotonic() + 300
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    outs = [path.read_text() for path in logs]
    oks = [line for o in outs for line in o.splitlines() if line.startswith("MULTIHOST OK")]
    print(f"phase 20d: multihost worker twice on the card over Gloo: {oks}")
    losses = {line.split("loss=")[1].split()[0] for line in oks}
    if any(p.returncode for p in procs) or len(oks) != 2 or len(losses) != 1:
        raise AssertionError(f"phase 20d: multihost failed:\n{outs[0][-2000:]}\n{outs[1][-2000:]}")
    t1 = time.perf_counter()
    acc = int8_accuracy.main(device="cuda", verbose=False)
    print(f"phase 20d: int8_accuracy on the card ({time.perf_counter() - t1:.1f} s): target IoU "
          f"float32 {acc['f32']:.4f}, int8 {acc['int8']:.4f} ({acc['delta']:+.4f}), the "
          f"pallas_tail form float32 {acc['tail_f32']:.4f}, int8 (s8 tail) "
          f"{acc['tail_int8']:.4f} ({acc['tail_delta']:+.4f}); final train loss "
          f"{acc['train_loss']:.3f}; dry run loss {rep['losses'][0]:.4f} -> "
          f"{rep['losses'][-1]:.4f}, mean IoU {rep['mean_iou']:.4f}, serving agreement "
          f"{rep['serving_agreement']:.3f}")
    print(f"phase 20d: {time.perf_counter() - t0:.1f} s")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s [{card}]")


# LayerNorm2d chains (phase 21): the (C, H, W) of every LayerNorm2d a served
# forward normalises, by configuration, with the RoI bucket the benchmark's
# cells serve (b0.batch32.coco: 124 RoIs -> 128; b7.crowdhuman2: 45 -> 64;
# b1.batch8.coco: 31 -> 32)
LN_SHAPES = {
    "b0": (128, [(32, 128, 96), (48, 64, 48), (64, 64, 48), (96, 32, 24), (96, 64, 48),
                 (128, 64, 48), (128, 128, 96), (192, 16, 12), (192, 32, 24), (256, 64, 48),
                 (384, 16, 12)]),
    "b7": (64, [(32, 256, 192), (48, 128, 96), (64, 128, 96), (96, 64, 48), (96, 128, 96),
                (128, 128, 96), (128, 256, 192), (192, 32, 24), (192, 64, 48), (256, 128, 96),
                (384, 32, 24)]),
    "b1": (32, [(32, 160, 120), (64, 80, 60), (128, 40, 30), (128, 80, 60), (128, 160, 120),
                (256, 20, 15), (256, 40, 30), (256, 80, 60), (512, 10, 7), (512, 20, 15),
                (1024, 10, 7)]),
}
# The flagships the three cells serve, by configuration: (the configuration
# file under port_bench/configs, images and RoIs a request, ln_act calls a
# forward)
LN_SERVED = {"b0": ("b0_480x640_int8", 32, 124, 52),
             "b7": ("b7_ultra_480x640_int8", 2, 45, 57),
             "b1": ("b1_enhanced_480x640_int8", 8, 31, 50)}
# ln_act against ln_act_plain. Their statistics differ only in the order of
# the float32 sums, so a normalised value rounds differently only where it
# lies within ~1e-7 of a rounding boundary; one such flip moves the output
# by about one ulp of the largest term the chain rounds (|y * g|, |b|, the
# residual), which a sum that cancels can leave far above the output's own
# ulp (and an error of the mean moves a value near the mean by that error,
# relative to |mean|, not to the value: see _ln_scale). So: bf16 within 2
# bf16 ulps of that term, under 0.1% of values differing; int8 codes within
# 1, under 0.1% differing; float32 within 1e-5 of that term (every value
# may differ in its last bits); the mean within 1e-6 of the sample's
# standard deviation and the variance within 1e-6 relative of float64.
LN_BF16_ULPS = 2
LN_MAX_SHARE = 1e-3
LN_F32_RTOL = 1e-5
LN_STATS_RTOL = 1e-6


def served_flagship(config: str):
    """The flagship a benchmark configuration serves, built on the card from
    the model keywords of ``port_bench/configs/<config>.json`` with seeded
    weights (seed 0)."""
    from human_instance_segmentation_tpu_torch.inference import create_flagship

    kw = dict(json.loads((ROOT / "port_bench" / "configs" / f"{config}.json").read_text())["model"])
    variant = kw.pop("encoder_variant")
    for key in ("roi_size", "mask_size", "image_size"):
        kw[key] = tuple(kw[key])
    return create_flagship(variant=variant, seed=0, device="cuda", **kw)


def _ln_operands(n, shape, dtype, dev, seed, channels_last=True):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[0]
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = (torch.randn((n, *shape), generator=g, device=dev) * 2.0 + 0.5).to(dtype)
    res = torch.randn((n, *shape), generator=g, device=dev).to(dtype)
    x, res = x.contiguous(memory_format=fmt), res.contiguous(memory_format=fmt)
    gamma = (1.0 + 0.2 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
    return x, res, gamma, beta


def _ln_scale(x, gamma, beta, res):
    """The largest magnitude the plain chain's steps handle, value by value,
    in output units: (|x| + |mean|) * rstd * |g| + |b| (+ |residual|), in
    float32. A step's rounding, and the statistics' own, err relative to it:
    an error of the mean relative to |mean| moves a value near the mean by
    that much times rstd * |g|, whatever the value itself."""
    import torch

    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=(1, 2, 3), keepdim=True) + 1e-5)
    s = (xf.abs() + mean.abs()) * rstd * gamma.float().abs()[:, None, None]
    s = s + beta.float().abs()[:, None, None]
    return s if res is None else s + res.float().abs()


def _bf16_ulp(v):
    import torch

    e = torch.floor(torch.log2(v.clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def ln_compare(got, ref, scale) -> dict:
    """Kernel against plain: the largest difference (in bf16 ulps of the
    largest term, in codes, or relative to that term) and the share of
    values that differ; raises where a tolerance is passed."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape or got.stride() != ref.stride():
        raise AssertionError(f"ln_act: {got.dtype} {tuple(got.stride())} against "
                             f"{ref.dtype} {tuple(ref.stride())}")
    diff = (got.float() - ref.float()).abs()
    share = (diff > 0).float().mean().item()
    if got.dtype == torch.int8:
        worst, ok = diff.max().item(), diff.max().item() <= 1
    elif got.dtype == torch.bfloat16:
        worst = (diff / _bf16_ulp(torch.maximum(scale, ref.float().abs()))).max().item()
        ok = worst <= LN_BF16_ULPS
    else:
        worst = (diff / torch.maximum(scale, ref.float().abs()).clamp_min(1e-30)).max().item()
        ok = worst <= LN_F32_RTOL
    if not ok or (got.dtype != torch.float32 and share >= LN_MAX_SHARE):
        raise AssertionError(f"ln_act {got.dtype} {tuple(got.shape)}: worst {worst}, "
                             f"{share:.2e} of values differ")
    return {"worst": worst, "share": share}


def ln_stats_check(x, stats) -> float:
    """The kernel's mean and variance against float64: the worst of |mean
    error| / std and |variance error| / variance over the samples."""
    import torch

    x64 = x.double().reshape(x.shape[0], -1)
    mean = x64.mean(dim=1)
    var = (x64 - mean[:, None]).square().mean(dim=1)
    e_mean = ((stats[:, 0].double() - mean).abs() / var.sqrt()).max().item()
    e_var = ((stats[:, 1].double() - var).abs() / var).max().item()
    if max(e_mean, e_var) > LN_STATS_RTOL:
        raise AssertionError(f"ln_act statistics: mean {e_mean:.2e}, variance {e_var:.2e}")
    return max(e_mean, e_var)


def check_ln_kernel(card: str) -> dict:
    """(a) the kernel pair against ln_act_plain at every served shape of both
    configurations at their buckets: bf16 and float32, with and without a
    residual, x's dtype and int8 out (ReLU; the identity on the small
    shapes), channels-last as served; the statistics against float64; the
    scalar form (NCHW, ragged C, x off 16 bytes) and a residual in another
    layout, at ragged shapes. In every case, too, the kernels' statistics
    against ln_stats_plain and their output against their twin (ln_act
    inside plain()), bit for bit. Returns the worst readings."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import _build, cuda_norm

    def twin_equal(got, x, gamma, beta, r, relu, qscale, stats=None):
        """The kernels' output (and statistics) against the twin's, exactly."""
        if stats is not None and not torch.equal(stats, cuda_norm.ln_stats_plain(x, gamma, beta,
                                                                                 r)):
            raise AssertionError(f"ln_act {tuple(x.shape)}: statistics differ from "
                                 "ln_stats_plain")
        with _build.plain():
            twin = cuda_norm.ln_act(x, gamma, beta, 1e-5, r, relu, qscale)
        if not torch.equal(got, twin):
            raise AssertionError(f"ln_act {tuple(x.shape)} {x.dtype}: output differs from its "
                                 "twin")

    dev = torch.device("cuda")
    worst = {"bf16_ulps": 0.0, "bf16_share": 0.0, "int8_codes": 0.0, "int8_share": 0.0,
             "f32_rel": 0.0, "stats_rel": 0.0}
    checked = 0
    for cfg, (n, shapes) in LN_SHAPES.items():
        for i, shape in enumerate(shapes):
            for dtype in (torch.bfloat16, torch.float32):
                x, res, gamma, beta = _ln_operands(n, shape, dtype, dev, seed=17 * i + 1)
                small = x.numel() < 50e6
                for residual, int8, relu in [(r, q, True) for r in (False, True)
                                             for q in (False, True)] + (
                        [(True, False, False)] if small else []):
                    r = res if residual else None
                    qscale = 4.0 / 127 if int8 else None
                    stats = torch.empty((n, 2), dtype=torch.float32, device=dev)
                    got = cuda_norm.ln_act(x, gamma, beta, 1e-5, r, relu, qscale, stats=stats)
                    if not cuda_norm.ln_act.last_vec:
                        raise AssertionError(f"{cfg} {shape}: the served layout took the "
                                             "scalar form")
                    twin_equal(got, x, gamma, beta, r, relu, qscale, stats)
                    ref = cuda_norm.ln_act_plain(x, gamma, beta, 1e-5, r, relu, qscale)
                    o = ln_compare(got, ref, _ln_scale(x, gamma, beta, r))
                    if int8:
                        worst["int8_codes"] = max(worst["int8_codes"], o["worst"])
                        worst["int8_share"] = max(worst["int8_share"], o["share"])
                    elif dtype == torch.bfloat16:
                        worst["bf16_ulps"] = max(worst["bf16_ulps"], o["worst"])
                        worst["bf16_share"] = max(worst["bf16_share"], o["share"])
                    else:
                        worst["f32_rel"] = max(worst["f32_rel"], o["worst"])
                    if not residual and not int8:
                        worst["stats_rel"] = max(worst["stats_rel"], ln_stats_check(x, stats))
                    checked += 1
                    del got, ref
                del x, res
            torch.cuda.empty_cache()
    # the other forms, at ragged and small shapes
    forms = set()
    for shape, cl, res_cl, offset in [((16, 12, 8), False, False, 0),   # NCHW: scalar
                                      ((7, 5, 3), True, True, 0),       # C % 8: scalar
                                      ((7, 5, 3), False, False, 0),
                                      ((64, 16, 12), True, False, 0),   # residual's own strides
                                      ((64, 16, 12), True, True, 1)]:   # x off 16 bytes: scalar
        for dtype in (torch.bfloat16, torch.float32):
            x, res, gamma, beta = _ln_operands(3, shape, dtype, dev, seed=5, channels_last=cl)
            if not res_cl:
                res = res.contiguous()
            if offset:
                flat = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
                x = flat[offset:].view(x.shape).copy_(x)
            fmt = torch.channels_last if cl and not offset else torch.contiguous_format
            for int8 in (False, True):
                qscale = 4.0 / 127 if int8 else None
                stats = torch.empty((3, 2), dtype=torch.float32, device=dev)
                got = cuda_norm.ln_act(x, gamma, beta, 1e-5, res, True, qscale, stats=stats)
                forms.add(cuda_norm.ln_act.last_vec)
                if got.stride() != x.stride():
                    raise AssertionError(f"ln_act {shape}: x's layout not kept")
                twin_equal(got, x, gamma, beta, res, True, qscale, stats)
                # the plain chain's layout follows x and the residual together
                ref = cuda_norm.ln_act_plain(x, gamma, beta, 1e-5, res, True, qscale)
                ln_compare(got, ref.contiguous(memory_format=fmt), _ln_scale(x, gamma, beta, res))
                checked += 1
    if forms != {True, False}:
        raise AssertionError(f"the ragged cases took the forms {forms}, not both")
    torch.cuda.synchronize()
    print(f"21a ln_act against ln_act_plain, {checked} cases (every served shape of B0 at 128, "
          f"B7 at 64 and B1 at 32 RoIs, bf16 and float32, residual, int8, ragged forms): worst bf16 "
          f"{worst['bf16_ulps']:.3g} ulps of the largest term ({worst['bf16_share']:.2e} of "
          f"values differ), int8 {worst['int8_codes']:.0f} codes ({worst['int8_share']:.2e}), "
          f"float32 {worst['f32_rel']:.3g}, statistics {worst['stats_rel']:.3g} of float64; "
          f"statistics and outputs equal to ln_stats_plain and the twin bit for bit in all "
          f"{checked} [{card}]")
    return worst


def time_ln_kernel(card: str) -> list:
    """(b) the kernel pair's device time at the largest served shapes against
    its byte bound and the plain chain, in its three served uses: norm ->
    ReLU (ConvNormAct), norm -> + residual -> ReLU (ResidualBlock's norm2),
    norm -> ReLU -> int8 (norm1). Returns chip_smoke's kernel entries."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_norm

    dev = torch.device("cuda")
    rows = []
    for n, shape in [(64, (256, 128, 96)), (64, (128, 256, 192))]:
        x, res, gamma, beta = _ln_operands(n, shape, torch.bfloat16, dev, seed=3)
        e = x.numel()
        for use, r, q in [("relu", None, None), ("residual", res, None), ("int8", None, 4.0 / 127)]:
            out_bytes = e if q is not None else 2 * e
            nbytes = 2 * e + out_bytes + (2 * e if r is not None else 0)  # each byte once
            two_pass = nbytes + 2 * e  # the statistics' read of x besides
            kern = median_ms(lambda: cuda_norm.ln_act(x, gamma, beta, 1e-5, r, True, q),
                             calls=10)
            plain = median_ms(lambda: cuda_norm.ln_act_plain(x, gamma, beta, 1e-5, r, True, q),
                              reps=5, calls=3)
            split = device_ms_by_kernel(lambda: cuda_norm.ln_act(x, gamma, beta, 1e-5, r, True,
                                                                 q))
            b = bound(nbytes, 10 * e, "f32")
            rows.append({"name": "ln_act", "shape": f"{n}x{'x'.join(map(str, shape))}",
                         "use": use, "ms": kern, "plain_ms": plain, **b,
                         "two_pass_ms": two_pass / HBM_BYTES_PER_S * 1e3,
                         "device_ms": {k: round(v, 4) for k, v in split.items()}})
            print(f"21b ln_act {n} x {shape} {use}: {kern:.4f} ms (stats + apply "
                  f"{', '.join(f'{k} {v:.4f}' for k, v in split.items())}), bound "
                  f"{b['bound_ms']:.4f} ms by bytes ({b['bound_ms'] / kern:.1%}; two-pass "
                  f"floor {two_pass / HBM_BYTES_PER_S * 1e3:.4f}), plain chain {plain:.4f} ms "
                  f"({plain / kern:.1f}x) [{card}]")
        del x, res
        torch.cuda.empty_cache()
    return rows


def served_ln_forwards(card: str, rng) -> dict:
    """(c) each cell's flagship served once (bf16, int8, fused head) at its
    request shape: ln_act calls a forward (B0 52, the fused unit taking the
    five bottleneck units; B7 57; B1 50, among them the int8 outputs at
    20 x 15 x 512 and 10 x 7 x 1024 that feed the three pre-quantized
    ConvNormActs), every call held against ln_act_plain on
    that forward's own operands, and forward device time with the kernel
    route against the plain chain (the route switched off), alternating.
    Returns the calls a forward by configuration."""
    import torch

    from human_instance_segmentation_tpu_torch.inference import (InferenceEngine, pad_rois,
                                                                 roi_bucket)
    from human_instance_segmentation_tpu_torch.ops import cuda_norm

    engages = cuda_norm.engages

    def never(*args):  # the plain chain's turns: norm_act runs the modules' own chain
        return False

    per_forward = {}
    for cfg, (config, b, nrois, want) in LN_SERVED.items():
        model = served_flagship(config)
        engine = InferenceEngine(model, dilation_pixels=1, dtype=torch.bfloat16, fused_head=True,
                                 quantize="int8")
        del model
        images, rois = make_request(rng, b, nrois, IMAGE_HW)
        engine(images, rois)  # calibrates, then serves
        real = cuda_norm.ln_act
        seen = {"calls": 0, "int8": 0, "residual": 0, "worst_bf16": 0.0, "worst_int8": 0.0}

        def checked(x, weight, bias, eps=1e-5, residual=None, relu=True, qscale=None, **kw):
            y = real(x, weight, bias, eps, residual, relu, qscale, **kw)
            ref = cuda_norm.ln_act_plain(x, weight, bias, eps, residual, relu, qscale)
            o = ln_compare(y, ref, _ln_scale(x, weight, bias, residual))
            seen["calls"] += 1
            seen["int8"] += qscale is not None
            seen["residual"] += residual is not None
            key = "worst_int8" if qscale is not None else "worst_bf16"
            seen[key] = max(seen[key], o["worst"])
            return y

        checked.launches = 0  # the wrapper counts under its module name, patched here
        cuda_norm.ln_act = checked
        try:
            with served_eagerly(engine):  # the check reads values back to the host
                engine(images, rois)
        finally:
            cuda_norm.ln_act = real
        torch.cuda.synchronize()
        launched = checked.launches
        if seen["calls"] != want or launched != want:
            raise AssertionError(f"{cfg}: {seen['calls']} ln_act calls a forward, not {want}")
        bucket = roi_bucket(nrois, max_bucket=engine.max_bucket)
        images_t = torch.as_tensor(images).to("cuda", torch.bfloat16)
        rois_t = torch.as_tensor(pad_rois(rois, bucket)).to("cuda")
        counts = []
        times = {"kernel": [], "plain": []}
        try:
            for turn in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
                cuda_norm.engages = engages if turn == "kernel" else never
                c0 = real.launches
                times[turn].append(median_ms(lambda: engine.forward(images_t, rois_t), reps=3,
                                             warmup=1))
                if turn == "kernel":
                    counts.append((real.launches - c0) / 4)
        finally:
            cuda_norm.engages = engages
        per_forward[cfg] = want
        print(f"21c {cfg} served ({b} images, {nrois} RoIs, bucket {bucket}): {seen['calls']} "
              f"ln_act calls a forward ({seen['int8']} int8 out, {seen['residual']} with a "
              f"residual; launches counted {launched} in the checked forward, "
              f"{counts} a timed one), each held to ln_act_plain on its operands (worst bf16 "
              f"{seen['worst_bf16']:.3g} ulps, int8 {seen['worst_int8']:.0f} codes); forward ms "
              f"kernel {[round(t, 2) for t in times['kernel']]} against plain chain "
              f"{[round(t, 2) for t in times['plain']]} [{card}]")
        del engine, images_t, rois_t
        torch.cuda.empty_cache()
    return per_forward


def layernorm_chains(card: str, rng) -> list:
    """Phase 21: the LayerNorm2d kernel pair (``ops/cuda_norm.ln_act``)."""
    worst = check_ln_kernel(card)
    rows = time_ln_kernel(card)
    PER_FORWARD["ln_act"] = served_ln_forwards(card, rng)
    entry = dict(rows[-1])  # the largest served shape, norm -> ReLU -> int8
    entry.update({"max_abs_err": worst, "timings": rows})
    return [entry]


# the fused unit's shapes in the B1 enhanced head (base 128, depth 4, RoI
# 80 x 60: levels 80 x 60, 40 x 30, 20 x 15 and 10 x 7), (H, W, Ci, Co),
# with the calls a forward makes at each (a ResidualBlock two, with the
# residual on the second; a ConvNormAct one). In int8 serving the three
# ConvNormActs whose input their producer quantized (enc2_out, enc3_out,
# dec0_in) take the int8 QConv path instead, by the fused gate's rule for a
# pre-quantized boundary (the JAX package's models/blocks.py:29).
B1_UNIT_CALLS = {(20, 15, 256, 256): 4, (20, 15, 256, 512): 1, (20, 15, 512, 512): 4,
                 (20, 15, 1024, 512): 1, (10, 7, 512, 512): 4, (10, 7, 512, 1024): 1,
                 (10, 7, 1024, 1024): 5}
B1_PREQUANTIZED = {"enc2_out": (20, 15, 256, 512), "enc3_out": (10, 7, 512, 1024),
                   "dec0_in": (20, 15, 1024, 512)}
B1_UNIT_CALLS_INT8 = {k: v for k, v in B1_UNIT_CALLS.items()
                      if k not in B1_PREQUANTIZED.values()}
B1_CONFIG = "b1_enhanced_480x640_int8"


def b1_unit_shapes(card: str, rng, n: int = 32) -> list:
    """(a) conv_ln_act at the shapes of ``B1_UNIT_CALLS``, k = 3, n RoIs, bf16 activations,
    bf16 and int8 forms (the residual where Ci == Co, as a ResidualBlock's
    second conv): each against ``conv_ln_act_plain`` within ``TOL_CONV``,
    timed with its operands prepared once against its bound (x, residual,
    output and weights once; the conv's operations at the peak of its
    type). Returns a row a shape and form."""
    import torch

    from human_instance_segmentation_tpu_torch.ops import cuda_head

    dev = torch.device("cuda")
    rows = []
    for h, w, ci, co in B1_UNIT_CALLS:
        x = torch.tensor(rng.standard_normal((n, h, w, ci)), dtype=torch.bfloat16, device=dev)
        wt = torch.tensor(rng.standard_normal((3, 3, ci, co)) / (9 * ci) ** 0.5,
                          dtype=torch.bfloat16, device=dev)
        b = torch.tensor(rng.standard_normal(co) * 0.1, dtype=torch.float32, device=dev)
        g = torch.tensor(1 + rng.standard_normal(co) * 0.2, dtype=torch.float32, device=dev)
        be = torch.tensor(rng.standard_normal(co) * 0.1, dtype=torch.float32, device=dev)
        r = (torch.tensor(rng.standard_normal((n, h, w, co)), dtype=torch.bfloat16, device=dev)
             if ci == co else None)
        xs = float(x.float().abs().max()) / 127.0 * 0.9
        px = n * h * w
        for kind in ("bf16", "int8"):
            q = xs if kind == "int8" else None
            ops = (cuda_head.prepare_s8(wt, xs, b, g, be) if q is not None
                   else cuda_head.prepare_bf16(wt, b, g, be))

            def fused():
                return cuda_head.conv_ln_act(x, wt, b, g, be, r, height=h, width=w, xscale=q,
                                             prepared=ops)

            got = fused()
            torch.cuda.synchronize()
            ref = cuda_head.conv_ln_act_plain(x, wt, b, g, be, r, xscale=q)
            diff = (got.float() - ref.float()).abs()
            err = diff.max().item()
            atol, rtol = TOL_CONV["bfloat16"]
            if not (bool((diff <= atol + rtol * ref.float().abs()).all())
                    and torch.isfinite(got.float()).all()):
                raise AssertionError(f"22a conv_ln_act {kind} {(n, h, w, ci)}->{co}: {err}")
            kms = median_ms(fused)
            kms10 = median_ms(fused, calls=10)
            split = device_ms_by_kernel(fused)
            nbytes = (2 * px * ci + 2 * px * co * (2 if r is not None else 1)
                      + 9 * ci * co * (1 if q is not None else 2) + 3 * co * 4)
            bd = bound(nbytes, 2 * 9 * ci * co * px + 10 * px * co, kind)
            rows.append({"shape": f"{n}x{h}x{w}x{ci}->{co}", "kind": kind, "max_abs_err": err,
                         "ms": kms, "ms_10": kms10, **bd,
                         "device_ms": {k_: round(v, 4) for k_, v in split.items()}})
            print(f"22a conv_ln_act {kind} {n}x{h}x{w}x{ci}->{co} k=3 residual={r is not None}: "
                  f"max_abs_err={err:.3e} (TOL_CONV); {kms:.4f} ms one call, {kms10:.4f} ten in "
                  f"a row, device {sum(split.values()):.4f} "
                  f"{ {k_: round(v, 4) for k_, v in split.items()} }; bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bound_ms'] / kms10:.1%} "
                  f"of ten in a row) [{card}]")
            del ops, got, ref, diff
        del x, wt, r
        torch.cuda.empty_cache()
    return rows


def b1_served(card: str, rng, batch: int = 8, nrois: int = 31) -> dict:
    """(b) the B1 enhanced flagship (``port_bench/configs/b1_enhanced_480x640_int8.json``)
    served with the fused head in bf16 activations: without quantization
    every conv_ln_act call of a forward held against its plain version and
    counted by shape (all seven shapes, 20 calls); in int8 (the benchmark
    configuration's switches) every conv_ln_act_s8 call held against its
    plain version and counted by shape (17 calls: four shapes), the three
    pre-quantized ConvNormActs' QConvs fed int8, every int8 QConv exact
    (:func:`check_int8_calls`), and the same forward's six fused MBConv
    blocks, its crop pair at 80 x 60 and its int8 tail each held against
    their plain versions (:class:`StageKernelSpy`; the ln_act calls are phase
    21c's); then the spans' ``unet_skip_resizes`` and launch counters of a
    request, and forward times. Returns the launches a forward by kernel
    family (int8)."""
    import torch

    from human_instance_segmentation_tpu_torch import tracing
    from human_instance_segmentation_tpu_torch.inference import (InferenceEngine, pad_rois,
                                                                 roi_bucket)

    model = served_flagship(B1_CONFIG)
    images, rois = make_request(rng, batch, nrois, IMAGE_HW)
    bf16 = InferenceEngine(model, dilation_pixels=1, dtype=torch.bfloat16, fused_head=True)
    with ConvLnActSpy() as spy:
        bf16(images, rois)
    spy.report("22b B1 bf16")
    by_shape = {(*map(int, hw.split("x")), ci, co): r["calls"]
                for (ci, co, hw, _, _), r in spy.shapes.items()}
    if by_shape != B1_UNIT_CALLS:
        raise AssertionError(f"22b B1 bf16: fused unit calls by shape {by_shape}, want "
                             f"{B1_UNIT_CALLS}")
    del bf16
    engine = InferenceEngine(model, dilation_pixels=1, dtype=torch.bfloat16, fused_head=True,
                             quantize="int8")
    del model
    engine(images, rois)  # calibrates, then serves
    fed: dict = {}
    unet = engine.model.head.base_head.bg_vs_fg_unet
    hooks = [getattr(unet, name).conv.register_forward_pre_hook(
        lambda m, args, name=name: fed.__setitem__(name, (args[0].dtype, tuple(args[0].shape))))
        for name in B1_PREQUANTIZED]
    try:
        with StageKernelSpy() as stage:
            calls = check_int8_calls(engine, images, rois)
    finally:
        for hk in hooks:
            hk.remove()
    shapes = calls["s8_shapes"]
    if (shapes != B1_UNIT_CALLS_INT8
            or calls["conv_ln_act_s8"][0] != sum(B1_UNIT_CALLS_INT8.values())
            or any(dt != torch.int8 for dt, _ in fed.values()) or len(fed) != 3):
        raise AssertionError(f"22b B1 int8: fused unit calls by shape {shapes}, checked "
                             f"{calls['conv_ln_act_s8']}, want {B1_UNIT_CALLS_INT8}; "
                             f"pre-quantized inputs {fed}")
    fused_blocks = engine.model.pretrained_unet.encoder.fused_blocks
    want = {"fused_mbconv": fused_blocks, "roi_align_pair": 1, "tail_q": 1}
    if stage.counts() != want:
        raise AssertionError(f"22b B1 int8: stage kernel calls {stage.calls}, want {want}")
    for name, by in stage.calls.items():
        for key, (n, err) in by.items():
            print(f"  22b B1 int8 {name} {key}: {n} calls, max_abs_err vs its plain version "
                  f"{err:.3e}")
    with tracing.recording() as records:
        engine(images, rois)
    counters = records[0]["counters"]
    if counters.get("unet_skip_resizes") != 1:
        raise AssertionError(f"22b B1: unet_skip_resizes {counters.get('unet_skip_resizes')}")
    bucket = roi_bucket(nrois, max_bucket=engine.max_bucket)
    images_t = torch.as_tensor(images).to("cuda", torch.bfloat16)
    rois_t = torch.as_tensor(pad_rois(rois, bucket)).to("cuda")
    fwd = [median_ms(lambda: engine.forward(images_t, rois_t), reps=5, warmup=1)
           for _ in range(3)]
    launches = {k.split(".", 1)[1]: v for k, v in counters.items()
                if k.startswith("launches.") and v}
    print(f"22b B1 enhanced served int8 ({batch} images, {nrois} RoIs, bucket {bucket}): fused "
          f"unit calls by (H, W, Ci, Co) {shapes}, each within TOL_CONV of its plain version "
          f"(worst {calls['conv_ln_act_s8'][1]:.3e}); the pre-quantized ConvNormActs' QConvs "
          f"fed {fed}; {calls['qconv'][0]} int8 QConv calls exact; stage kernel calls "
          f"{stage.counts()}, each held to its plain version; a request's counters: "
          f"unet_skip_resizes {counters['unet_skip_resizes']}, launches {launches}, int8_calls "
          f"{counters['int8_calls']}; forward ms {[round(t, 2) for t in fwd]} (median of 5, "
          f"CUDA events) [{card}]")
    del engine, images_t, rois_t
    torch.cuda.empty_cache()
    return launches


def b1_enhanced_head(card: str, rng) -> list:
    """Phase 22: the fused unit at the B1 enhanced head's shapes, alone and
    served."""
    rows = b1_unit_shapes(card, rng)
    PER_FORWARD["conv_ln_act_b1"] = {"b1_enhanced": b1_served(card, rng)["conv_ln_act_s8"]}
    worst = max(rows, key=lambda row: row["ms_10"] / row["bound_ms"])
    return [{"name": "conv_ln_act_b1", "route": "cuda",
             "source": "human_instance_segmentation_tpu_torch/csrc/conv_ln_act.cu",
             "replaces": "human_instance_segmentation_tpu/ops/pallas_head.py:243",
             "max_abs_err": max(row["max_abs_err"] for row in rows), "ms": worst["ms_10"],
             "bound_ms": worst["bound_ms"], "plain_ms": None, "library_ms": None,
             "timings": rows}]


# phase 23: the benchmark's cells, most dispatch-bound first, and the seed
GRAPH_CELLS = ("b7.crowdhuman2", "b1.batch8.coco", "b0.batch32.coco")
GRAPH_SEED = 7
GRAPH_TIMED = 12  # calls of each kind timed, in four turns
GRAPH_BUSY_SHARE = 0.05  # a replayed request's profiled busy time within 5% of an eager one's
# the hand-written kernels' device names (csrc/), by the entry points whose
# ``.launches`` count their calls: entry points that share device kernels
# are one family; every call launches one of its family's kernels or more
HAND_FAMILIES = {
    "s8 convs and conv_ln_act": (("qconv2d", "s8_matmul", "conv_ln_act", "conv_ln_act_s8"),
                                 ("stage_kernel", "wide_kernel", "narrow_kernel",
                                  "conv_bf16_kernel", "conv_bf16_wgmma_kernel",
                                  "conv_f32_kernel", "ln_act_kernel")),
    "tails": (("tail", "tail_q"), ("tail_kernel", "tail_bf16_kernel", "tail_q_kernel")),
    "mbconv": (("mbconv_sums", "mbconv_apply"), ("mbconv_kernel", "mbconv_bf16_kernel")),
    "roi_align": (("roi_align",), ("roi_align_kernel",)),
    "bilateral_filter": (("bilateral_filter",), ("bilateral_kernel",)),
    "edge_smooth": (("edge_smooth",), ("edge_smooth_kernel",)),
    "ln_act": (("ln_act",), ("ln_stats_kernel", "ln_apply_kernel")),
}


def kernel_name(name: str) -> str:
    """A device kernel's name without its namespaces, template arguments
    and parameters (``void ns::(anonymous namespace)::wide_kernel<8>(...)``
    -> ``wide_kernel``)."""
    name = re.sub(r"\(anonymous namespace\)", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the first '<' or '(' outside brackets ends the name
        if ch in "<(" and depth == 0:
            cut = i
            break
    name = name[:cut]
    return name.split("::")[-1].split(" ")[-1]


def device_kind(name: str) -> str:
    """A device event's name for counting: kernels by :func:`kernel_name`,
    memsets and memcpys by kind and direction (a graph's memset node is
    named ``memset32`` where an eager memset reads ``Memset (Device)``)."""
    low = name.lower()
    if low.startswith(("memset", "memcpy")):
        found = re.search(r"(htod|dtoh|dtod)", low)
        return low[:6] + (f" {found.group(1)}" if found else "")
    return kernel_name(name)


def counted_launches(fn, reqs, warm) -> tuple:
    """The device launches, by :func:`device_kind`, of ``fn`` over
    ``reqs`` under ``torch.profiler``, and the ``launches.*`` counters'
    calls over them: ``fn(warm)`` runs first in the same trace, whose first
    records may be lost, and only device events that start after the
    counted requests' range opened are counted."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from human_instance_segmentation_tpu_torch.tracing import launch_counts

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(warm)
        torch.cuda.synchronize()
        before = launch_counts()
        with record_function("smoke.counted"):
            for req in reqs:
                fn(req)
            torch.cuda.synchronize()
        after = launch_counts()
    events = prof.events()
    start = min(ev.time_range.start for ev in events
                if ev.name == "smoke.counted" and ev.device_type.name == "CPU")
    names = Counter(device_kind(ev.name) for ev in events
                    if ev.device_type.name == "CUDA" and ev.name != "smoke.counted"
                    and ev.time_range.start >= start)
    calls = {k[len("launches."):]: after[k] - before[k]
             for k in after if k.startswith("launches.")}
    return names, calls


def hand_launches(names, calls: dict) -> dict:
    """By family of :data:`HAND_FAMILIES`: its kernels' device launches in
    ``names`` and the calls its entry points counted in ``calls``."""
    return {family: (sum(names[k] for k in kernels), sum(calls[e] for e in entries))
            for family, (entries, kernels) in HAND_FAMILIES.items()}


def graph_serving(card: str) -> dict:
    """Phase 23: each benchmark cell's engine as ``port_bench`` builds it
    (its configuration, the seed's weights, calibration and request pool)
    served from its CUDA graph against eager serving on the same engine:
    every request of the pool replayed equal bit for bit to its eager
    call; wall ms a ``__call__`` of each, in turns; the capture's wall ms;
    ``torch.profiler`` busy time of replayed requests against eager ones,
    reduced by the benchmark's own ``lib/trace.py`` (a profiler that missed
    the graph's kernels would read less); the counters (1 capture, a replay
    a call, 0 fallbacks). The launch counters are Python that a replay
    does not run, so the replayed path's kernels are checked by name in the
    traces: every device kernel's launches in the replayed requests equal
    those in the eager ones, and each hand-written family that the eager
    calls counted launched on the device in both, at least once a call.
    Returns wall ms and busy ms by cell."""
    import numpy as np
    import torch

    from port_bench.lib import spec, system, traffic
    from port_bench.lib import weights as weights_mod
    from port_bench.lib.trace import profile

    def eager(engine, req):
        with served_eagerly(engine):
            return engine(req.images, req.rois)

    def timed(fn, reqs) -> list:
        out = []
        for req in reqs:
            t0 = time.perf_counter()
            fn(req)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    results = {}
    for name in GRAPH_CELLS:
        cell = spec.cell(name)
        config, mix = cell["config"], cell["traffic"]
        size = tuple(config["model"]["image_size"])
        w = weights_mod.draw(system.parameter_shapes(config), GRAPH_SEED, "cuda")
        engine = system.build_engine(config, w, "cuda")
        calib = traffic.calibration(mix, size, GRAPH_SEED)
        engine.calibrate(calib.images, calib.rois)
        pool = traffic.pool(mix, size, GRAPH_SEED)
        want = [eager(engine, req) for req in pool]
        engine(pool[0].images, pool[0].rois)  # the shape's first call: eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine(pool[0].images, pool[0].rois)  # captures, then replays
        capture_ms = (time.perf_counter() - t0) * 1e3
        if (engine.graph_captures, engine.graph_replays, engine.graph_fallbacks) != (1, 0, 0):
            raise AssertionError(f"23 {name}: counters {engine.graph_captures}, "
                                 f"{engine.graph_replays}, {engine.graph_fallbacks} after the "
                                 "capture, want 1, 0, 0")
        for k, req in enumerate(pool):
            got = engine(req.images, req.rois)
            for g, e in zip(got, want[k]):
                if g.dtype != e.dtype or g.shape != e.shape or not np.array_equal(g, e):
                    raise AssertionError(f"23 {name}: request {k} replayed differs from its "
                                         f"eager call ({int((g != e).sum())} values)")
        if (engine.graph_replays, engine.graph_fallbacks) != (len(pool), 0):
            raise AssertionError(f"23 {name}: {engine.graph_replays} replays and "
                                 f"{engine.graph_fallbacks} fallbacks over {len(pool)} calls")
        reqs = [pool[k % len(pool)] for k in range(GRAPH_TIMED // 4)]
        ms = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            fn = ((lambda r: eager(engine, r)) if kind == "eager"
                  else (lambda r: engine(r.images, r.rois)))
            ms[kind] += timed(fn, reqs)
        traces, names, hand = {}, {}, {}
        for kind in ("eager", "graph"):
            fn = ((lambda r: eager(engine, r)) if kind == "eager"
                  else (lambda r: engine(r.images, r.rois)))
            traces[kind] = profile(lambda: [fn(r) for r in pool[:4]], torch.cuda.synchronize)
            names[kind], calls = counted_launches(fn, pool[:4], pool[4])
            hand[kind] = hand_launches(names[kind], calls)
        differ = {n: (names["eager"][n], names["graph"][n])
                  for n in set(names["eager"]) | set(names["graph"])
                  if names["eager"][n] != names["graph"][n]}
        used = {f: list(v) for f, v in hand["eager"].items() if v[0] or v[1]}
        print(f"23 {name}: device launches of 4 requests eager {sum(names['eager'].values())}, "
              f"replayed {sum(names['graph'].values())}, differing by name (eager, replayed) "
              f"{differ}; hand-written families (device launches, calls counted) eager {used}, "
              f"replayed { {f: list(hand['graph'][f]) for f in used} } [{card}]", flush=True)
        if differ:
            raise AssertionError(f"23 {name}: device launches eager and replayed differ")
        for family, (device, calls) in hand["eager"].items():
            replayed, replay_calls = hand["graph"][family]
            if calls and not (device >= calls and replayed == device):
                raise AssertionError(
                    f"23 {name}: {family}: {calls} calls counted eager, {device} device "
                    f"launches eager, {replayed} replayed")
            if replay_calls or (device and not calls):
                raise AssertionError(f"23 {name}: {family}: calls counted eager {calls} and "
                                     f"replayed {replay_calls}, device launches {device}")
        if not any(calls for _, calls in hand["eager"].values()):
            raise AssertionError(f"23 {name}: no hand-written kernel ran")
        busy = {k: t.busy_s / 4 * 1e3 for k, t in traces.items()}
        idle = {k: 100.0 * (1.0 - t.busy_s / t.window_s) for k, t in traces.items()}
        kernels = {k: len(t.kernels) for k, t in traces.items()}
        med = {k: statistics.median(v) for k, v in ms.items()}
        print(f"23 {name}: {pool[0].images.shape[0]} images x {pool[0].rois.shape[0]} RoIs; "
              f"{len(pool)} requests replayed equal to their eager calls bit for bit; ms a "
              f"__call__ (median of {len(ms['eager'])}, in turns) eager {med['eager']:.2f} "
              f"{[round(t, 2) for t in ms['eager']]}, replayed {med['graph']:.2f} "
              f"{[round(t, 2) for t in ms['graph']]}; capture call {capture_ms:.1f} ms; "
              f"profiled busy ms a request eager {busy['eager']:.3f}, replayed "
              f"{busy['graph']:.3f}; idle eager {idle['eager']:.1f}%, replayed "
              f"{idle['graph']:.1f}%; device ops seen eager {kernels['eager']}, replayed "
              f"{kernels['graph']}; counters: {engine.graph_captures} capture, "
              f"{engine.graph_replays} replays, {engine.graph_fallbacks} fallbacks; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
        if engine.graph_fallbacks or engine.graph_captures != 1:
            raise AssertionError(f"23 {name}: a capture failed or ran again")
        if abs(busy["graph"] - busy["eager"]) > GRAPH_BUSY_SHARE * busy["eager"]:
            raise AssertionError(f"23 {name}: the profiler's busy time of replayed requests "
                                 f"{busy['graph']:.3f} ms against eager {busy['eager']:.3f}: "
                                 "it does not see the graph's kernels as it sees eager ones")
        results[name] = {"eager_ms": med["eager"], "graph_ms": med["graph"],
                         "busy_ms": busy, "idle_pct": idle, "capture_ms": capture_ms}
        del engine, w, want
        torch.cuda.empty_cache()
    return results


def phases_of(label: str) -> set:
    """The phases of a group label of the summary ("3,6,9,12", "4-8")."""
    out = set()
    for part in label.split(","):
        lo, _, hi = part.partition("-")
        out |= set(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> None:
    import atexit

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
    entry = ""
    for line in _build.build_log.splitlines():
        found = re.search(r"entry function '(\w+)'", line)
        if found:  # the mangled name: the kernel's name and template arguments are readable
            kernel = re.search(r"\d+([a-z_0-9]+kernel\w*?)(?:EvP|Ev)", found.group(1))
            entry = kernel.group(1) if kernel else found.group(1)[:60]
        if "Used" in line or "spill" in line:
            print(f"  ptxas {entry}:", line.strip())

    from human_instance_segmentation_tpu_torch.ops import quant

    for name, (_, _, _, ci, _, k) in QCONV_SHAPES.items():  # one layout, stated twice
        if _build.library().s8_conv_packed_k(ci, k) != quant.packed_k(ci, k):
            raise AssertionError(f"{name}: the wrapper and the kernel disagree on the packed "
                                 "weight row")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    rng = np.random.default_rng(0)
    phases = set(range(1, 24))
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        phases = {int(p) for p in sys.argv[2].split(",")}
    kernels, launches = [], {}
    seconds = {"1-2": round(time.perf_counter() - t0, 1)}  # the build and its checks
    mark = time.perf_counter()

    def took(label: str) -> None:  # the wall time of each group of phases, for the summary
        nonlocal mark
        now = time.perf_counter()
        seconds[label] = round(now - mark, 1)
        mark = now

    def passed() -> None:  # the last line, after a failing phase's traceback too
        done = sorted(p for p in phases if any(p in phases_of(label) for label in seconds))
        print(f"phases passed: {done} of {sorted(phases)} asked [{card}]", flush=True)

    atexit.register(passed)

    if 3 in phases:
        kernels += check_kernels(card, rng)
    if 6 in phases:
        kernels += check_int8_kernels(card, rng)
    if 9 in phases:
        kernels += check_tail_and_filters(card, rng)
    if 12 in phases:
        kernels += check_mbconv_and_tail_q(card, rng)
    took("3,6,9,12")
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
    took("4-8")
    if 10 in phases:
        torch.cuda.empty_cache()
        launches["tail"] = serve_with_tail(card, rng)["tail"]
        torch.cuda.empty_cache()
    if 11 in phases:
        binary_launches = binary_mask_mode(card, rng)
        launches["tail"] = launches.get("tail", 0) + binary_launches["tail"]
        launches["bilateral_filter"] = binary_launches["bilateral_filter"]
        launches["edge_smooth"] = binary_launches["edge_smooth"]
    took("10-11")

    if 13 in phases:
        torch.cuda.empty_cache()
        slice_launches = serve_fused_encoder_and_tail_q(card, rng)
        for name in ("mbconv_sums", "mbconv_apply", "tail_q"):
            launches[name] = slice_launches[name]
        for name in ("tail", "conv_ln_act", "conv_ln_act_s8", "qconv", "roi_align"):
            launches[name] = launches.get(name, 0) + slice_launches[name]
        took("13")

    if 14 in phases:
        torch.cuda.empty_cache()
        train_launches = train_entry_point(card, rng)
        train_step_kernels(card, rng)
        time_train_steps(card)
        for name, n in train_launches.items():
            launches[name] = launches.get(name, 0) + n
        took("14")

    if 15 in phases:
        torch.cuda.empty_cache()
        for name, n in serve_rgb_family(card, rng).items():
            launches[name] = launches.get(name, 0) + n
        train_roi_family(card, rng)
        for name, n in train_and_serve_a3_flagship(card, rng).items():
            launches[name] = launches.get(name, 0) + n
        took("15")

    if 16 in phases:
        torch.cuda.empty_cache()
        tree = coco_tree(card)
        host = loader_alone(card, tree)
        for name, n in train_on_coco(card, tree).items():
            launches[name] = launches.get(name, 0) + n
        fed_step_times(card, tree, host)
        del host
        learnability(card)
        took("16")

    if 17 in phases:
        torch.cuda.empty_cache()
        if 16 not in phases:
            tree = coco_tree(card)
        for name, n in deployment_tools(card, rng, tree).items():
            launches[name] = launches.get(name, 0) + n
        took("17")

    if 18 in phases:
        torch.cuda.empty_cache()
        teacher_kernels = distill_teacher_kernels()
        distill_launches = distillation_run(card, teacher_kernels)
        distill_step_kernels(card, teacher_kernels)
        time_distill_steps(card, teacher_kernels)
        for name, n in hierarchical_distill(card, rng).items():
            distill_launches[name] = distill_launches.get(name, 0) + n
        for name, n in distill_launches.items():
            launches[name] = launches.get(name, 0) + n
        took("18")

    if 19 in phases:
        torch.cuda.empty_cache()
        for name, n in other_families(card, rng).items():
            launches[name] = launches.get(name, 0) + n
        took("19")

    if 20 in phases:
        torch.cuda.empty_cache()
        data_parallel(card)
        took("20")

    if 21 in phases:
        torch.cuda.empty_cache()
        kernels += layernorm_chains(card, rng)
        launches["ln_act"] = sum(PER_FORWARD["ln_act"].values())
        took("21")

    if 22 in phases:
        torch.cuda.empty_cache()
        kernels += b1_enhanced_head(card, rng)
        launches["conv_ln_act_b1"] = PER_FORWARD["conv_ln_act_b1"]["b1_enhanced"]
        took("22")

    if 23 in phases:
        torch.cuda.empty_cache()
        graph_serving(card)
        took("23")

    for k in kernels:
        if k["name"] == "conv_ln_act" and A8_PER_FORWARD:
            k["a8_launches_per_forward"] = dict(A8_PER_FORWARD)
        if k["name"] in YOLO_PER_STEP:
            k["yolo_launches_per_step"] = YOLO_PER_STEP[k["name"]]
        if k["name"] in TRAIN_PER_STEP and 14 in phases:
            k["train_launches"] = train_launches[k["name"]]
            k["train_launches_per_step"] = TRAIN_PER_STEP[k["name"]]
        dp = {key.split(" ", 1)[0]: n for key, n in DP_PER_RANK.items()
              if key.split(" ", 1)[1] == k["name"]}
        if dp:
            k["dp_launches_per_rank"] = dp
        if k["name"] in DISTILL_PER_STEP:
            k["distill_launches"] = distill_launches.get(k["name"], 0)
            k["distill_launches_per_step"] = DISTILL_PER_STEP[k["name"]]
        k["launches"] = launches.get(k["name"], 0)
        if k["name"] in PER_FORWARD:
            k["launches_per_forward"] = PER_FORWARD[k["name"]]
        k["bound_share"] = k["bound_ms"] / k["ms"]
    if any(k["launches"] == 0 for k in kernels) and phases >= {3, 4, 6, 7, 9, 10, 11, 12, 13, 14}:
        raise AssertionError(f"a kernel of the main path was never launched: {kernels}")
    print(f"seconds by phase: {seconds}, in all {round(time.perf_counter() - t0, 1)} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
