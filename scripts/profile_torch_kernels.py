"""Where the time of the port's two bf16 tensor-core kernels goes: the fused
stage-1 tail (``csrc/tail.cu``) and the fused MBConv (``csrc/mbconv.cu``),
timed at the served shapes with parts of each kernel switched off.

    python3 scripts/profile_torch_kernels.py

Needs one CUDA card and ``nvcc``. Each variant is a separate build of the
kernels with ``-DHIST_SKIP=<mask>`` (``csrc/mma_bf16.cuh`` lists the bits);
a part switched off still runs its loads and stores of shared memory, so the
drop in time is what that part costs. The results are device times (ten
launches in a row between CUDA events, median of 20) on the same seeded
inputs: the tail at ``chip_smoke.TAIL_SHAPE`` in the served layout (NCHW
memory viewed as NHWC, weights packed once), both MBConv passes summed over
``chip_smoke.MBCONV_SHAPES`` (channels-last). A variant computes wrong
values; only its time means something. Prints one line per variant, then
all of them as one JSON object on the last line.
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


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from human_instance_segmentation_tpu_torch.ops import _build, cuda_mbconv, cuda_tail

    card = cs.card_line()
    print(card)
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

    results = []
    for name, mask in VARIANTS:
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
    print(json.dumps({"card": card, "tail_shape": cs.TAIL_SHAPE,
                      "mbconv_shapes": cs.MBCONV_SHAPES, "results": results}))


if __name__ == "__main__":
    main()
