"""Seeded weights, drawn on the device for a checkpoint's names and shapes.

One ``torch.Generator`` on the device draws a single normal buffer for all
conv kernels, which are cut from it: LeCun-normal, std 1/sqrt(fan in)
(a transposed conv's fan in is its input channels x its taps). Norm scales
are 1 and shifts 0, running statistics 0 and 1, biases 0, the stage-1
wrapper [+1, -1] with bias 0, the distance threshold 0.3. Values are
rounded to bfloat16, the type they are served in, and kept as float32, so
the served model and the reference start from the same numbers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

WRAPPER = "unet_wrapper.output_conv."


def fan_in(name: str, shape: Tuple[int, ...]) -> int:
    taps = shape[2] * shape[3]
    return (shape[0] if name.endswith("deconv.weight") else shape[1]) * taps


def draw(shapes: Mapping[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor on device}`` for every ``name: shape``."""
    kernels = [n for n, s in shapes.items()
               if len(s) == 4 and n.endswith("weight") and not n.startswith(WRAPPER)]
    total = sum(int(torch.Size(shapes[n]).numel()) for n in kernels)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n in kernels:
        size = torch.Size(shapes[n]).numel()
        w = noise[at:at + size].view(shapes[n]) / float(fan_in(n, shapes[n])) ** 0.5
        out[n] = w.to(torch.bfloat16).to(torch.float32)
        at += size
    for n, s in shapes.items():
        if n in out:
            continue
        if n == WRAPPER + "weight":
            out[n] = torch.tensor([1.0, -1.0], device=device).reshape(s)
        elif n.endswith("running_var") or (n.endswith("weight") and len(s) == 1):
            out[n] = torch.ones(s, device=device)
        elif n.endswith("threshold"):
            out[n] = torch.full(s, 0.3, device=device)
        elif n.endswith(("bias", "running_mean")):
            out[n] = torch.zeros(s, device=device)
        else:
            raise ValueError(f"no initialisation rule for {n} {tuple(s)}")
    return out
