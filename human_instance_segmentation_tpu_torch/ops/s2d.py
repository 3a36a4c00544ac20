"""The space-to-depth helpers the plain path needs.

The JAX package's ``ops/s2d.py`` holds exact phase-form rewrites of the
stage-1 tail made for the TPU's 128-lane layout; the port computes the
plain form, so only the nearest-neighbour 2x upsample
(``stage1_upsample_mode="nearest"``) and the static int8 quantize that the
producer-side quantization points use are carried over.
"""

from __future__ import annotations

from typing import Sequence

import torch


def upsample_2x_nearest(x: torch.Tensor, axes: Sequence[int] = (1, 2)) -> torch.Tensor:
    """2x nearest upsample over the two spatial ``axes`` (NHWC by default),
    ``F.interpolate(scale_factor=2, mode='nearest')``."""
    return x.repeat_interleave(2, dim=axes[0]).repeat_interleave(2, dim=axes[1])


def quantize_static(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric round-to-nearest-even int8 with a static scale: ``round(x *
    float32(1 / scale))`` clipped to +-127 (s2d.py:79 multiplies by the
    reciprocal; ``qconv2d`` divides)."""
    inv = torch.full((1,), 1.0 / scale, dtype=torch.float32, device=x.device)
    return torch.round(x.to(torch.float32) * inv).clamp(-127.0, 127.0).to(torch.int8)
