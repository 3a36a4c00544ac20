"""The one space-to-depth helper the plain path needs.

The JAX package's ``ops/s2d.py`` holds exact phase-form rewrites of the
stage-1 tail made for the TPU's 128-lane layout; the port computes the
plain form, so only the nearest-neighbour 2x upsample
(``stage1_upsample_mode="nearest"``) is carried over.
"""

from __future__ import annotations

from typing import Sequence

import torch


def upsample_2x_nearest(x: torch.Tensor, axes: Sequence[int] = (1, 2)) -> torch.Tensor:
    """2x nearest upsample over the two spatial ``axes`` (NHWC by default),
    ``F.interpolate(scale_factor=2, mode='nearest')``."""
    return x.repeat_interleave(2, dim=axes[0]).repeat_interleave(2, dim=axes[1])
