"""ROI-sharded inference: the ROI count N is the axis that grows in crowded
scenes, so stage 2 runs on a slice of the ROIs on every rank.

Counterpart of the JAX package's ``parallel/roi_sharding.py`` (:1-56).
Every rank runs stage 1 on the whole image batch and stage 2 on its slice
of the padded ROIs; the instance masks are gathered (``all_gather``), so
every caller gets the whole ``(bucket, mh, mw, 1)`` masks, and the binary
masks, computed from the whole batch on every rank, come back as they are.
JAX returns the instance masks sharded over its mesh; a rank here holds
only its own memory, so the gather is what hands every caller the full
result.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..inference import deployed_outputs, pad_rois
from .mesh import all_gather, shard_batch, world_of


def make_roi_sharded_infer(model, mesh, dilation_pixels: int = 0):
    """``infer(images, rois) -> (instance_masks, binary_masks)``: ``images``
    the whole (B, H, W, 3) batch on this rank's device, ``rois`` this rank's
    slice of the padded ROIs (:func:`shard_rois`). The model runs in eval
    mode without autograd, its mode restored after."""

    def infer(images: torch.Tensor, rois: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                logits, aux = model(images, rois)
                inst, binary = deployed_outputs(logits, aux, rois, dilation_pixels)
                return all_gather(inst, mesh), binary
        finally:
            model.train(was_training)

    return infer


def shard_rois(mesh, rois: np.ndarray) -> Tuple[torch.Tensor, int]:
    """Pad (N, 5) rois to a multiple of the world size with the sentinel
    rois of ``pad_rois`` (batch_idx -1) and return ``(this rank's slice on
    its device, N)``."""
    n = rois.shape[0]
    d = world_of(mesh)
    bucket = max(((n + d - 1) // d) * d, d)
    padded = pad_rois(np.asarray(rois, np.float32), bucket)
    return shard_batch(mesh, padded), n
