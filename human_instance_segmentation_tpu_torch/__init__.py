"""PyTorch/CUDA port of human_instance_segmentation_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax``. Public functions keep the JAX package's NHWC
contract: images (B, H, W, 3) in [0, 1], rois (N, 5) ``[batch_idx, x1, y1,
x2, y2]`` normalised to [0, 1], instance masks (N, mh, mw, 1) and binary
masks (B, H, W, 1).

The TPU's Pallas kernels on the served path are hand-written CUDA kernels
for Hopper (``csrc/``, built by ``ops/_build.py`` on first use); CPU
tensors take each kernel's plain PyTorch version.
"""

from .inference import InferenceEngine, create_flagship, deployed_outputs, pad_rois, roi_bucket

__all__ = ["InferenceEngine", "create_flagship", "deployed_outputs", "pad_rois", "roi_bucket"]
