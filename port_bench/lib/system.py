"""The system under test: the port's ``InferenceEngine`` over the served
model, both built from a configuration file's keyword arguments.

This is the only module of the benchmark that imports the port
(``human_instance_segmentation_tpu_torch``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parameter_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the served model's parameters and buffers (built
    on the meta device, so nothing is allocated or drawn)."""
    from human_instance_segmentation_tpu_torch.models.assembly import (
        HierarchicalInstanceSegmenter)

    with torch.device("meta"):
        model = HierarchicalInstanceSegmenter(**config["model"])
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


def build_engine(config: dict, weights: Dict[str, torch.Tensor], device):
    """``InferenceEngine`` serving the configuration's model with
    ``weights``, on ``device``."""
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine
    from human_instance_segmentation_tpu_torch.models.assembly import (
        HierarchicalInstanceSegmenter)

    with torch.device(device):
        model = HierarchicalInstanceSegmenter(**config["model"])
    model.load_state_dict(weights)
    e = dict(config["engine"])
    e["dtype"] = DTYPES[e["dtype"]]
    return InferenceEngine(model.eval(), device=device, **e)
