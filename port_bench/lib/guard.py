"""The run's process holds no JAX and nothing of the JAX package.

Module names are compared by their top-level part (before the first dot),
whole: the port's name, ``human_instance_segmentation_tpu_torch``, begins
with the JAX package's, so a test of prefixes would be wrong.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "human_instance_segmentation_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``names``."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def loaded() -> List[str]:
    return forbidden(list(sys.modules))
