"""The one generator of requests: a traffic file's parameters and a seed in,
numpy requests out, as a user of ``InferenceEngine`` hands them over.

A traffic file (``port_bench/traffic/<mix>.json``) holds:

* ``loop``: ``"closed"`` (one caller sends its next request when the last
  returns; no other kind is implemented), ``clients``: 1;
* ``pool``: how many distinct requests are made and cycled;
* ``images``: images a request (uniform [0, 1] float32, the model's size);
* ``rois``: RoIs a request, the same for every request of the pool (each
  seed serves the same sizes);
* ``rois_per_image``: ``{"min", "cap", "mean"}``: each image of a request
  gets at least ``min`` and at most ``cap`` RoIs, the rest spread by a
  seeded shifted-geometric draw of that mean, then evened to the total;
* ``box``: ``{"width": [lo, hi], "height": [lo, hi]}``, box sides as
  shares of the image, uniform, the box placed uniformly inside it;
* ``trace_requests``: requests in a traced window; ``check_requests``:
  requests of the pool compared with the reference after the window.

Every draw comes from ``numpy.random.default_rng([seed, stream])``, so the
same seed gives the same requests, order and samples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

POOL, CALIBRATION, ORDER, CHECK = range(4)  # the seed's independent streams


@dataclass
class Request:
    images: np.ndarray  # (B, H, W, 3) float32 in [0, 1]
    rois: np.ndarray  # (N, 5) float32 rows [image, x1, y1, x2, y2] in [0, 1]


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def spread(total: int, n: int, spec: dict, gen: np.random.Generator) -> np.ndarray:
    """``total`` RoIs over ``n`` images, each in [min, cap]."""
    lo, cap, mean = int(spec["min"]), int(spec["cap"]), float(spec["mean"])
    if not lo * n <= total <= cap * n:
        raise ValueError(f"{total} RoIs cannot spread over {n} images within [{lo}, {cap}]")
    counts = np.minimum(lo + gen.geometric(1.0 / max(mean - lo + 1.0, 1.0), n) - 1, cap)
    while counts.sum() > total:
        counts[gen.choice(np.flatnonzero(counts > lo))] -= 1
    while counts.sum() < total:
        counts[gen.choice(np.flatnonzero(counts < cap))] += 1
    return counts


def boxes(counts: Sequence[int], box: dict, gen: np.random.Generator) -> np.ndarray:
    """Rows ``[image, x1, y1, x2, y2]``, ``counts[i]`` of them on image i."""
    image = np.repeat(np.arange(len(counts)), counts).astype(np.float32)
    n = image.shape[0]
    w = gen.uniform(*box["width"], n)
    h = gen.uniform(*box["height"], n)
    x1 = gen.uniform(0.0, 1.0 - w)
    y1 = gen.uniform(0.0, 1.0 - h)
    return np.stack([image, x1, y1, x1 + w, y1 + h], axis=1).astype(np.float32)


def request(traffic: dict, n_rois: int, image_size: Tuple[int, int],
            gen: np.random.Generator) -> Request:
    b = int(traffic["images"])
    images = gen.random((b, image_size[0], image_size[1], 3), dtype=np.float32)
    counts = spread(n_rois, b, traffic["rois_per_image"], gen)
    return Request(images, boxes(counts, traffic["box"], gen))


def pool(traffic: dict, image_size: Tuple[int, int], seed: int) -> List[Request]:
    """The requests the window cycles through."""
    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise ValueError("only a closed loop with one client is implemented")
    gen = rng(seed, POOL)
    return [request(traffic, int(traffic["rois"]), image_size, gen)
            for _ in range(int(traffic["pool"]))]


def calibration(traffic: dict, image_size: Tuple[int, int], seed: int) -> Request:
    """A request of the mix's shape, apart from the pool, for the engine's
    one calibration."""
    return request(traffic, int(traffic["rois"]), image_size, rng(seed, CALIBRATION))


def order(traffic: dict, seed: int) -> List[int]:
    """The order in which the window cycles through the pool."""
    return [int(i) for i in rng(seed, ORDER).permutation(int(traffic["pool"]))]


def checked(traffic: dict, seed: int) -> List[int]:
    """The pool's requests compared with the reference."""
    n = int(traffic["pool"])
    return sorted(int(i) for i in rng(seed, CHECK).choice(n, min(n, traffic["check_requests"]),
                                                          replace=False))
