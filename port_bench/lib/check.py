"""Whether the timed path's answers are right: its outputs for a seeded
sample of the window's requests against the plain float32 reference.

The reference runs after the window, once the peak memory is read and the
served model is freed, in blocks of images and of RoIs, with TF32 off. It
is built from the same seeded weights and fed the same numpy requests; it
takes nothing the served model made.

Numbers compared (each with a limit in ``port_bench/limits/<cell>.json``):

* ``inst_logit_err``: the largest relative L2 error, over the compared
  requests' real RoIs, of the served class logits (the served model's
  output on the timed call, before the dilation boost) against the
  reference's;
* ``inst_worst_roi``: the largest share of one RoI's instance-mask pixels
  where the served mask differs from the reference's (an answer altered or
  left out where it is produced);
* ``binary_mad``: mean absolute difference of P(person) over every pixel of
  the compared images;
* ``binary_worst_image``: the largest such mean of one image (an image of
  the batch left out or altered).

A request whose answers have the wrong shape, or are not finite, reads
``WRONG`` on every number.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .traffic import Request

NUMBERS = ("inst_logit_err", "inst_worst_roi", "binary_mad", "binary_worst_image")
WRONG = 1e9


def reference_outputs(ref, request: Request, device, image_block: int,
                      roi_block: int) -> Tuple[np.ndarray, ...]:
    """The reference's (class logits (N, 3, mh, mw) before the dilation
    boost, instance masks (N, mh, mw, 1), binary masks (B, H, W, 1)) of one
    request."""
    images = torch.as_tensor(request.images, device=device)
    rois = torch.as_tensor(request.rois, device=device)
    logits, binary = [], []
    with torch.inference_mode():
        for i in range(0, images.shape[0], image_block):
            lg, bm = ref.stage1(images[i:i + image_block])
            logits.append(lg)
            binary.append(bm.cpu())
        logits = torch.cat(logits)
        out = [[t.cpu() for t in ref.stage2(images, logits, rois[j:j + roi_block])]
               for j in range(0, rois.shape[0], roi_block)]
    cls, inst = (torch.cat(parts).numpy() for parts in zip(*out))
    return cls, inst, torch.cat(binary).numpy()


def compare(pairs: Sequence[Tuple[tuple, tuple]]) -> Dict[str, float]:
    """``pairs`` of (served (instance masks, binary masks, class logits
    (N, mh, mw, 3))), reference (class logits, instance masks, binary
    masks)) -> the numbers compared."""
    logit_err, worst_roi, abs_sum, bin_pixels, worst_img = 0.0, 0.0, 0.0, 0, 0.0
    for (inst, binary, logits), (rlogits, rinst, rbinary) in pairs:
        n, c, mh, mw = rlogits.shape
        if (inst.shape != rinst.shape or logits is None or logits.shape != (n, mh, mw, c)
                or binary is None or binary.shape != rbinary.shape
                or not all(np.isfinite(x).all() for x in (inst, binary, logits))):
            return {k: WRONG for k in NUMBERS}
        if n:
            ref = rlogits.transpose(0, 2, 3, 1).reshape(n, -1).astype(np.float64)
            diff = logits.reshape(n, -1).astype(np.float64) - ref
            err = np.linalg.norm(diff, axis=1) / np.maximum(np.linalg.norm(ref, axis=1), 1e-30)
            logit_err = max(logit_err, float(err.max()))
            worst_roi = max(worst_roi, float((inst != rinst).reshape(n, -1).mean(axis=1).max()))
        per_img = np.abs(binary.astype(np.float64) - rbinary).reshape(binary.shape[0], -1)
        abs_sum += float(per_img.sum())
        bin_pixels += per_img.size
        worst_img = max(worst_img, float(per_img.mean(axis=1).max(initial=0.0)))
    return {"inst_logit_err": logit_err, "inst_worst_roi": worst_roi,
            "binary_mad": abs_sum / max(bin_pixels, 1), "binary_worst_image": worst_img}


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]) -> Tuple[bool, List[str]]:
    """All numbers within their limits, and a line per number."""
    ok, lines = True, []
    for name in NUMBERS:
        value, limit = numbers[name], float(limits[name]["limit"])
        ok = ok and value <= limit
        lines.append(f"{name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}")
    return ok, lines


def run_reference(config: dict, weights: Dict[str, torch.Tensor], requests: List[Request],
                  device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Reference outputs of ``requests``, blocks as the configuration sets."""
    from .work import reference_module

    ref_mod = reference_module(config)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = ref_mod.build(config, device)
        ref_mod.load(ref, weights)
        blocks = config["reference_blocks"]
        return [reference_outputs(ref, r, device, blocks["images"], blocks["rois"])
                for r in requests]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
