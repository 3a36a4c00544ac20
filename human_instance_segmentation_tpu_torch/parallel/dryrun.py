"""Data-parallel dry run: the DP train step, eval step and mesh serving on n
ranks at tiny shapes, with semantic checks.

Counterpart of the JAX package's ``parallel/dryrun.py`` (:1-142), which
runs the sharded step on n virtual CPU devices. Here n processes join one
process group (``parallel.launch.spawn``) on the card by default, as every
entry point of the port runs (``backend="gloo"`` lets n ranks share one
card; without CUDA it raises), or on the CPU with ``device="cpu"``, where
JAX's runs. Each rank:

- overfits one fixed, learnable batch (one image a rank) for 25 steps and
  requires the loss to fall (last below first), the step count to advance
  and every loss to be finite;
- requires the eval step's IoU over the trained batch to be above 0;
- serves the trained weights through ``InferenceEngine(mesh=)`` and the
  single-device engine and requires the outputs to agree within
  :data:`SERVE_ATOL` (TF32 off in the ranks). JAX's docstring calls this
  "bit-identical" but checks ``allclose`` at atol 1e-5 (ROADMAP C2); the
  port states the tolerance it checks, 1e-5, and reports the instance-mask
  agreement.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# mesh serving vs single-device serving (C2): the tolerance checked
SERVE_ATOL = 1e-5
STEPS = 25


def _dryrun_rank(rank: int, device: str) -> Dict:
    import torch

    from ..inference import InferenceEngine, init_weights
    from ..losses.hierarchical import RefinedLossConfig
    from ..models.assembly import HierarchicalInstanceSegmenter
    from ..training.optim import Transform, constant_schedule
    from ..training.state import TrainState
    from ..training.steps import make_eval_step, make_train_step
    from .mesh import create_mesh, mesh_device, replicate, shard_batch, world_of

    # float32 means float32 here: TF32's 10-bit mantissa puts the binary
    # masks of one and of two images a rank 4e-5 apart on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(device=torch.device(device).type)
    dev = mesh_device(mesh)
    n = world_of(mesh)
    # tiny shapes: this validates sharding and collectives, not accuracy
    ih, iw, rh, rw, mh, mw, k = 64, 64, 16, 12, 32, 24, 2
    batch = n  # one image a rank
    model = HierarchicalInstanceSegmenter(
        encoder_variant="tiny", roi_size=(rh, rw), mask_size=(mh, mw), image_size=(ih, iw),
        base_channels=16, depth=2, mid_channels=32, feature_dim=32,
        unet_decoder_channels=(32, 24, 16, 16, 8))
    init_weights(model, 0)
    model = replicate(mesh, model.to(dev))
    # a hot learning rate: the run overfits one batch and must learn
    tx = Transform("adamw", constant_schedule(3e-3), weight_decay=1e-4, clip=1.0)
    state = TrainState.create(model, tx, seed=1)

    rng = np.random.default_rng(0)
    # learnable targets: class 1 in the centre of each ROI, class 2 in a side
    # band, background elsewhere
    masks = np.zeros((batch, k, mh, mw), np.int64)
    masks[:, :, mh // 4: 3 * mh // 4, mw // 4: 3 * mw // 4] = 1
    masks[:, :, :, : mw // 8] = 2
    host_batch = {
        "images": rng.random((batch, ih, iw, 3), np.float32),
        "boxes": np.tile(np.asarray([[0.2, 0.2, 0.8, 0.8], [0.1, 0.1, 0.6, 0.9]], np.float32),
                         (batch, 1, 1)),
        "masks": masks,
        "valid": np.ones((batch, k), np.float32),
    }
    local = shard_batch(mesh, host_batch)
    train_step = make_train_step(model, RefinedLossConfig(), mesh=mesh)
    losses = []
    for _ in range(STEPS):
        state, metrics = train_step(state, local)
        losses.append(float(metrics["total_loss"]))
    assert state.step == STEPS, "train step did not advance"
    assert all(np.isfinite(v) for v in losses), f"non-finite loss {losses}"
    assert losses[-1] < losses[0], (
        f"the sharded step does not learn: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{STEPS} overfit steps on a fixed batch")

    sums = make_eval_step(model, mesh=mesh)(local)
    n_eval = float(sums["n"])
    mean_iou = float(sums["iou_sum"]) / max(n_eval, 1.0)
    assert n_eval > 0, "eval step saw no valid ROIs"
    assert mean_iou > 0.0, "eval IoU is 0 after the overfit steps"

    # the trained weights served on the mesh and on one device
    images = host_batch["images"]
    rois = np.concatenate([np.repeat(np.arange(batch, dtype=np.float32), k)[:, None],
                           host_batch["boxes"].reshape(batch * k, 4)], axis=1)
    single = InferenceEngine(model, dilation_pixels=1, device=dev)
    sharded = InferenceEngine(model, dilation_pixels=1, device=dev, mesh=mesh)
    inst_1, bin_1 = single(images, rois)
    inst_m, bin_m = sharded(images, rois)
    np.testing.assert_allclose(inst_m, inst_1, atol=SERVE_ATOL)
    np.testing.assert_allclose(bin_m, bin_1, atol=SERVE_ATOL)
    return {"losses": losses, "eval_n": n_eval, "mean_iou": mean_iou,
            "serving_agreement": float(np.mean(inst_m == inst_1)),
            "binary_max_abs": float(np.max(np.abs(bin_m - bin_1)))}


def run_dryrun(n_devices: int, device: str = "cuda", backend: Optional[str] = None,
               verbose: bool = True, timeout: float = 600.0) -> Dict:
    """Run the dry run on ``n_devices`` ranks (module docstring) and return
    rank 0's report; any failed check raises."""
    from .launch import spawn

    reports = spawn(_dryrun_rank, n_devices, (device,), device=device, backend=backend,
                    timeout=timeout)
    for r, rep in enumerate(reports[1:], start=1):
        if rep["losses"] != reports[0]["losses"]:
            raise AssertionError(f"rank {r}'s losses differ from rank 0's")
    rep = reports[0]
    if verbose:
        print(f"dryrun({n_devices}, {device}): OK - loss {rep['losses'][0]:.4f} -> "
              f"{rep['losses'][-1]:.4f} over {STEPS} overfit steps, eval n={rep['eval_n']:.0f}, "
              f"mean IoU {rep['mean_iou']:.4f}; mesh serving == single-device within atol "
              f"{SERVE_ATOL} (mask agreement {rep['serving_agreement']:.3f}, binary max abs "
              f"{rep['binary_max_abs']:.2e})", flush=True)
    return rep
