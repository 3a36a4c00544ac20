"""Multi-process data-parallel exercise of ``init_distributed``: one real DP
train step and one eval step across processes, with the worker's
invariants asserted.

Counterpart of the JAX package's ``parallel/multihost.py`` (:1-152). Run
one process per rank, each on its own device:

    python -m human_instance_segmentation_tpu_torch.parallel.multihost \\
        --coordinator HOST:PORT --num_processes N --process_id I [--device cpu] [--backend gloo]

It runs on the GPU unless ``--device cpu`` is given (no CUDA raises); NCCL
on CUDA and Gloo on the CPU unless ``--backend`` names one (``gloo`` lets
two processes share one card). One process is one device here, so JAX's
``--local_devices`` (virtual CPU devices carved inside each process) has no
counterpart: a rank's local batch is one image.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def run_worker(process_id: int, num_processes: int, coordinator: str, device: str = "cuda",
               backend: Optional[str] = None, verbose: bool = True) -> float:
    """Join the process group, run one DP train step and one eval step of
    the tiny model, assert the JAX worker's invariants (the step advanced;
    the loss finite and bit-identical on every rank, compared by an
    all-gather; every global ROI scored once) and return the loss."""
    import numpy as np
    import torch

    from ..inference import init_weights
    from ..losses.hierarchical import RefinedLossConfig
    from ..models.assembly import HierarchicalInstanceSegmenter
    from ..training.optim import Transform, constant_schedule
    from ..training.state import TrainState
    from ..training.steps import make_eval_step, make_train_step
    from .mesh import all_gather, create_mesh, init_distributed, mesh_device, replicate

    n_global = init_distributed(coordinator_address=coordinator, num_processes=num_processes,
                                process_id=process_id, device=device, backend=backend)
    import torch.distributed as dist

    try:
        if verbose:
            print(f"[proc {process_id}] {dist.get_world_size()} processes, {n_global} global "
                  f"devices, backend {dist.get_backend()}", flush=True)
        assert dist.get_world_size() == num_processes
        mesh = create_mesh(n_global, device=torch.device(device).type)
        dev = mesh_device(mesh)

        # tiny shapes: this validates the cross-process topology, not accuracy
        ih, iw, rh, rw, mh, mw, k = 64, 64, 16, 12, 32, 24, 2
        local_batch = 1
        model = HierarchicalInstanceSegmenter(
            encoder_variant="tiny", roi_size=(rh, rw), mask_size=(mh, mw), image_size=(ih, iw),
            base_channels=16, depth=2, mid_channels=32, feature_dim=32,
            unet_decoder_channels=(32, 24, 16, 16, 8))
        init_weights(model, 0)
        model = replicate(mesh, model.to(dev))
        tx = Transform("adamw", constant_schedule(1e-4), weight_decay=1e-4, clip=1.0)
        state = TrainState.create(model, tx, seed=1)

        # each process feeds only its slice of the global batch, distinct by
        # its seed (what a per-host input pipeline produces)
        rng = np.random.default_rng(100 + process_id)
        shard = {
            "images": torch.as_tensor(rng.random((local_batch, ih, iw, 3), np.float32)),
            "boxes": torch.as_tensor(np.tile(np.asarray([[0.2, 0.2, 0.8, 0.8],
                                                          [0.1, 0.1, 0.6, 0.9]], np.float32),
                                             (local_batch, 1, 1))),
            "masks": torch.as_tensor(rng.integers(0, 3, (local_batch, k, mh, mw))
                                     .astype(np.int64)),
            "valid": torch.ones((local_batch, k)),
        }
        shard = {name: v.to(dev) for name, v in shard.items()}

        state, metrics = make_train_step(model, RefinedLossConfig(), mesh=mesh)(state, shard)
        assert state.step == 1, "train step did not advance"
        loss = metrics["total_loss"].float()
        assert bool(torch.isfinite(loss)), f"non-finite loss {float(loss)}"
        # the averaged loss must be bit-identical on every rank
        losses = all_gather(loss.reshape(1), mesh).cpu()
        assert losses.shape[0] == num_processes
        assert bool((losses == losses[0]).all()), losses.tolist()

        sums = make_eval_step(model, mesh=mesh)(shard)
        n_eval = float(sums["n"])
        # every global ROI (k valid per image, global batch) was scored once
        assert n_eval == k * local_batch * num_processes, n_eval
        if verbose:
            print(f"MULTIHOST OK proc={process_id} loss={float(loss):.6f} eval_n={n_eval:.0f}",
                  flush=True)
        return float(loss)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    args = ap.parse_args(argv)
    run_worker(args.process_id, args.num_processes, args.coordinator, device=args.device,
               backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
