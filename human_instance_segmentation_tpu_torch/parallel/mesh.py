"""Process-group mesh, sharding and collectives.

Counterpart of the JAX package's ``parallel/mesh.py`` (:1-65). The JAX mesh
is a grid of devices inside one program; here it is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one rank a device (rank r drives ``cuda:r % device_count``, or the
CPU), with the dim name :data:`DATA_AXIS`. A step under a mesh runs in
every rank on its own slice of the batch and meets the others in the
collectives below, where the JAX step meets them in its ``pmean``/``psum``.

Collectives (:func:`all_mean`, :func:`all_sum`, :func:`all_gather`,
:func:`broadcast_`) take many tensors at once and
flatten them into one buffer per dtype, so that a train step makes a few
collectives and not one per parameter. Gloo has no ``ReduceOp.AVG``, so the
mean is a SUM divided by the world size (at one rank ``x / 1``, the value
unchanged). Where the group's backend is Gloo and the tensors lie on the
GPU (two ranks sharing one card), the buffers go through the host
explicitly; NCCL takes them where they lie. Nothing picks Gloo where NCCL
was asked for.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
# every process group's timeout: a rank that dies fails the others' next
# collective within this, instead of leaving them waiting
INIT_TIMEOUT = timedelta(seconds=120)


def default_backend(device) -> str:
    """NCCL for a CUDA device, Gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return d


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None) -> int:
    """Join the process group (JAX ``mesh.py:21-35``, which calls
    ``jax.distributed.initialize``): with ``num_processes`` > 1,
    ``torch.distributed.init_process_group`` at ``tcp://<coordinator_address>``
    (``HOST:PORT`` of process 0) as rank ``process_id``, NCCL on CUDA and
    Gloo on the CPU unless ``backend`` names one, and a CUDA rank bound to
    ``cuda:process_id % device_count``. With no process count or a count of
    1 it starts nothing. Returns the world size of the group, or without one
    the local device count (the CUDA device count, 1 on the CPU), as JAX
    returns ``jax.device_count()``. ``device="cuda"`` raises where there is
    no CUDA."""
    dev = _check_device(device)
    if num_processes is not None and num_processes > 1:
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(process_id % torch.cuda.device_count())
            addr = coordinator_address or "127.0.0.1:29500"
            dist.init_process_group(backend or default_backend(dev),
                                    init_method=addr if "://" in addr else f"tcp://{addr}",
                                    world_size=num_processes, rank=process_id,
                                    timeout=INIT_TIMEOUT)
        return dist.get_world_size()
    if dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def create_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
                device=None):
    """1-D data-parallel mesh over the ranks of the process group (JAX
    ``mesh.py:38-45``), on ``device``'s type (by default CUDA where the
    group's backend is NCCL, else the CPU; pass ``"cuda"`` for Gloo ranks
    that share a card). ``n_devices`` past the world size raises
    ``ValueError("need N devices, have M")`` as JAX does; a mesh spans the
    whole group, so fewer than the world size raises too. Without a process
    group the world is one process, and a mesh needs the group: start one
    with :func:`init_distributed` or ``parallel.launch.spawn``."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices > world:
        raise ValueError(f"need {n_devices} devices, have {world}")
    if n_devices is not None and n_devices < world:
        raise ValueError(f"a mesh spans the whole process group: {n_devices} devices asked, "
                         f"the group has {world} ranks")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group (init_distributed or "
                           "parallel.launch.spawn)")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(torch.device(device).type, list(range(world)), mesh_dim_names=(axis_name,))


def batch_spec():
    """The batch's placement: its leading axis sharded over the data axis
    (JAX ``P("data")``)."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated_spec():
    """The parameters' placement: a full copy on every rank (JAX ``P()``)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def world_of(mesh) -> int:
    """The number of ranks of ``mesh`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size()


def rank_of(mesh) -> int:
    """This process's index along the data axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank()


def mesh_device(mesh) -> torch.device:
    """The device this rank drives in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _slice(x, rank: int, world: int, axis: int, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    n = t.shape[axis]
    if n % world:
        raise ValueError(f"batch axis of extent {n} does not divide {world} ranks")
    step = n // world
    return t.narrow(axis, rank * step, step).to(device)


def shard_batch(mesh, tree, axis: int = 0):
    """This rank's contiguous slice of every array of ``tree`` (a dict, list,
    tuple or one array) along ``axis``, as tensors on this rank's device.
    The slices are in rank order, as ``NamedSharding(P("data"))`` orders
    them across devices; every extent must divide the world size."""
    rank, world, dev = rank_of(mesh), world_of(mesh), mesh_device(mesh)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return _slice(x, rank, world, axis, dev)

    return walk(tree)


def _via_host(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _flat_collective(tensors: Sequence[torch.Tensor], mesh, run) -> List[torch.Tensor]:
    """Flatten ``tensors`` into one buffer per dtype, ``run(buffer, group)``
    it in place, and return the results shaped and laid out in memory like
    the inputs (a channels-last gradient stays channels-last, so that a
    reduction over it later, the optimizer's global norm, sums in the same
    order as without the collective)."""
    group = mesh.get_group()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        host = _via_host(group, flat)
        buf = flat.cpu() if host else flat
        run(buf, group)
        if host:
            buf = buf.to(flat.device)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = torch.empty_like(tensors[i]).copy_(buf[offset:offset + n]
                                                        .view(tensors[i].shape))
            offset += n
    return out


def all_sum(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor summed over the ranks (JAX ``psum``), new tensors."""
    return _flat_collective(tensors, mesh, lambda b, g: dist.all_reduce(b, dist.ReduceOp.SUM, g))


def all_mean(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each floating tensor averaged over the ranks (JAX ``pmean``): the SUM
    divided by the world size, in the tensor's dtype."""
    for t in tensors:
        if not t.is_floating_point():
            raise TypeError(f"all_mean of a {t.dtype} tensor")
    world = float(world_of(mesh))
    return [t / world for t in all_sum(tensors, mesh)]


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the leading axis
    in rank order: the global array of a batch-sharded one. Two-byte floats
    travel as float32 and bools as uint8 (both exact round trips), since
    Gloo carries neither type."""
    group = mesh.get_group()
    world = world_of(mesh)
    src = t.detach().contiguous()
    wire = (src.float() if src.dtype in (torch.bfloat16, torch.float16)
            else src.to(torch.uint8) if src.dtype == torch.bool else src)
    host = _via_host(group, wire)
    if host:
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=0) if t.dim() > 0 else torch.stack(parts)
    if host:
        out = out.to(t.device)
    return out.to(src.dtype) if out.dtype != src.dtype else out


def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0) -> None:
    """Overwrite every tensor with rank ``src``'s values, in place."""
    group = mesh.get_group()
    src_global = dist.get_global_rank(group, src) if group is not None else src
    values = _flat_collective(tensors, mesh,
                              lambda b, g: dist.broadcast(b, src_global, group=g))
    with torch.no_grad():
        for t, v in zip(tensors, values):
            t.copy_(v)


def all_gather_object(obj: Any, mesh) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    out: List[Any] = [None] * world_of(mesh)
    dist.all_gather_object(out, obj, group=mesh.get_group())
    return out


def replicate(mesh, module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers on every rank, overwritten in place;
    returns the module. The JAX ``replicate`` places one host value on
    every device; ranks that built their models from the same seed hold
    equal values already, and this makes sure of it."""
    tensors = list(module.parameters()) + list(module.buffers())
    if tensors:
        broadcast_(tensors, mesh)
    return module


def launched_world() -> Optional[int]:
    """``WORLD_SIZE`` where a launcher such as ``torchrun`` set it, else
    None."""
    w = os.environ.get("WORLD_SIZE")
    return int(w) if w else None
