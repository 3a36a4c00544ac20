"""Start N ranks on this host, each in its own process, and collect their
results.

``spawn(fn, n, args)`` starts ``n`` processes with the ``spawn`` start
method, joins them into one process group at ``tcp://127.0.0.1:<free
port>`` (NCCL on CUDA and Gloo on the CPU unless ``backend`` names one,
with :data:`mesh.INIT_TIMEOUT`), calls ``fn(rank, *args)`` in each and
returns their results in rank order. ``fn`` must be a module-level function
(it is pickled by name) and its result picklable. Each rank binds
``cuda:rank % device_count`` on CUDA and takes an equal share of the host's
threads (``torch.set_num_threads``), so ranks on one host do not
oversubscribe it.

A rank that raises, or a run past ``timeout`` seconds, terminates every
rank and raises here with the failing rank's traceback: a rank that dies
never leaves the others waiting past their group's timeout, nor the caller
past its own. On CUDA the kernels are built once here, before the ranks
start, so that they do not each run ``nvcc``.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from .mesh import INIT_TIMEOUT, default_backend

# seconds a spawned run may take in all (the loops' ``--devices`` runs use it)
DEFAULT_TIMEOUT = 1800.0


def free_port() -> int:
    """A TCP port of this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device: str, backend: str, threads: int,
               fn: Callable, args: Sequence[Any], results) -> None:
    import torch.distributed as dist

    try:
        torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, timeout=INIT_TIMEOUT)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), device: str = "cpu",
          backend: Optional[str] = None, timeout: Optional[float] = None) -> List[Any]:
    """``[fn(0, *args), ..., fn(nprocs - 1, *args)]``, each rank in its own
    process of one process group (module docstring); ``timeout`` seconds
    in all, :data:`DEFAULT_TIMEOUT` (read at the call) by default."""
    timeout = DEFAULT_TIMEOUT if timeout is None else timeout
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        from ..ops import _build

        _build.library()
    backend = backend or default_backend(dev)
    threads = max(1, torch.get_num_threads() // nprocs)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, port, str(dev), backend, threads, fn, tuple(args),
                               results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish within {timeout:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    # a rank that died without a word (killed, out of memory);
                    # give its traceback, if one is on the way, a moment
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(nprocs)]


def check_devices(n: int, device) -> None:
    """``ValueError("need N devices, have M")`` for more CUDA ranks than this
    host has cards (NCCL takes one card a rank)."""
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise ValueError(f"need {n} devices, have {have}")


def should_spawn(n: Optional[int]) -> bool:
    """True where a run of ``n`` > 1 ranks must start them itself: no
    process group and no launcher (``WORLD_SIZE`` unset)."""
    import torch.distributed as dist

    from .mesh import launched_world

    return bool(n and n > 1) and not dist.is_initialized() and launched_world() is None


def join_mesh(n: int, device):
    """The mesh of a run of ``n`` ranks started by :func:`spawn` or by a
    launcher such as ``torchrun``: under a launcher the group is joined from
    its environment (``env://``, NCCL on CUDA, Gloo on the CPU), and its
    ``WORLD_SIZE`` must be ``n``."""
    import os

    import torch.distributed as dist

    from .mesh import create_mesh, launched_world

    if not dist.is_initialized():
        world = launched_world()
        if world != n:
            raise ValueError(f"{n} devices asked, but the launcher's WORLD_SIZE is {world}")
        if torch.device(device).type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(default_backend(device), init_method="env://",
                                timeout=INIT_TIMEOUT)
    if dist.get_world_size() != n:
        raise ValueError(f"{n} devices asked, the process group has {dist.get_world_size()}")
    return create_mesh(n, device=torch.device(device).type)
