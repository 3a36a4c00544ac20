"""Host-side data loading: worker threads, and device prefetch.

:class:`ThreadedLoader` is a copy of the JAX package's (``data/loader.py``):
a thread pool builds batches ahead of the train loop (PIL decode and numpy
work release the GIL), submitting lazily so that at most ``num_workers +
prefetch`` batches are in flight, in place of the reference's torch
DataLoader worker processes. :func:`prefetch_to_device` is PyTorch's form of
the JAX one: page-locked host tensors copied ``non_blocking`` on a side CUDA
stream, ahead of the consumer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Union

import numpy as np

from .dataset import collate


class ThreadedLoader:
    """Iterates batches assembled by worker threads, `prefetch` ahead.

    The batches, their order and the epochs are the JAX loader's. Unlike
    it, a consumer that closes an epoch's generator early (or drops it)
    also stops that epoch's threads (the producer waits on the queue with a
    timeout and leaves once ``stop`` is set), and a batch that fails to
    build raises its exception in the consumer instead of leaving it
    waiting.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(prefetch, 1)

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        n_usable = len(order) - (len(order) % self.batch_size if self.drop_last else 0)
        starts = list(range(0, n_usable, self.batch_size))

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def build(start):
            idxs = order[start:start + self.batch_size]
            return collate([self.dataset[int(i)] for i in idxs])

        def put(item) -> bool:
            # a consumer that stopped reading sets ``stop``: give up then
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # Submit lazily: at most num_workers + prefetch batches in flight,
            # so a stalled consumer (compile, checkpoint save) bounds host RAM
            # instead of letting the pool race an epoch ahead.
            max_inflight = self.num_workers + self.prefetch
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = [pool.submit(build, s) for s in starts[:max_inflight]]
                    next_start = max_inflight
                    try:
                        for f in pending:  # appended to while iterating
                            if stop.is_set() or not put(f.result()):
                                break
                            if next_start < len(starts):
                                pending.append(pool.submit(build, starts[next_start]))
                                next_start += 1
                    finally:
                        for f in pending:
                            f.cancel()
            except Exception as e:  # a failed batch ends the epoch in the consumer
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def forever(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1



def prefetch_to_device(iterator: Iterator[Dict[str, np.ndarray]], size: int = 2,
                       device: Optional[Union[str, "torch.device"]] = None
                       ) -> Iterator[Dict[str, "torch.Tensor"]]:
    """Batches of ``iterator`` as tensors on ``device`` (the card unless
    told otherwise), ``size`` of them on the device or on their way there,
    the one the consumer holds included (the JAX form's depth).

    On CUDA each batch is put in page-locked host memory and copied with
    ``non_blocking=True`` on a side stream, whose event the consumer's
    stream waits on before the batch is handed over; ``record_stream`` ties
    every device tensor to the consumer's stream, so the allocator reuses
    none while work queued there may still read it. The page-locked copies
    are kept until their batch is handed over. On the CPU the arrays become
    tensors and pass through.
    """
    import collections

    import torch

    from ..inference import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    if dev.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(dev)
    buf: "collections.deque" = collections.deque()

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: t.to(dev, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done, host

    def hand_over(entry):
        out, done, _ = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        return out

    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= size:
            yield hand_over(buf.popleft())
    while buf:
        yield hand_over(buf.popleft())
