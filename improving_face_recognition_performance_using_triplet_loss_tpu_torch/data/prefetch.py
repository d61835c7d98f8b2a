"""Host-to-device prefetching of training batches.

Port of the JAX package's ``data/prefetch.py`` (a ring of batches put on
the device ahead of use). On a CUDA device each batch's arrays are copied
into pinned host buffers and sent with ``non_blocking`` copies on a side
stream; an event recorded after the copies orders them before the compute
stream's use of the batch, so the copy of batch ``i + size`` overlaps the
steps on batches ``i .. i + size - 1``. On the CPU (``device="cpu"``) it
yields the same batches as tensors, unpinned.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=None) -> Iterator[tuple[torch.Tensor, ...]]:
    """Yield the tuples of arrays ``iterator`` yields as tensors on
    ``device`` (``cuda`` unless given), with up to ``size`` batches copied
    ahead of the one being consumed."""
    dev = resolve_device(device)
    it = iter(iterator)
    if dev.type != "cuda":
        for item in it:
            yield tuple(_host_tensor(a).to(dev) for a in item)
        return
    side = torch.cuda.Stream(dev)
    queue: collections.deque = collections.deque()

    def put() -> bool:
        try:
            item = next(it)
        except StopIteration:
            return False
        pinned = [_host_tensor(a).pin_memory() for a in item]
        with torch.cuda.stream(side):
            out = tuple(t.to(dev, non_blocking=True) for t in pinned)
            ready = torch.cuda.Event()
            ready.record(side)
        # the pinned buffers stay referenced until their batch is consumed
        queue.append((out, ready, pinned))
        return True

    for _ in range(size):
        if not put():
            break
    while queue:
        out, ready, _ = queue.popleft()
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(ready)
        for t in out:
            # memory made on the side stream, used on the compute stream
            t.record_stream(compute)
        put()
        yield out
