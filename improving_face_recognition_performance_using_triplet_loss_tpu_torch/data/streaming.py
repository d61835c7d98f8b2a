"""Celeb1M-scale streaming input: sharded pair batching over an mmap store.

A numpy copy of the JAX package's ``data/streaming.py`` (the port imports
nothing of that package), so the same seed gives the same batches:

- each host takes a contiguous row shard (``shard_bounds``; KVStore
  ``part_index`` semantics);
- a two-level windowed shuffle: the order of fixed-size windows, then the
  rows within each window, which bounds the random reads to one window;
- anchors pair with the first-seen row of their identity (``define_pos``),
  looked up in the whole store;
- batches stay uint8 until the train step normalizes them on the device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .pairs import build_positive_index
from .records import load_image_store_mmap


def shard_bounds(n: int, host_id: int, num_hosts: int) -> tuple[int, int]:
    """Contiguous ``[start, stop)`` row range of host ``host_id``'s shard;
    the first ``n % num_hosts`` hosts take one row more."""
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} out of range for {num_hosts}")
    base, rem = divmod(n, num_hosts)
    start = host_id * base + min(host_id, rem)
    return start, start + base + (1 if host_id < rem else 0)


class ShardedPairBatcher:
    """Yield uint8 ``(anchor, positive, labels)`` batches from an mmap image
    store, optionally one host's shard of it; ``PairBatcher`` semantics
    (canonical positive, the last partial batch dropped) without ever
    materializing the dataset.

    ``store`` is a store directory or an ``(images, labels)`` pair (images
    may be a memmap). ``shuffle_window`` rows per shuffle window; ``0`` or
    at least the shard size is one in-shard permutation."""

    def __init__(self, store, batch_size: int, *, host_id: int = 0,
                 num_hosts: int = 1, shuffle: bool = True,
                 shuffle_window: int = 65536, seed: int = 0,
                 positive_index: np.ndarray | None = None):
        if isinstance(store, (str, bytes)):
            self.images, self.labels = load_image_store_mmap(store)
        else:
            self.images, self.labels = store
        self.labels = np.asarray(self.labels).astype(np.int64).ravel()
        n = self.images.shape[0]
        if n != self.labels.shape[0]:
            raise ValueError("images/labels length mismatch")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.shuffle_window = int(shuffle_window)
        self._rng = np.random.default_rng(seed)
        self.start, self.stop = shard_bounds(n, host_id, num_hosts)
        self.positive_index = (
            build_positive_index(self.labels)
            if positive_index is None else np.asarray(positive_index))

    @property
    def shard_size(self) -> int:
        return self.stop - self.start

    def __len__(self) -> int:
        return self.shard_size // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        rows = np.arange(self.start, self.stop, dtype=np.int64)
        if not self.shuffle:
            return rows
        w = self.shuffle_window
        if w <= 0 or w >= rows.size:
            return self._rng.permutation(rows)
        n_win = (rows.size + w - 1) // w
        out = np.empty_like(rows)
        pos = 0
        for win in self._rng.permutation(n_win):
            chunk = rows[win * w:(win + 1) * w]
            out[pos:pos + chunk.size] = self._rng.permutation(chunk)
            pos += chunk.size
        return out

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = self._epoch_order()
        bs = self.batch_size
        for start in range(0, order.size - bs + 1, bs):
            idx = np.sort(order[start:start + bs])  # sorted: sequential reads
            labels = self.labels[idx]
            anchor = np.asarray(self.images[idx])
            positive = np.asarray(self.images[self.positive_index[labels]])
            yield anchor, positive, labels
