"""Anchor/positive pair construction (reference components C5, SURVEY.md §2).

A numpy copy of the JAX package's ``data/pairs.py``; the port imports
nothing of that package.

The reference scans the whole dataset to map each identity to its first-seen
image (``define_pos``, train_efm.py:37-45), then yields batches laid out as
``[anchors(B) | positives(B)]`` with duplicated labels (``DataIter``,
train_efm.py:47-114). train_efm materializes EVERY pair in host RAM (a
scalability cliff at 4.6M images, SURVEY.md §7 hard parts); the per-batch
variants (pre-trained_efm_v3.py:71-107) only look up positives per batch.

This module keeps the per-batch design: one O(N) pass builds an identity ->
canonical-row index, then batches pair anchors with ``data[pos_index[label]]``
lookups — O(B) per batch, streaming-friendly. Batches are returned as
``(anchor, positive, labels)`` (see train/steps.py for why the halves stay
separate: each shards cleanly over the data mesh axis).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def build_positive_index(labels: np.ndarray) -> np.ndarray:
    """First-seen row index per label value (define_pos semantics).

    Args:
      labels: [N] int array.

    Returns:
      [max_label + 1] int array mapping label -> first row index with that
      label (rows for absent labels are -1).
    """
    labels = np.asarray(labels).astype(np.int64).ravel()
    n_classes = int(labels.max()) + 1 if labels.size else 0
    index = np.full((n_classes,), -1, dtype=np.int64)
    # np.unique's return_index is the FIRST occurrence per value, matching
    # define_pos's "if label not in pos_img" insert-once behavior
    # (train_efm.py:42-43) — vectorized for 4.6M-row label arrays.
    uniq, first = np.unique(labels, return_index=True)
    index[uniq] = first
    return index


class PairBatcher:
    """Yield (anchor, positive, labels) batches from an in-memory dataset.

    Matches the reference DataIter layout with the canonical-positive lookup;
    optionally shuffles anchor order per epoch (ImageRecordIter shuffle=True,
    train_efm.py:179). Drops the final partial batch (RecordIO iterators do
    the same).
    """

    def __init__(
        self,
        data: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        positive_index: np.ndarray | None = None,
    ):
        self.data = np.asarray(data)
        self.labels = np.asarray(labels).astype(np.int64).ravel()
        if self.data.shape[0] != self.labels.shape[0]:
            raise ValueError("data/labels length mismatch")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.positive_index = (
            build_positive_index(self.labels)
            if positive_index is None else np.asarray(positive_index)
        )

    def __len__(self) -> int:
        return self.data.shape[0] // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        n = self.data.shape[0]
        order = (self._rng.permutation(n) if self.shuffle else np.arange(n))
        for start in range(0, n - self.batch_size + 1, self.batch_size):
            idx = order[start:start + self.batch_size]
            labels = self.labels[idx]
            anchor = self.data[idx]
            positive = self.data[self.positive_index[labels]]
            yield anchor, positive, labels
