"""Synthetic identity-clustered features for tests, benches, and demos.

A numpy copy of ``synthetic_features`` from the JAX package's
``data/synthetic.py``.

The reference has no test fixtures at all (SURVEY.md §4); these generators
stand in for Celeb1M-style data so every pipeline can run end-to-end without
the (unavailable) datasets.
"""

from __future__ import annotations

import numpy as np


def synthetic_features(
    num_ids: int = 64,
    per_id: int = 16,
    dim: int = 342,
    noise: float = 0.3,
    seed: int = 0,
    normalize: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster-per-identity feature rows: [N, dim] float32 + [N] int labels."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_ids, dim)).astype(np.float32)
    labels = np.repeat(np.arange(num_ids), per_id)
    rng.shuffle(labels)
    feats = centers[labels] + noise * rng.normal(size=(labels.size, dim)).astype(
        np.float32)
    if normalize:
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return feats.astype(np.float32), labels.astype(np.int64)
