"""Synthetic identity-clustered datasets for tests, benches, and demos.

A numpy copy of ``synthetic_features`` and ``synthetic_faces`` from the JAX
package's ``data/synthetic.py`` (the same draws, so the same seed gives the
same arrays in both packages).

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


def synthetic_faces(
    num_ids: int = 8,
    per_id: int = 8,
    size: int = 64,
    seed: int = 0,
    channels: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Identity-structured 'face' images in [0, 1]:
    [N, size, size, channels] float32 + [N] int labels. Each identity is a
    fixed low-frequency pattern (per-channel phase shift for RGB) plus
    per-image noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    images, labels = [], []
    for i in range(num_ids):
        fx, fy = rng.uniform(1, 6), rng.uniform(1, 6)
        phases = rng.uniform(0, 6, size=channels)
        base = np.stack(
            [0.5 + 0.4 * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
             for ph in phases], axis=-1)
        for _ in range(per_id):
            img = base + 0.05 * rng.normal(size=(size, size, channels))
            images.append(np.clip(img, 0, 1))
            labels.append(i)
    order = rng.permutation(len(images))
    images = np.asarray(images, np.float32)[order]
    labels = np.asarray(labels, np.int64)[order]
    return images, labels
