"""Packed image stores: the store I/O of the JAX package's
``data/records.py``, copied with numpy alone.

Two layouts, both uint8 images ``[N, H, W, C]`` + int64 labels ``[N]``: a
compressed ``.npz`` (``images``, ``labels``), and a directory of
``images.npy`` + ``labels.npy`` that memory-maps, for Celeb1M-scale sets
(no decompression; a reader slices rows lazily and normalizes on the
device). Float images in [0, 1] are stored as ``clip(x * 255)`` truncated
to uint8. A store written by either package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np


def _as_uint8(images) -> np.ndarray:
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = np.clip(images * 255.0, 0, 255).astype(np.uint8)
    return images


def save_image_store(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """images: [N, H, W, C] uint8 or float in [0,1]; labels: [N] ints."""
    np.savez_compressed(path, images=_as_uint8(images),
                        labels=np.asarray(labels, np.int64))


def load_image_store(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["images"], z["labels"]


def save_image_store_mmap(dirpath: str, images: np.ndarray,
                          labels: np.ndarray) -> None:
    """Memory-mappable variant for Celeb1M-scale sets (no decompression)."""
    os.makedirs(dirpath, exist_ok=True)
    np.save(os.path.join(dirpath, "images.npy"), _as_uint8(images))
    np.save(os.path.join(dirpath, "labels.npy"),
            np.asarray(labels, np.int64))


def load_image_store_mmap(dirpath: str):
    """``(images, labels)``: images a read-only uint8 memmap."""
    images = np.load(os.path.join(dirpath, "images.npy"), mmap_mode="r")
    labels = np.load(os.path.join(dirpath, "labels.npy"))
    return images, labels
