"""Packed image stores and the batch transforms of training.

Port of the JAX package's ``data/records.py``. The store I/O and
``ImageStoreWriter`` are numpy copies. Two layouts, both uint8 images
``[N, H, W, C]`` + int64 labels ``[N]``: a compressed ``.npz`` (``images``,
``labels``), and a directory of ``images.npy`` + ``labels.npy`` that
memory-maps, for Celeb1M-scale sets (no decompression; a reader slices
rows lazily and normalizes on the device). Float images in [0, 1] are
stored as ``clip(x * 255)`` truncated to uint8. A store written by either
package loads in the other.

The transforms (``normalize_uint8``, ``prewhiten``,
``fixed_standardization``, ``rotate_batch``, ``augment_batch``) act on
``[B, H, W, C]`` tensors on their device; the random ones draw from a
``torch.Generator`` on that device, so they give other draws than the JAX
keys (the same distributions).
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

# XLA turns the jitted division by 255 into a product with this float32
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


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


_NPY_MAGIC = b"\x93NUMPY\x01\x00"
_NPY_HEADER_TOTAL = 128  # magic(6) + version(2) + hlen(2) + padded dict


def _npy_header_bytes(count: int, item_shape: tuple[int, ...]) -> bytes:
    """A fixed-width v1 ``.npy`` header for a uint8 array of shape
    ``(count, *item_shape)``: always ``_NPY_HEADER_TOTAL`` bytes, so the
    count can be rewritten in place after streaming appends."""
    shape = (count,) + tuple(int(s) for s in item_shape)
    d = ("{'descr': '|u1', 'fortran_order': False, "
         f"'shape': {shape!r}, }}")
    pad = _NPY_HEADER_TOTAL - len(_NPY_MAGIC) - 2 - 1 - len(d)
    if pad < 0:
        raise ValueError(f"header overflow for shape {shape}")
    header = d + " " * pad + "\n"
    return _NPY_MAGIC + struct.pack("<H", len(header)) + header.encode()


class ImageStoreWriter:
    """Streaming writer of the mmap store (``images.npy`` + ``labels.npy``)
    with O(batch) memory: images append behind a placeholder header that
    :meth:`close` patches with the final count, so the result loads with
    :func:`load_image_store_mmap`. A context manager, or call ``close``."""

    def __init__(self, dirpath: str, image_shape: tuple[int, int, int]):
        os.makedirs(dirpath, exist_ok=True)
        self.dirpath = dirpath
        self.image_shape = tuple(int(s) for s in image_shape)
        self._f = open(os.path.join(dirpath, "images.npy"), "wb")
        self._f.write(_npy_header_bytes(0, self.image_shape))
        self._labels: list[np.ndarray] = []
        self.count = 0
        self._closed = False

    def append(self, images: np.ndarray, labels: np.ndarray) -> None:
        images = np.ascontiguousarray(_as_uint8(images))
        if images.ndim == len(self.image_shape):  # a single image
            images = images[None]
        if tuple(images.shape[1:]) != self.image_shape:
            raise ValueError(
                f"image shape {images.shape[1:]} != store {self.image_shape}")
        labels = np.atleast_1d(np.asarray(labels, np.int64))
        if labels.shape[0] != images.shape[0]:
            raise ValueError("images/labels length mismatch")
        self._f.write(images.tobytes())
        self._labels.append(labels)
        self.count += images.shape[0]

    def close(self) -> None:
        if self._closed:
            return
        self._f.flush()
        self._f.seek(0)
        self._f.write(_npy_header_bytes(self.count, self.image_shape))
        self._f.close()
        labels = (np.concatenate(self._labels) if self._labels
                  else np.zeros((0,), np.int64))
        np.save(os.path.join(self.dirpath, "labels.npy"), labels)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1], as ``x * float32(1/255)`` (the
    jitted JAX division's form)."""
    return images.float() * _INV_255


def prewhiten(images: torch.Tensor) -> torch.Tensor:
    """Per-image standardization (facenet's prewhiten): subtract the image
    mean, divide by ``max(std, 1/sqrt(size))``. [B, H, W, C] or
    [H, W, C]."""
    dims = tuple(range(images.ndim - 3, images.ndim))
    x = images.float()
    mean = x.mean(dim=dims, keepdim=True)
    std = x.std(dim=dims, keepdim=True, correction=0)
    size = float(np.prod(x.shape[-3:]))
    return (x - mean) / torch.clamp_min(std, 1.0 / np.sqrt(size))


def fixed_standardization(images: torch.Tensor) -> torch.Tensor:
    """facenet's FIXED_STANDARDIZATION: ``(x * 255 - 127.5) / 128`` for
    [0, 1] inputs (uint8 inputs are scaled to [0, 1] first)."""
    x = normalize_uint8(images) if images.dtype == torch.uint8 \
        else images.float()
    return (x * 255.0 - 127.5) / 128.0


def rotate_batch(generator: torch.Generator, images: torch.Tensor,
                 max_degrees: float = 10.0) -> torch.Tensor:
    """Per-row random rotation about the image center (facenet's
    RANDOM_ROTATE), angles uniform in ``[-max_degrees, max_degrees)``:
    bilinear resampling, zero outside the frame (``map_coordinates(order=1,
    mode="constant")`` in the JAX package, ``grid_sample`` here)."""
    angles = (torch.rand(images.shape[0], generator=generator,
                         device=images.device) * 2.0 - 1.0) \
        * (max_degrees * np.pi / 180.0)
    return rotate_images(images, angles)


def rotate_images(images: torch.Tensor, radians: torch.Tensor) -> torch.Tensor:
    """Rotate each row of ``[B, H, W, C]`` by ``radians[b]`` about the
    image center: bilinear, zero outside the frame (what
    :func:`rotate_batch` does with its draws)."""
    b, h, w, _ = images.shape
    dev = images.device
    angles = radians.to(device=dev, dtype=torch.float32)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None, None]
    src_y = cy + (yy - cy) * cos - (xx - cx) * sin
    src_x = cx + (yy - cy) * sin + (xx - cx) * cos
    # grid_sample's [-1, 1] with align_corners=True maps onto pixel centers
    grid = torch.stack([src_x / max(w - 1, 1) * 2 - 1,
                        src_y / max(h - 1, 1) * 2 - 1], dim=-1)
    out = F.grid_sample(images.float().permute(0, 3, 1, 2), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def augment_batch(generator: torch.Generator, images: torch.Tensor, *,
                  mirror: bool = True,
                  crop_size: int | None = None) -> torch.Tensor:
    """Per-row random horizontal mirror (probability 1/2) and, with
    ``crop_size`` below the image side, an independent random
    ``crop_size`` x ``crop_size`` crop of each row (ImageRecordIter's
    rand_mirror / rand_crop), drawn from ``generator`` on the images'
    device."""
    b, h, w = images.shape[:3]
    dev = images.device
    if mirror:
        flip = torch.rand(b, generator=generator, device=dev) < 0.5
        images = torch.where(flip[:, None, None, None],
                             torch.flip(images, dims=(2,)), images)
    if crop_size is not None and crop_size < h:
        ys = torch.randint(0, h - crop_size + 1, (b,), generator=generator,
                           device=dev)
        xs = torch.randint(0, w - crop_size + 1, (b,), generator=generator,
                           device=dev)
        k = torch.arange(crop_size, device=dev)
        rows, cols = ys[:, None] + k, xs[:, None] + k
        images = images[torch.arange(b, device=dev)[:, None, None],
                        rows[:, :, None], cols[:, None, :]]
    return images
