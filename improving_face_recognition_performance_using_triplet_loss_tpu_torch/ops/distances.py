"""Row normalization, pairwise distances and gallery cosine similarities.

Port of the JAX package's ``ops/distances.py``. The pairwise products run
in full float32 under PyTorch's default matmul precision (TF32 off), as the
JAX package computes them at ``Precision.HIGHEST``: a TF32 product would
flip near-tie mining choices. Galleries are stored L2-normalized in f32 or bf16; the int8
127-scale storage is not ported yet (ROADMAP.md A, item "int8 galleries").
"""

from __future__ import annotations

import numpy as np
import torch

_INT8_TODO = ("int8 gallery storage is not ported yet (ROADMAP.md queue A, "
              "'DeviceGallery and int8 galleries')")


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization with an eps clamp on the norm."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def l2_normalize_np(x, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    """Host-side (numpy) twin of :func:`l2_normalize`."""
    x = np.asarray(x, np.float32)
    norm = np.sqrt(np.sum(np.square(x), axis=axis, keepdims=True))
    return x / np.maximum(norm, eps)


def _check_dtype(dtype) -> None:
    if dtype in (torch.int8, np.int8, "int8"):
        raise NotImplementedError(_INT8_TODO)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gallery dtype must be float32 or bfloat16, "
                         f"got {dtype}")


def narrow_gallery(x: torch.Tensor, dtype) -> torch.Tensor:
    """Narrow L2-normalized gallery rows to the storage dtype."""
    _check_dtype(dtype)
    return x.to(dtype)


def narrow_gallery_np(gal_n: np.ndarray, dtype) -> torch.Tensor:
    """Host twin of :func:`narrow_gallery`: narrow normalized numpy rows
    before they are moved to the device (numpy has no bf16, so the result
    is a CPU tensor)."""
    _check_dtype(dtype)
    return torch.from_numpy(np.ascontiguousarray(gal_n, np.float32)).to(dtype)


def gallery_sims(emb: torch.Tensor, gallery_n: torch.Tensor) -> torch.Tensor:
    """[..., D] normalized probes x [G, D] stored rows -> [..., G] cosine
    similarities in f32. bf16 rows are widened to f32 for the product, as
    the JAX package's f32 x bf16 matmul promotes."""
    if gallery_n.dtype == torch.int8:
        raise NotImplementedError(_INT8_TODO)
    return emb.float() @ gallery_n.float().T


def pairwise_sq_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] squared euclidean distances, through the
    ``|a|^2 + |b|^2 - 2ab`` identity (one matmul), clamped at 0."""
    a2 = torch.sum(torch.square(a), dim=-1, keepdim=True)          # [N, 1]
    b2 = torch.sum(torch.square(b), dim=-1, keepdim=True).T        # [1, M]
    ab = a @ b.T                                                   # [N, M]
    return torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)


def pairwise_cosine(a: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] cosine similarities."""
    return l2_normalize(a, eps=eps) @ l2_normalize(b, eps=eps).T


def rowwise_cosine(a: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    """Row-i-vs-row-i cosine similarity, [N, D] x [N, D] -> [N]."""
    dot = torch.sum(a * b, dim=-1)
    na = torch.sqrt(torch.sum(torch.square(a), dim=-1))
    nb = torch.sqrt(torch.sum(torch.square(b), dim=-1))
    return dot / torch.clamp(na * nb, min=eps)
