"""Row normalization, pairwise distances and gallery cosine similarities.

Port of the JAX package's ``ops/distances.py``. The pairwise products run
in full float32 under PyTorch's default matmul precision (TF32 off), as the
JAX package computes them at ``Precision.HIGHEST``: a TF32 product would
flip near-tie mining choices. Galleries are stored L2-normalized in f32,
bf16, or int8 on the 127 scale (``clip(round(127 x), -127, 127)``), whose
product with a probe quantized the same way is exact in int32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the rescale of an int8 x int8 product, as the float32 constant the JAX
# package multiplies by
_INV_127_SQ = float(np.float32(1.0 / (127.0 * 127.0)))


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


def _is_int8(dtype) -> bool:
    return dtype in (torch.int8, np.int8)


def _check_dtype(dtype) -> None:
    if not (_is_int8(dtype) or dtype in (torch.float32, torch.bfloat16)):
        raise ValueError(f"gallery dtype must be float32, bfloat16 or int8, "
                         f"got {dtype}")


def narrow_gallery(x: torch.Tensor, dtype) -> torch.Tensor:
    """Narrow L2-normalized gallery rows to the storage dtype; int8 stores
    ``round(127 x)`` clipped to [-127, 127] (ties to even, as
    ``jnp.round``)."""
    _check_dtype(dtype)
    if _is_int8(dtype):
        return torch.clamp(torch.round(x * 127.0), -127, 127).to(torch.int8)
    return x.to(dtype)


def narrow_gallery_np(gal_n: np.ndarray, dtype) -> torch.Tensor:
    """Host twin of :func:`narrow_gallery`: narrow normalized numpy rows
    before they are moved to the device (numpy has no bf16, so the result
    is a CPU tensor)."""
    _check_dtype(dtype)
    gal_n = np.ascontiguousarray(gal_n, np.float32)
    if _is_int8(dtype):
        return torch.from_numpy(
            np.clip(np.round(gal_n * 127.0), -127, 127).astype(np.int8))
    return torch.from_numpy(gal_n).to(dtype)


def int8_product(q: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """``[N, D] x [G, D]`` int8 -> ``[N, G]`` int32, exact.

    ``torch._int_mm`` (cuBLASLt on the card) takes the product only when
    N > 16 and D and G are multiples of 8, so both operands are padded with
    zero rows and columns, which add nothing to any sum; the int32
    accumulator cannot overflow for D * 127^2 < 2^31. Raises where the
    product cannot run: it never falls back to a float product."""
    n, d = q.shape
    g = gallery.shape[0]
    pad_d, pad_g = -d % 8, -g % 8
    pad_n = max(17 - n, 0)
    if pad_d or pad_n:
        q = F.pad(q, (0, pad_d, 0, pad_n))
    if pad_d or pad_g:
        gallery = F.pad(gallery, (0, pad_d, 0, pad_g))
    return torch._int_mm(q.contiguous(), gallery.contiguous().T)[:n, :g]


def gallery_sims(emb: torch.Tensor, gallery_n: torch.Tensor) -> torch.Tensor:
    """[..., D] normalized probes x [G, D] stored rows -> [..., G] cosine
    similarities in f32. bf16 rows are widened to f32 for the product, as
    the JAX package's f32 x bf16 matmul promotes. int8 rows meet the probe
    quantized to the same 127 grid in an exact int8 x int8 -> int32
    product (:func:`int8_product`), rescaled by 1/127^2 in f32."""
    if gallery_n.dtype == torch.int8:
        lead = emb.shape[:-1]
        q = narrow_gallery(emb.float(), torch.int8).reshape(-1, emb.shape[-1])
        sims = int8_product(q, gallery_n).float() * _INV_127_SQ
        return sims.reshape(*lead, gallery_n.shape[0])
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
