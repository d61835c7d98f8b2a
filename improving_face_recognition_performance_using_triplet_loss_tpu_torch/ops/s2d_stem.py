"""Stem helpers: space-to-depth packing and the unfused reference stem.

Port of the JAX package's ``ops/s2d_stem.py``. The stem of the EFM/LightCNN
nets is conv(5x5 SAME, Cin=1) -> {mfm2 | efm3} -> 2x2/2 max-pool.
``reference_stem`` is that unfused baseline in plain PyTorch: the numeric
oracle of kernel B3 and the path ``models.lightcnn.FusedStem`` takes for
training, on the CPU and for shapes the kernel does not take.
``space_to_depth2`` / ``pack_stem_weights`` give the space-to-depth form
(a 3x3x4 conv producing all four pooling phases as channel groups) that
the kernel's plain version (``ops/cuda/stem.py``) computes with.

Layouts are the JAX package's: x ``[B, H, W, 1]`` (NHWC), w ``[5, 5, 1, C]``
(HWIO), bias ``[C]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mfm import efm3, mfm2


def pack_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """[5, 5, 1, C] stride-1 SAME kernel -> [3, 3, 4, 4*C] space-to-depth
    kernel (input channels = (qi, qj) blocks; output channels phase-major
    (pi, pj) x C): W'[bi, bj, (qi, qj), (pi, pj), c] = w[2bi+qi-pi,
    2bj+qj-pj, 0, c], zero where the index leaves [0, 4]."""
    if tuple(w.shape[:3]) != (5, 5, 1):
        raise ValueError(f"expected [5, 5, 1, C] kernel, got {tuple(w.shape)}")
    c = w.shape[3]
    out = torch.zeros((3, 3, 2, 2, 2, 2, c), dtype=w.dtype, device=w.device)
    for bi in range(3):
        for bj in range(3):
            for qi in range(2):
                for qj in range(2):
                    for pi in range(2):
                        for pj in range(2):
                            di = 2 * bi + qi - pi
                            dj = 2 * bj + qj - pj
                            if 0 <= di <= 4 and 0 <= dj <= 4:
                                out[bi, bj, qi, qj, pi, pj] = w[di, dj, 0]
    return out.reshape(3, 3, 4, 4 * c)


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1] -> [B, H/2, W/2, 4] with channel index qi*2+qj."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2)
    return x.permute(0, 1, 3, 2, 4).reshape(b, h // 2, w // 2, 4)


def reference_stem(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                   maxout: int = 2) -> torch.Tensor:
    """The unfused stem: conv(5x5 SAME) + bias -> mfm2 | efm3 -> 2x2/2
    max-pool. x [B, H, W, Cin] -> [B, H/2, W/2, C_out] (NHWC)."""
    xn = x.permute(0, 3, 1, 2)
    y = F.conv2d(xn, w.permute(3, 2, 0, 1).to(x.dtype), padding=2)
    # the conv's dtype: under autocast (bf16 training) it is not x's
    y = y + bias.to(y.dtype)[None, :, None, None]
    y = y.permute(0, 2, 3, 1)
    y = mfm2(y) if maxout == 2 else efm3(y)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1)
