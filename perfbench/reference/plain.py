"""Plain PyTorch building blocks of the references, over channel-last
(``[B, H, W, C]``) tensors, in float32.

Nothing here imports the program: these are the published layer equations
written out (EFM3 = concat(max, min) of three channel slices, MFM, 2x2
pooling, SAME convolutions), so the reference can be held against what the
program computes with its own kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
         padding: int = 0) -> torch.Tensor:
    """A stride-1 convolution of a ``[B, H, W, C]`` tensor with an OIHW
    kernel; returns ``[B, H', W', O]``."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, b,
                    padding=padding).permute(0, 2, 3, 1)


def efm3(x: torch.Tensor) -> torch.Tensor:
    """3-way extended feature map over the last axis: C -> 2C/3,
    ``concat(max(max(s0, s1), s2), min(min(s0, s1), s2))``."""
    s0, s1, s2 = torch.chunk(x, 3, dim=-1)
    return torch.cat([torch.maximum(torch.maximum(s0, s1), s2),
                      torch.minimum(torch.minimum(s0, s1), s2)], dim=-1)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of ``[B, H, W, C]``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def maxpool_tf(x: torch.Tensor, k: int, s: int, padding: str) -> torch.Tensor:
    """TF max-pool of ``[B, H, W, C]``: SAME pads with -inf, the extra row
    or column after."""
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        pads = []
        for n in (x.shape[2], x.shape[1]):
            need = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [need // 2, need - need // 2]
        xn = F.pad(xn, pads, value=float("-inf"))
    return F.max_pool2d(xn, k, s).permute(0, 2, 3, 1)


def l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization."""
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, -1, keepdim=True)),
                           min=eps)


def stem(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """5x5 SAME conv -> EFM3 -> 2x2 max-pool (the EFM nets' first layer)."""
    return maxpool2(efm3(conv(x, w, b, padding=2)))


def res_block(x: torch.Tensor, p: dict, prefix: str, blocks: int):
    """The residual EFM chain: ``blocks`` times
    ``x + conv_b(EFM3(conv_a(EFM3(x))))`` with 3x3 SAME convs."""
    for i in range(blocks):
        a, bb = f"{prefix}.conv_a.{i}", f"{prefix}.conv_b.{i}"
        h = conv(efm3(x), p[a + ".weight"], p[a + ".bias"], 1)
        h = conv(efm3(h), p[bb + ".weight"], p[bb + ".bias"], 1)
        x = x + h
    return x
