"""Max-Feature-Map (MFM) and Extended-Feature-Map (EFM) activations.

Port of the JAX package's ``ops/mfm.py``. Both act on a channel axis that
defaults to the last one, the JAX layout (NHWC / ``[..., C]``):

- ``mfm2``: split channels into 2 halves, elementwise max. C -> C/2.
- ``efm3``: split channels into 3 slices, concat(max3, min3). C -> 2C/3.
  The max is max(max(s0, s1), s2) and the min min(min(s0, s1), s2).

``efm3`` runs on the ``[rows, C]`` view of the channel-last tensor: kernel
B2 (``ops/cuda/efm3.py``, CUDA C++) on a CUDA tensor, its plain version on
a CPU tensor; where a gradient is needed its backward is the kernel
``efm3_bwd`` (or the plain version's autograd on the CPU), so training
differentiates through it. ``efm3_plain`` is the same function on any
axis, in PyTorch.
"""

from __future__ import annotations

import torch

from .cuda.efm3 import efm3_rows


def mfm2(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """2-way max-feature-map: C -> C/2 along ``axis``."""
    c = x.shape[axis]
    if c % 2 != 0:
        raise ValueError(f"mfm2 requires an even channel count, got {c}")
    a, b = torch.chunk(x, 2, dim=axis)
    return torch.maximum(a, b)


def efm3_plain(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """3-way extended-feature-map, plain PyTorch: C -> 2C/3 along ``axis``."""
    c = x.shape[axis]
    if c % 3 != 0:
        raise ValueError(f"efm3 requires channels divisible by 3, got {c}")
    s0, s1, s2 = torch.chunk(x, 3, dim=axis)
    mx = torch.maximum(torch.maximum(s0, s1), s2)
    mn = torch.minimum(torch.minimum(s0, s1), s2)
    return torch.cat([mx, mn], dim=axis)


def efm3(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """3-way extended-feature-map: C -> 2C/3 along ``axis``.

    Kernel B2 for a CUDA tensor, its plain version for a CPU one, on the
    ``[rows, C]`` view: directly for a contiguous tensor whose channel axis
    is last (the models' activations), else after moving that axis last."""
    c = x.shape[axis]
    if axis in (-1, x.ndim - 1) and x.is_contiguous():
        out = efm3_rows(x.reshape(-1, c))
        return out.reshape(*x.shape[:-1], out.shape[1])
    xl = torch.movedim(x, axis, -1).contiguous()
    out = efm3_rows(xl.reshape(-1, c))
    return torch.movedim(out.reshape(*xl.shape[:-1], out.shape[-1]), -1, axis)
