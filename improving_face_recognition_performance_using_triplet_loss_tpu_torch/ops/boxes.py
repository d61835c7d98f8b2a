"""Box ops for the MTCNN cascade: keep-mask NMS and the PNet heatmap decode.

Port of the JAX package's ``ops/boxes.py`` (the part the device cascade
runs). Box layout: ``[x1, y1, x2, y2, score]`` rows; invalid rows carry a
score of -inf. ``nms_mask`` / ``nms_mask_batched`` launch kernel B5
(``ops/cuda/nms.py``) for CUDA tensors and run the plain
``nms_mask_plain`` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda.nms import nms_mask_batched as _nms_batched
from .cuda.nms import nms_mask_plain  # noqa: F401  (public re-export)


def nms_mask(boxes: torch.Tensor, threshold: float,
             method: str = "Union") -> torch.Tensor:
    """Keep mask of one box set, ``[N, 5] -> [N]`` bool (original order)."""
    return _nms_batched(boxes[None], threshold, method)[0]


def nms_mask_batched(boxes: torch.Tensor, threshold: float,
                     method: str = "Union") -> torch.Tensor:
    """Keep masks of S box sets, ``[S, N, 5] -> [S, N]`` bool, in one
    kernel launch on the card."""
    return _nms_batched(boxes, threshold, method)


def adversarial_nms_chain(n: int, width: float = 40.0) -> np.ndarray:
    """The dense-overlap worst case for NMS: one maximal alternating
    suppression chain. Unit-height boxes slide by width/4 with strictly
    descending scores, so consecutive IoU = 0.6 > 0.5 (suppresses) while
    skip-one IoU = 1/3 < 0.5 (does not): greedy keeps every even position
    and each decision depends on the previous one."""
    step = width / 4.0
    x = np.arange(n) * step
    scores = 1.0 - np.arange(n) / (2.0 * n)
    return np.stack([x, np.zeros(n), x + width, np.full(n, 1.0),
                     scores], 1).astype(np.float32)


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, ties broken
    toward the LOWER index (``torch.topk`` promises no order among ties,
    and -inf rows tie in bulk here)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_pnet_topk(imap: torch.Tensor, reg: torch.Tensor, scale: float,
                     threshold: float, k: int) -> torch.Tensor:
    """PNet heatmap decode with a fixed top-k capacity, batched.

    ``imap`` [..., H', W'] face probabilities and ``reg`` [..., H', W', 4]
    (image orientation) -> [..., k, 9] rows (q1(2) q2(2) score reg(4)).
    Same geometry as the oracle's ``generate_bounding_box`` (the map is
    transposed first; stride 2, cell 12); the k best cells >= threshold
    are kept and the rest carry a score of -inf."""
    stride, cellsize = 2.0, 12.0
    imap_t = imap.transpose(-1, -2)                     # [..., W', H']
    regs_t = reg.transpose(-2, -3)                      # [..., W', H', 4]
    flat = imap_t.reshape(*imap_t.shape[:-2], -1)
    neg_inf = torch.tensor(float("-inf"), dtype=flat.dtype, device=flat.device)
    th = torch.tensor(threshold, dtype=flat.dtype, device=flat.device)
    masked = torch.where(flat >= th, flat, neg_inf)
    k = min(k, flat.shape[-1])
    scores, idx = stable_topk(masked, k)
    w_dim = imap_t.shape[-1]
    ys = torch.div(idx, w_dim, rounding_mode="floor").float()
    xs = (idx % w_dim).float()
    regs = torch.gather(regs_t.reshape(*regs_t.shape[:-3], -1, 4), -2,
                        idx[..., None].expand(*idx.shape, 4))
    # the JAX stage runs under jit, where XLA turns the division by the
    # constant scale into a multiply by its float32 reciprocal; the trunc
    # below sees that product, so the port forms the same one
    inv = torch.tensor(np.float32(1.0) / np.float32(scale),
                       dtype=torch.float32, device=flat.device)
    q1y = torch.trunc((stride * ys + 1.0) * inv)
    q1x = torch.trunc((stride * xs + 1.0) * inv)
    q2y = torch.trunc((stride * ys + cellsize) * inv)
    q2x = torch.trunc((stride * xs + cellsize) * inv)
    boxes = torch.stack([q1y, q1x, q2y, q2x, scores], dim=-1)
    return torch.cat([boxes, regs], dim=-1)
