"""Inputs made from the seed on the device, in a few large calls, then
handed to the host as a camera server or an image store holds them.

Images are smooth random fields (a coarse grid of random values
upsampled, plus fine noise) in uint8, so the nets see structure at every
scale. A face store gives each identity a field of its own and each of
its images that field plus its own variation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(seed) * 1_000_003 + 7919 * stream) % (1 << 63))
    return gen


def _field(gen, n, h, w, c, device, cell: int = 8):
    coarse = torch.randn((n, c, -(-h // cell) + 1, -(-w // cell) + 1),
                         generator=gen, device=device)
    up = F.interpolate(coarse, size=(h + cell, w + cell), mode="bilinear",
                       align_corners=False)[:, :, :h, :w]
    return up.permute(0, 2, 3, 1)


def frames(seed: int, n: int, h: int, w: int, device,
           chunk: int = 1024) -> torch.Tensor:
    """``[n, h, w, 3]`` uint8 frames on the host (pageable), made
    ``chunk`` at a time."""
    gen = generator(seed, 2, device)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        x = _field(gen, m, h, w, 3, device) * 60.0 + 128.0
        x = x + 12.0 * torch.randn(x.shape, generator=gen, device=device)
        out[i:i + m].copy_(x.clamp(0, 255).to(torch.uint8))
    return out


def face_store(seed: int, identities: int, per_id: int, hw, classes: int,
               device):
    """``(images [n, H, W, 1] uint8, labels [n] int64)`` numpy arrays:
    ``identities`` labels drawn from ``classes`` without replacement,
    ``per_id`` images each, rows grouped by identity."""
    gen = generator(seed, 3, device)
    h, w = hw
    ids = torch.randperm(classes, generator=gen, device=device)[:identities]
    base = _field(gen, identities, h, w, 1, device, cell=16)
    own = _field(gen, identities * per_id, h, w, 1, device)
    x = base.repeat_interleave(per_id, 0) * 50.0 + own * 20.0 + 128.0
    x = x + 8.0 * torch.randn(x.shape, generator=gen, device=device)
    images = x.clamp(0, 255).to(torch.uint8).cpu().numpy()
    labels = ids.repeat_interleave(per_id).cpu().numpy().astype(np.int64)
    return images, labels
