"""Trainable embedding head over frozen features.

Port of the JAX package's ``models/heads.py``: one bias-free dense layer,
128-d over the 342-d features by default. The weight is an ``nn.Linear``
(``[out, in]``); ``flax_params`` / ``load_flax_params`` carry it to and
from the flax tree ``{"proj": {"kernel": [in, out]}}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .lightcnn import lecun_normal_


class LinearHead(nn.Module):
    """Bias-free linear projection ``[B, in_dim] -> [B, out_dim]``, float32.

    Initialised as flax's ``Dense`` is (lecun_normal, drawn in the
    ``[in, out]`` layout) from ``generator``."""

    def __init__(self, in_dim: int, out_dim: int = 128, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.proj = nn.Linear(in_dim, out_dim, bias=False)
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            self.proj.weight.copy_(
                lecun_normal_(torch.empty(in_dim, out_dim), in_dim, gen).T)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.float())

    def flax_params(self) -> dict:
        w = self.proj.weight.detach().float().cpu().T
        return {"proj": {"kernel": np.ascontiguousarray(w.numpy())}}

    @torch.no_grad()
    def load_flax_params(self, params: dict) -> "LinearHead":
        k = torch.tensor(np.asarray(params["proj"]["kernel"], np.float32))
        if tuple(k.shape) != (self.in_dim, self.out_dim):
            raise ValueError(f"kernel of shape {tuple(k.shape)} for a "
                             f"{self.in_dim}->{self.out_dim} head")
        self.proj.weight.copy_(k.T)
        return self
