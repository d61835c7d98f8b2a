"""Triplet loss (gluon ``TripletLoss`` / FaceNet form).

Port of ``triplet_loss`` from the JAX package's ``losses/triplet.py``:

    L_i = max(sum_d (a_id - p_id)^2 - sum_d (a_id - n_id)^2 + margin, 0)

``normalize=True`` L2-normalizes each row first. The softmax cross-entropy
and the joint id + triplet loss come with the backbone slice (ROADMAP.md
A8).
"""

from __future__ import annotations

import torch

from ..ops.distances import l2_normalize


def triplet_loss(
    anchor: torch.Tensor,
    positive: torch.Tensor,
    negative: torch.Tensor,
    margin: float = 0.2,
    normalize: bool = False,
    reduction: str = "mean",
) -> torch.Tensor:
    """Triplet loss over [B, D] embeddings; ``reduction`` is ``"mean"`` or
    ``"none"``."""
    if reduction not in ("mean", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if normalize:
        anchor = l2_normalize(anchor)
        positive = l2_normalize(positive)
        negative = l2_normalize(negative)
    pos_d = torch.sum(torch.square(anchor - positive), dim=-1)
    neg_d = torch.sum(torch.square(anchor - negative), dim=-1)
    per_ex = torch.clamp_min(pos_d - neg_d + margin, 0.0)
    return per_ex.mean() if reduction == "mean" else per_ex
