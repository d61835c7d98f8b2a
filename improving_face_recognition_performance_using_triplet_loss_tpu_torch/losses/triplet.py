"""Triplet, softmax cross-entropy and joint losses.

Port of the JAX package's ``losses/triplet.py``. The triplet loss (gluon
``TripletLoss`` / FaceNet form):

    L_i = max(sum_d (a_id - p_id)^2 - sum_d (a_id - n_id)^2 + margin, 0)

``normalize=True`` L2-normalizes each row first. The backbone's objective
is ``softmax_CE(anchor logits) + alpha * triplet(normalized a, p, n)``
(``joint_id_triplet_loss``, alpha 0.1 and margin 0.2 in the reference).
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


def _reduce(per_ex: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return per_ex.mean()
    if reduction == "none":
        return per_ex
    raise ValueError(f"unknown reduction {reduction!r}")


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          reduction: str = "mean") -> torch.Tensor:
    """Sparse softmax cross-entropy of ``logits`` [B, C] against integer
    ``labels`` [B] (gluon ``SoftmaxCrossEntropyLoss``)."""
    logz = torch.log_softmax(logits, dim=-1)
    per_ex = -torch.gather(logz, 1, labels.long()[:, None])[:, 0]
    return _reduce(per_ex, reduction)


def joint_id_triplet_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    anchor: torch.Tensor,
    positive: torch.Tensor,
    negative: torch.Tensor,
    margin: float = 0.2,
    alpha: float = 0.1,
    normalize_embeddings: bool = True,
):
    """``id_CE + alpha * triplet``; ``logits`` / ``labels`` are the anchor
    half only. Returns ``(total, id_loss, tl_loss)``."""
    id_loss = softmax_cross_entropy(logits, labels)
    tl = triplet_loss(anchor, positive, negative, margin=margin,
                      normalize=normalize_embeddings)
    return id_loss + alpha * tl, id_loss, tl
