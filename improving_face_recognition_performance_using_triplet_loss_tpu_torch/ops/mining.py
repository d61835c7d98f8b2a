"""In-batch negative mining: random, semi-hard and hard negatives.

Port of the JAX package's ``ops/mining.py``. Every miner returns one int32
pool index per anchor. Ties break to the first index (``torch.argmin`` and
``torch.argmax`` return the first extremum, as ``jnp.argmin`` /
``jnp.argmax`` do), and an anchor with no negative in the pool gets index
0, as in the JAX package.

The semi-hard miner follows FaceNet: among the negatives with
``d(a, n) > d(a, p)`` take the closest; when there is none, the farthest
negative. Kernel B1 (``ops/cuda/mining.py``) computes the same index with
the distances fused in.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30
_POS_INF = 1e30


def _different_label_mask(anchor_labels: torch.Tensor,
                          cand_labels: torch.Tensor) -> torch.Tensor:
    """[B] x [N] -> [B, N], True where the candidate's label differs."""
    return anchor_labels[:, None] != cand_labels[None, :]


def mine_random_negative(
    generator: torch.Generator,
    anchor_labels: torch.Tensor,
    cand_labels: torch.Tensor,
    num_candidates: int | None = None,
) -> torch.Tensor:
    """A uniform random candidate with a different label, per anchor.

    A Gumbel-max draw over the valid candidates, an exact uniform sample.
    ``generator`` lives on the labels' device. ``num_candidates``
    restricts the draw to the first k pool rows. No torch generator gives
    ``jax.random.gumbel``'s numbers, so the indices differ from the JAX
    package's for the same seed; the distribution is the same.
    """
    b, n = anchor_labels.shape[0], cand_labels.shape[0]
    mask = _different_label_mask(anchor_labels, cand_labels)
    if num_candidates is not None:
        col = torch.arange(n, device=mask.device)
        mask = mask & (col < num_candidates)[None, :]
    u = torch.rand((b, n), generator=generator, device=mask.device)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(mask, gumbel, torch.full_like(gumbel, _NEG_INF))
    return torch.argmax(scores, dim=-1).to(torch.int32)


def mine_semi_hard_negative(
    sq_dists: torch.Tensor,
    pos_sq_dists: torch.Tensor,
    anchor_labels: torch.Tensor,
    cand_labels: torch.Tensor,
) -> torch.Tensor:
    """FaceNet semi-hard negative per anchor: ``sq_dists`` [B, N]
    anchor-to-candidate squared distances, ``pos_sq_dists`` [B] -> [B]
    int32 indices."""
    neg_mask = _different_label_mask(anchor_labels, cand_labels)
    semi_mask = neg_mask & (sq_dists > pos_sq_dists[:, None])
    semi_idx = torch.argmin(
        torch.where(semi_mask, sq_dists, torch.full_like(sq_dists, _POS_INF)),
        dim=-1)
    has_semi = torch.any(semi_mask, dim=-1)
    far_idx = torch.argmax(
        torch.where(neg_mask, sq_dists, torch.full_like(sq_dists, _NEG_INF)),
        dim=-1)
    return torch.where(has_semi, semi_idx, far_idx).to(torch.int32)


def mine_hard_negative(
    sq_dists: torch.Tensor,
    anchor_labels: torch.Tensor,
    cand_labels: torch.Tensor,
) -> torch.Tensor:
    """The hardest (closest) negative per anchor: [B, N] -> [B] int32."""
    neg_mask = _different_label_mask(anchor_labels, cand_labels)
    d = torch.where(neg_mask, sq_dists, torch.full_like(sq_dists, _POS_INF))
    return torch.argmin(d, dim=-1).to(torch.int32)


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, D] pool + [B] indices -> [B, D] rows (the gradient flows back
    into ``pool``)."""
    return torch.index_select(pool, 0, idx.long())
