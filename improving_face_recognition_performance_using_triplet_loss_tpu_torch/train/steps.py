"""Triplet-head train and eval steps.

Port of ``make_head_train_step``, ``make_head_eval_step``, ``_mine`` and
``_pool`` from the JAX package's ``train/steps.py``. A step takes
``(state, anchor, positive, labels)`` -- numpy arrays or tensors, moved to
the state's device -- forms the pool ``[anchor | positive]`` of head
outputs, mines one negative per anchor, and returns the triplet loss with
the per-row ``pos_cos`` / ``neg_cos`` metrics. The train step also takes
the SGD update (and the EMA) in place.

Mining runs on detached, L2-normalized rows; the negative is then gathered
from the un-normalized pool, and that gather carries the gradient, as in
the JAX package. ``semi_hard_fused`` mines with kernel B1
(``ops/cuda/mining.py``); ``semi_hard`` and ``hard`` materialize the
``[B, 2B]`` distances; ``random`` draws from the step's generator. Data
parallelism (the JAX ``axis_name``) is ROADMAP.md A10.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..losses.triplet import triplet_loss
from ..ops import mining
from ..ops.cuda.mining import semi_hard_mining
from ..ops.distances import l2_normalize, pairwise_sq_l2, rowwise_cosine
from .state import TrainState, step_generator

Metrics = dict[str, torch.Tensor]

HEAD_METRIC_KEYS = ("loss", "pos_cos", "neg_cos")
MINING_MODES = ("random", "semi_hard", "semi_hard_fused", "hard")


def _mine(
    mining_mode: str,
    generator: torch.Generator | None,
    anc: torch.Tensor,
    pos: torch.Tensor,
    pool_feat: torch.Tensor,
    anchor_labels: torch.Tensor,
    pool_labels: torch.Tensor,
) -> torch.Tensor:
    """Pick one negative row of ``pool_feat`` per anchor; returns [B, D]."""
    if mining_mode == "random":
        idx = mining.mine_random_negative(generator, anchor_labels,
                                          pool_labels)
    else:
        with torch.no_grad():
            anc_n = l2_normalize(anc.detach())
            pool_n = l2_normalize(pool_feat.detach())
            pos_sq = torch.sum(
                torch.square(anc_n - l2_normalize(pos.detach())), dim=-1)
            if mining_mode == "semi_hard_fused":
                idx = semi_hard_mining(anc_n, pos_sq, anchor_labels, pool_n,
                                       pool_labels)
            elif mining_mode == "semi_hard":
                idx = mining.mine_semi_hard_negative(
                    pairwise_sq_l2(anc_n, pool_n), pos_sq, anchor_labels,
                    pool_labels)
            else:
                idx = mining.mine_hard_negative(
                    pairwise_sq_l2(anc_n, pool_n), anchor_labels,
                    pool_labels)
    return mining.gather_rows(pool_feat, idx)


def _pool(anc, pos, labels):
    """Mining candidate pool: the batch's ``[anc | pos]`` rows."""
    return torch.cat([anc, pos], dim=0), torch.cat([labels, labels], dim=0)


def _inputs(state: TrainState, anchor, positive, labels, normalize: bool):
    dev = state.device
    anchor = torch.as_tensor(anchor, dtype=torch.float32, device=dev)
    positive = torch.as_tensor(positive, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev).to(torch.int32)
    if normalize:
        anchor, positive = l2_normalize(anchor), l2_normalize(positive)
    return anchor, positive, labels


def _check_mode(mining_mode: str) -> None:
    if mining_mode not in MINING_MODES:
        raise ValueError(f"unknown mining mode {mining_mode!r}; choose from "
                         f"{MINING_MODES}")


def make_head_train_step(
    *,
    margin: float = 0.5,
    mining_mode: str = "random",
    normalize_inputs: bool = False,
    normalize_embeddings: bool = False,
) -> Callable[..., tuple[TrainState, Metrics]]:
    """Triplet-only head step: a linear head over precomputed features,
    margin 0.5, SGD. ``normalize_embeddings`` takes the loss on
    L2-normalized head outputs; the reference trains on raw outputs."""
    _check_mode(mining_mode)

    def step(state: TrainState, anchor, positive, labels):
        gen = step_generator(state) if mining_mode == "random" else None
        anchor, positive, labels = _inputs(state, anchor, positive, labels,
                                           normalize_inputs)
        b = anchor.shape[0]
        emb = state.model(torch.cat([anchor, positive], dim=0))
        anc, pos = emb[:b], emb[b:]
        pool_feat, pool_labels = _pool(anc, pos, labels)
        neg = _mine(mining_mode, gen, anc, pos, pool_feat, labels,
                    pool_labels)
        tl = triplet_loss(anc, pos, neg, margin=margin,
                          normalize=normalize_embeddings)
        state.optimizer.zero_grad(set_to_none=True)
        tl.backward()
        with torch.no_grad():
            metrics = {"loss": tl.detach(),
                       "pos_cos": rowwise_cosine(anc, pos),
                       "neg_cos": rowwise_cosine(anc, neg)}
        state.apply_update()
        return state, metrics

    return step


def make_head_eval_step(
    *,
    margin: float = 0.5,
    mining_mode: str = "random",
    normalize_inputs: bool = False,
) -> Callable[..., Metrics]:
    """Head validation. With an identity head and
    ``normalize_inputs=True`` it is also the no-training cosine
    measurement of ``eval_cos``."""
    _check_mode(mining_mode)

    @torch.no_grad()
    def step(state: TrainState, anchor, positive, labels) -> Metrics:
        gen = step_generator(state) if mining_mode == "random" else None
        anchor, positive, labels = _inputs(state, anchor, positive, labels,
                                           normalize_inputs)
        b = anchor.shape[0]
        emb = state.model(torch.cat([anchor, positive], dim=0))
        anc, pos = emb[:b], emb[b:]
        pool_feat, pool_labels = _pool(anc, pos, labels)
        neg = _mine(mining_mode, gen, anc, pos, pool_feat, labels,
                    pool_labels)
        return {"loss": triplet_loss(anc, pos, neg, margin=margin),
                "pos_cos": rowwise_cosine(anc, pos),
                "neg_cos": rowwise_cosine(anc, neg)}

    return step
