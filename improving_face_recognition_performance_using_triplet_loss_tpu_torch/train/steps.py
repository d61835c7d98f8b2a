"""Train and eval steps: the joint backbone step and the triplet head's.

Port of ``make_backbone_train_step``, ``make_backbone_eval_step``,
``make_head_train_step``, ``make_head_eval_step``, ``make_scanned_step``,
``_mine`` and ``_pool`` from the JAX package's ``train/steps.py``. A step
takes ``(state, anchor, positive, labels)`` -- numpy arrays or tensors,
moved to the state's device -- runs the model over ``[anchor | positive]``,
mines one negative per anchor from that pool, and returns its metrics; a
train step also takes the optimizer update (and the EMA) in place. The
JAX step is one jitted program; here it runs eagerly, its randomness
(augmentation, dropout, ``random`` mining) drawn from the generator of
``(seed, step)``.

Mining runs on detached, L2-normalized rows; the negative is then gathered
from the un-normalized pool, and that gather carries the gradient, as in
the JAX package. ``semi_hard_fused`` mines with kernel B1
(``ops/cuda/mining.py``); ``semi_hard`` and ``hard`` materialize the
``[B, 2B]`` distances; ``random`` draws from the step's generator. Data and
class parallelism (the JAX ``axis_name`` / ``class_axis_name``) are
ROADMAP.md A10. ``bwd_im2col=True`` routes every eligible conv through
``ops.conv_backward.conv2d_fg_im2col`` (dW as an explicit im2col matmul).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
import torch.utils.checkpoint

from ..data.records import augment_batch, normalize_uint8
from ..losses.center import center_loss
from ..losses.triplet import joint_id_triplet_loss, triplet_loss
from ..models.lightcnn import Dropout
from ..ops import mining
from ..ops.conv_backward import conv_interceptor_im2col_bwd
from ..ops.cuda.mining import semi_hard_mining
from ..ops.distances import l2_normalize, pairwise_sq_l2, rowwise_cosine
from .state import TrainState, step_generator

Metrics = dict[str, torch.Tensor]

BACKBONE_METRIC_KEYS = ("loss", "id_loss", "tl_loss", "acc", "pos_cos",
                        "neg_cos")
HEAD_METRIC_KEYS = ("loss", "pos_cos", "neg_cos")
MINING_MODES = ("random", "semi_hard", "semi_hard_fused", "hard")
REMAT_POLICIES = (None, "full", "dots")
_ROADMAP = "ROADMAP.md queue A"


def _mine(
    mining_mode: str,
    generator: torch.Generator | None,
    anc: torch.Tensor,
    pos: torch.Tensor,
    pool_feat: torch.Tensor,
    anchor_labels: torch.Tensor,
    pool_labels: torch.Tensor,
    num_candidates: int | None = None,
) -> torch.Tensor:
    """Pick one negative row of ``pool_feat`` per anchor; returns [B, D].
    ``num_candidates`` restricts ``random`` draws to the first rows of the
    pool (the other modes ignore it, as in the JAX package)."""
    if mining_mode == "random":
        idx = mining.mine_random_negative(generator, anchor_labels,
                                          pool_labels, num_candidates)
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


# ---------------------------------------------------------------- backbone


def _check_unported(axis_name, class_axis_name) -> None:
    if axis_name is not None or class_axis_name is not None:
        raise NotImplementedError(
            "data and class parallelism (axis_name / class_axis_name) are "
            f"not ported; queued in {_ROADMAP}, item 10")


def _images(state: TrainState, anchor, positive, labels):
    """``[anchor | positive]`` on the state's device as float32 (uint8
    batches scaled there, as ``x * float32(1/255)``: the jitted JAX step's
    form), and int32 labels."""
    dev = state.device
    images = torch.cat([torch.as_tensor(anchor, device=dev),
                        torch.as_tensor(positive, device=dev)], dim=0)
    images = normalize_uint8(images) if images.dtype == torch.uint8 \
        else images.float()
    return images, torch.as_tensor(labels, device=dev).to(torch.int32)


def _autocast(device: torch.device, dtype: torch.dtype | None):
    """flax's ``dtype``: float32 parameters, compute in ``dtype``."""
    if dtype is None or dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the outputs of
    convolutions and matrix products, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    saved = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _im2col_embed(model):
    """``model.embed`` with every eligible conv on the im2col filter
    gradient (the route is entered inside, so a remat recomputation takes
    it too)."""

    def embed(x):
        with conv_interceptor_im2col_bwd():
            return model.embed(x)

    return embed


def _embed_fn(model, remat_policy: str | None, bwd_im2col: bool = False):
    """``model.embed`` (on the im2col filter gradient for ``bwd_im2col``),
    under ``torch.utils.checkpoint`` for a remat policy: ``"full"`` saves
    nothing of it, ``"dots"`` only conv and matmul outputs. Dropout and
    BatchNorm run after it (``classify``), so the recomputation redraws
    nothing and moves no statistics."""
    embed = _im2col_embed(model) if bwd_im2col else model.embed
    if remat_policy is None:
        return embed
    if remat_policy == "full":
        return functools.partial(torch.utils.checkpoint.checkpoint,
                                 embed, use_reentrant=False)
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return functools.partial(
        torch.utils.checkpoint.checkpoint, embed, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy))


def _set_dropout_generator(model: torch.nn.Module,
                           generator: torch.Generator | None) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def _backbone_losses(logits, feat, labels, gen, mining_mode, margin, alpha,
                     num_candidates):
    """The joint loss and the metrics shared by the train and eval steps;
    returns ``(total, metrics, anc)``."""
    b = labels.shape[0]
    anc, pos = feat[:b], feat[b:]
    pool_feat, pool_labels = _pool(anc, pos, labels)
    neg = _mine(mining_mode, gen, anc, pos, pool_feat, labels, pool_labels,
                num_candidates)
    total, id_loss, tl = joint_id_triplet_loss(
        logits[:b], labels, anc, pos, neg, margin=margin, alpha=alpha,
        normalize_embeddings=True)
    with torch.no_grad():
        pred = torch.argmax(logits, dim=-1)
        acc = (pred == torch.cat([labels, labels])).float().mean()
        metrics = {"loss": total.detach(), "id_loss": id_loss.detach(),
                   "tl_loss": tl.detach(), "acc": acc,
                   "pos_cos": rowwise_cosine(anc, pos),
                   "neg_cos": rowwise_cosine(anc, neg)}
    return total, metrics, anc


def make_backbone_train_step(
    *,
    margin: float = 0.2,
    alpha: float = 0.1,
    mining_mode: str = "random",
    axis_name: str | None = None,
    mine_anchor_half_only: bool = False,
    center_weight: float = 0.0,
    center_alfa: float = 0.95,
    mirror_augment: bool = False,
    crop_size: int | None = None,
    class_axis_name: str | None = None,
    bwd_im2col: bool = False,
    remat_policy: str | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Callable[..., tuple[TrainState, Metrics]]:
    """The joint id-softmax + ``alpha`` x triplet step (train_efm.py):
    the model in training mode over ``[anchor | positive]`` (dropout from
    the step's generator, LightCNN29's BatchNorm on the batch), the
    softmax CE of the anchor logits plus the triplet loss of the
    L2-normalized anchor, positive and mined negative, then the update.

    ``mine_anchor_half_only`` restricts ``random`` negatives to the anchor
    half (train_efm.py:235). ``center_weight > 0`` adds center loss on the
    anchor embeddings against ``state.aux`` (``[num_classes, D]``), whose
    updated table the state keeps. ``mirror_augment`` / ``crop_size``
    mirror and random-crop each row on the device (batches packed larger
    than ``crop_size``). ``remat_policy`` recomputes the net's layers in
    the backward (``"full"``: all, ``"dots"``: all but conv and matmul
    outputs), numerically identical to none. ``compute_dtype``
    (``torch.bfloat16`` for ``--bf16``) keeps float32 parameters and
    computes in that dtype (autocast). ``bwd_im2col`` takes each eligible
    conv's filter gradient as an explicit im2col matmul
    (``ops/conv_backward.py``). Returns ``(state, metrics)``:
    scalars ``loss``, ``id_loss``, ``tl_loss``, ``acc`` and per-row
    ``pos_cos`` / ``neg_cos``."""
    _check_unported(axis_name, class_axis_name)
    _check_mode(mining_mode)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}; choose from "
                         f"{REMAT_POLICIES}")

    def step(state: TrainState, anchor, positive, labels):
        gen = step_generator(state)
        images, labels = _images(state, anchor, positive, labels)
        if mirror_augment or crop_size is not None:
            images = augment_batch(gen, images, mirror=mirror_augment,
                                   crop_size=crop_size)
        model = state.model
        model.train()
        _set_dropout_generator(model, gen)
        try:
            with _autocast(images.device, compute_dtype):
                logits, feat = model.classify(
                    _embed_fn(model, remat_policy, bwd_im2col)(images))
        finally:
            _set_dropout_generator(model, None)
        num_cand = labels.shape[0] if mine_anchor_half_only else None
        total, metrics, anc = _backbone_losses(
            logits, feat, labels, gen, mining_mode, margin, alpha, num_cand)
        new_centers = state.aux
        if center_weight > 0.0:
            c_loss, new_centers = center_loss(anc, labels, state.aux,
                                              alfa=center_alfa)
            total = total + center_weight * c_loss
            metrics["loss"] = total.detach()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_update()
        state.aux = new_centers
        return state, metrics

    return step


def make_backbone_eval_step(
    *,
    margin: float = 0.2,
    alpha: float = 0.1,
    mining_mode: str = "random",
    axis_name: str | None = None,
    crop_size: int | None = None,
    class_axis_name: str | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Callable[..., Metrics]:
    """Validation (train_efm.py:260-280): the same losses and metrics
    with the model in eval mode (running BatchNorm statistics, no
    dropout), no gradient and no update. With ``crop_size`` it takes the
    center crop of each row."""
    _check_unported(axis_name, class_axis_name)
    _check_mode(mining_mode)

    @torch.no_grad()
    def step(state: TrainState, anchor, positive, labels) -> Metrics:
        gen = step_generator(state) if mining_mode == "random" else None
        images, labels = _images(state, anchor, positive, labels)
        if crop_size is not None and crop_size < images.shape[1]:
            y0 = (images.shape[1] - crop_size) // 2
            x0 = (images.shape[2] - crop_size) // 2
            images = images[:, y0:y0 + crop_size, x0:x0 + crop_size, :]
        model = state.model
        model.eval()
        with _autocast(images.device, compute_dtype):
            logits, feat = model(images)
        _, metrics, _ = _backbone_losses(logits, feat, labels, gen,
                                         mining_mode, margin, alpha, None)
        return metrics

    return step


def make_scanned_step(step_fn) -> Callable:
    """K train steps per call: ``fn(state, anchors [K, B, ...], positives
    [K, B, ...], labels [K, B]) -> (state, metrics)``, each metric stacked
    with a leading K (``[K]`` scalars, ``[K, B]`` per-row). The JAX
    package scans the K steps in one device program; here they run one
    after another, with the same sequence of updates as K separate calls
    (each step's draws come from ``(seed, step)``)."""

    def scanned(state, anchors, positives, labels):
        steps = []
        for i in range(len(labels)):
            state, metrics = step_fn(state, anchors[i], positives[i],
                                     labels[i])
            steps.append(metrics)
        return state, {k: torch.stack([m[k] for m in steps])
                       for k in steps[0]}

    return scanned
