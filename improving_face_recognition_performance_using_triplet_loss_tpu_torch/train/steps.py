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
``[B, 2B]`` distances; ``random`` draws from the step's generator.
``bwd_im2col=True`` routes every eligible conv through
``ops.conv_backward.conv2d_fg_im2col`` (dW as an explicit im2col matmul).

Data and class parallelism: a step built with ``axis_name`` (and, for the
backbone, ``class_axis_name``) runs inside ``shard_map_step`` /
``shard_map_step_2d`` (or their scanned forms), which bind the mesh; each
rank calls it with its own rows. The step folds its data rank into its
generator (dropout, augmentation and ``random`` mining are the same on
every model rank of a data group), mines from the pool gathered over the
data group (``parallel.collectives.all_gather_rows``, whose backward sums
the pool's gradient over the ranks), and sums the gradients over the data
group and divides by its size; BatchNorm running statistics and the
center table are averaged over it, scalar metrics averaged and per-row
metrics gathered in rank order by the wrapper. With ``class_axis_name``
the model holds its block of the ``fc2`` classes (``train/sharding.py``),
the features entering ``fc2`` pass ``copy_to_model_group`` (the gradient
summed over the model group), and the softmax CE and argmax are the
class-parallel ones (``losses/sharded.py``); nothing is reduced over the
model group after the backward.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
import torch.utils.checkpoint

from ..data.records import augment_batch, normalize_uint8
from ..losses.center import center_loss
from ..losses.sharded import class_parallel_argmax, class_parallel_softmax_ce
from ..losses.triplet import joint_id_triplet_loss, triplet_loss
from ..models.lightcnn import Dropout
from ..ops import mining
from ..ops.conv_backward import conv_interceptor_im2col_bwd
from ..ops.cuda.mining import semi_hard_mining
from ..ops.distances import l2_normalize, pairwise_sq_l2, rowwise_cosine
from ..parallel.collectives import (all_gather_rows, copy_to_model_group,
                                    gather_rows, pmean, reduce_tensors_)
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_group, bind_mesh,
                             bound_axis)
from ..utils.profiling import span
from .state import TrainState, step_generator

Metrics = dict[str, torch.Tensor]

BACKBONE_METRIC_KEYS = ("loss", "id_loss", "tl_loss", "acc", "pos_cos",
                        "neg_cos")
HEAD_METRIC_KEYS = ("loss", "pos_cos", "neg_cos")
MINING_MODES = ("random", "semi_hard", "semi_hard_fused", "hard")
REMAT_POLICIES = (None, "full", "dots")
_PER_ROW_METRICS = frozenset({"pos_cos", "neg_cos"})


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


def _pool(anc, pos, labels, data=None):
    """Mining candidate pool: the batch's ``[anc | pos]`` rows, gathered
    over the data axis (blocks in rank order) when there is one."""
    pool_feat = torch.cat([anc, pos], dim=0)
    pool_labels = torch.cat([labels, labels], dim=0)
    if data is not None:
        pool_feat = all_gather_rows(pool_feat, data.group)
        pool_labels = gather_rows(pool_labels, data.group)
    return pool_feat, pool_labels


def _fold(data) -> int | None:
    """The rank a step folds into its generator: its data rank."""
    return None if data is None else data.index


def _pmean_metrics(metrics: Metrics, data) -> Metrics:
    """Scalar metrics averaged over the data axis; per-row ones stay
    local (the wrapper gathers them)."""
    if data is None:
        return metrics
    return {k: (pmean(v, data.group) if v.ndim == 0 else v)
            for k, v in metrics.items()}


def _reduce_grads(model: torch.nn.Module, data) -> None:
    """Sum every gradient over the data axis and divide by its size, and
    average the floating buffers (BatchNorm running statistics)."""
    if data is None:
        return
    reduce_tensors_([p.grad for p in model.parameters()
                     if p.grad is not None], data.group, divide=data.size)
    reduce_tensors_([b for b in model.buffers() if b.is_floating_point()],
                    data.group, divide=data.size)


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
    axis_name: str | None = None,
) -> Callable[..., tuple[TrainState, Metrics]]:
    """Triplet-only head step: a linear head over precomputed features,
    margin 0.5, SGD. ``normalize_embeddings`` takes the loss on
    L2-normalized head outputs; the reference trains on raw outputs.
    ``axis_name``: data parallelism (module docstring)."""
    _check_mode(mining_mode)

    def step(state: TrainState, anchor, positive, labels):
        data = bound_axis(axis_name)
        gen = (step_generator(state, _fold(data))
               if mining_mode == "random" else None)
        anchor, positive, labels = _inputs(state, anchor, positive, labels,
                                           normalize_inputs)
        b = anchor.shape[0]
        emb = state.model(torch.cat([anchor, positive], dim=0))
        anc, pos = emb[:b], emb[b:]
        pool_feat, pool_labels = _pool(anc, pos, labels, data)
        neg = _mine(mining_mode, gen, anc, pos, pool_feat, labels,
                    pool_labels)
        tl = triplet_loss(anc, pos, neg, margin=margin,
                          normalize=normalize_embeddings)
        state.optimizer.zero_grad(set_to_none=True)
        tl.backward()
        _reduce_grads(state.model, data)
        with torch.no_grad():
            metrics = {"loss": tl.detach(),
                       "pos_cos": rowwise_cosine(anc, pos),
                       "neg_cos": rowwise_cosine(anc, neg)}
        state.apply_update()
        return state, _pmean_metrics(metrics, data)

    return step


def make_head_eval_step(
    *,
    margin: float = 0.5,
    mining_mode: str = "random",
    normalize_inputs: bool = False,
    axis_name: str | None = None,
) -> Callable[..., Metrics]:
    """Head validation. With an identity head and
    ``normalize_inputs=True`` it is also the no-training cosine
    measurement of ``eval_cos``."""
    _check_mode(mining_mode)

    @torch.no_grad()
    def step(state: TrainState, anchor, positive, labels) -> Metrics:
        data = bound_axis(axis_name)
        gen = (step_generator(state, _fold(data))
               if mining_mode == "random" else None)
        anchor, positive, labels = _inputs(state, anchor, positive, labels,
                                           normalize_inputs)
        b = anchor.shape[0]
        emb = state.model(torch.cat([anchor, positive], dim=0))
        anc, pos = emb[:b], emb[b:]
        pool_feat, pool_labels = _pool(anc, pos, labels, data)
        neg = _mine(mining_mode, gen, anc, pos, pool_feat, labels,
                    pool_labels)
        return _pmean_metrics(
            {"loss": triplet_loss(anc, pos, neg, margin=margin),
             "pos_cos": rowwise_cosine(anc, pos),
             "neg_cos": rowwise_cosine(anc, neg)}, data)

    return step


# ---------------------------------------------------------------- backbone


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


@contextlib.contextmanager
def _fc2_input(model: torch.nn.Module, classes):
    """With a class axis, the features entering ``model.fc2`` (its block
    of the classes) pass ``copy_to_model_group`` for the forward inside."""
    if classes is None:
        yield
        return
    fc2 = getattr(model, "fc2", None)
    if fc2 is None:
        raise ValueError("class parallelism shards the classifier named "
                         "fc2, which this model does not have")
    handle = fc2.register_forward_pre_hook(
        lambda mod, args: (copy_to_model_group(args[0], classes.group),))
    try:
        yield
    finally:
        handle.remove()


def _backbone_losses(logits, feat, labels, gen, mining_mode, margin, alpha,
                     num_candidates, data=None, classes=None):
    """The joint loss and the metrics shared by the train and eval steps;
    returns ``(total, metrics, anc)``."""
    b = labels.shape[0]
    anc, pos = feat[:b], feat[b:]
    pool_feat, pool_labels = _pool(anc, pos, labels, data)
    neg = _mine(mining_mode, gen, anc, pos, pool_feat, labels, pool_labels,
                num_candidates)
    if classes is not None:
        id_loss = class_parallel_softmax_ce(logits[:b], labels,
                                            classes.group)
        tl = triplet_loss(anc, pos, neg, margin=margin, normalize=True)
        total = id_loss + alpha * tl
    else:
        total, id_loss, tl = joint_id_triplet_loss(
            logits[:b], labels, anc, pos, neg, margin=margin, alpha=alpha,
            normalize_embeddings=True)
    with torch.no_grad():
        pred = (torch.argmax(logits, dim=-1) if classes is None
                else class_parallel_argmax(logits, classes.group))
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
    ``pos_cos`` / ``neg_cos``. ``axis_name`` / ``class_axis_name``: data
    and class parallelism (module docstring); center loss does not
    combine with class parallelism (the table is class-indexed)."""
    if class_axis_name is not None and center_weight > 0.0:
        raise ValueError("center loss is not supported with class-parallel "
                         "softmax (centers table is class-indexed)")
    _check_mode(mining_mode)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}; choose from "
                         f"{REMAT_POLICIES}")

    def step(state: TrainState, anchor, positive, labels):
        data, classes = bound_axis(axis_name), bound_axis(class_axis_name)
        with span("train.upload"):
            gen = step_generator(state, _fold(data))
            images, labels = _images(state, anchor, positive, labels)
            if mirror_augment or crop_size is not None:
                images = augment_batch(gen, images, mirror=mirror_augment,
                                       crop_size=crop_size)
        model = state.model
        with span("train.forward"):
            model.train()
            _set_dropout_generator(model, gen)
            try:
                with _autocast(images.device, compute_dtype), \
                        _fc2_input(model, classes):
                    logits, feat = model.classify(
                        _embed_fn(model, remat_policy, bwd_im2col)(images))
            finally:
                _set_dropout_generator(model, None)
        with span("train.loss"):
            # under DP every candidate pool is the gathered batch
            num_cand = (labels.shape[0]
                        if mine_anchor_half_only and data is None else None)
            total, metrics, anc = _backbone_losses(
                logits, feat, labels, gen, mining_mode, margin, alpha,
                num_cand, data, classes)
            new_centers = state.aux
            if center_weight > 0.0:
                c_loss, new_centers = center_loss(anc, labels, state.aux,
                                                  alfa=center_alfa)
                total = total + center_weight * c_loss
                metrics["loss"] = total.detach()
        with span("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            _reduce_grads(model, data)
            if center_weight > 0.0 and data is not None:
                new_centers = pmean(new_centers, data.group)
        with span("train.optimizer"):
            state.apply_update()
            state.aux = new_centers
            return state, _pmean_metrics(metrics, data)

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
    _check_mode(mining_mode)

    @torch.no_grad()
    def step(state: TrainState, anchor, positive, labels) -> Metrics:
        data, classes = bound_axis(axis_name), bound_axis(class_axis_name)
        gen = (step_generator(state, _fold(data))
               if mining_mode == "random" else None)
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
                                         mining_mode, margin, alpha, None,
                                         data, classes)
        return _pmean_metrics(metrics, data)

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


def _gathered(metrics: Metrics, group, metric_keys) -> Metrics:
    """The step's metrics with its per-row ones gathered in rank order."""
    if set(metrics) != set(metric_keys):
        raise ValueError(f"step returned metrics {sorted(metrics)}, "
                         f"expected {sorted(metric_keys)}")
    return {k: gather_rows(v, group) if k in _PER_ROW_METRICS else v
            for k, v in metrics.items()}


def shard_map_step(
    step_fn,
    mesh,
    *,
    has_state_out: bool,
    metric_keys=BACKBONE_METRIC_KEYS,
    axis_name: str = DATA_AXIS,
):
    """Run a step built with ``axis_name`` over a data mesh: the state
    replicated (every rank holds it and takes the same update), the batch
    sharded -- each rank calls the result with its own rows
    (``parallel.local_block`` of the global batch). Scalar metrics come
    back averaged over the axis, per-row ones (``pos_cos``, ``neg_cos``)
    gathered in rank order. Keyword arguments pass through to the step
    (the GAN step's ``z``)."""

    def run(state, anchor, positive, labels, **kwargs):
        with bind_mesh(mesh):
            out = step_fn(state, anchor, positive, labels, **kwargs)
            metrics = out[1] if has_state_out else out
            metrics = _gathered(metrics, axis_group(mesh, axis_name),
                                metric_keys)
        return (out[0], metrics) if has_state_out else metrics

    return run


def shard_map_step_2d(
    step_fn,
    mesh,
    state_specs,
    *,
    has_state_out: bool,
    metric_keys=BACKBONE_METRIC_KEYS,
    data_axis: str = DATA_AXIS,
):
    """Run a step over a 2-D (data, model) mesh: the batch sharded over
    the data axis, the classifier head (and its optimizer mirrors and
    EMA) sharded over the model axis per ``state_specs``
    (:func:`infer_class_parallel_specs`; the state's model holds its block,
    ``train.sharding.shard_model_``), everything else replicated. The
    step must have been built with ``axis_name=data_axis`` and
    ``class_axis_name`` the model axis."""
    run = shard_map_step(step_fn, mesh, has_state_out=has_state_out,
                         metric_keys=metric_keys, axis_name=data_axis)

    def checked(state, anchor, positive, labels):
        names = dict(state.model.named_parameters())
        missing = [n for n in state_specs if n not in names]
        if missing:
            raise ValueError(f"state has no parameters {missing} of the "
                             "class-parallel specs")
        return run(state, anchor, positive, labels)

    return checked


def shard_map_scanned_step(
    step_fn,
    mesh,
    *,
    metric_keys=BACKBONE_METRIC_KEYS,
    axis_name: str = DATA_AXIS,
):
    """Data parallelism with scan chunks: each rank calls the result with
    its rows of K stacked batches (``[K, b, ...]``); the K steps run one
    after another, and the metrics come back stacked ``[K]`` (scalars,
    averaged) / ``[K, B]`` (per-row, gathered)."""
    return make_scanned_step(shard_map_step(
        step_fn, mesh, has_state_out=True, metric_keys=metric_keys,
        axis_name=axis_name))


def shard_map_scanned_step_2d(
    step_fn,
    mesh,
    state_specs,
    *,
    metric_keys=BACKBONE_METRIC_KEYS,
    data_axis: str = DATA_AXIS,
):
    """Scan chunks over the 2-D (data, model) mesh: K steps a call, as
    :func:`shard_map_scanned_step`, with the head sharded as in
    :func:`shard_map_step_2d`."""
    return make_scanned_step(shard_map_step_2d(
        step_fn, mesh, state_specs, has_state_out=True,
        metric_keys=metric_keys, data_axis=data_axis))


def infer_class_parallel_specs(state_or_model, num_classes: int,
                               model_axis: str = MODEL_AXIS
                               ) -> dict[str, str]:
    """The parameters class parallelism shards: ``{name: model_axis}``
    for each parameter whose name goes through the classifier head
    (``fc2``) and whose class dim (dim 0 of a torch ``Linear``'s weight
    and bias) is ``num_classes``; their optimizer moments and EMA follow
    them. Everything else replicates. Name-gating keeps an unrelated
    tensor of that size whole."""
    model = getattr(state_or_model, "model", state_or_model)
    return {name: model_axis for name, p in model.named_parameters()
            if "fc2" in name.split(".") and p.ndim >= 1
            and p.shape[0] == num_classes}
