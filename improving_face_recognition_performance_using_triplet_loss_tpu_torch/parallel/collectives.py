"""Collectives with stated backward rules.

The JAX package gets these rules from ``shard_map``'s transposes; here
each is a ``torch.autograd.Function`` that names its backward:

- :func:`all_gather_rows`: a tiled all-gather (blocks in rank order);
  backward all-reduces the full gradient (SUM) and slices this rank's
  block -- the transpose of the JAX step's tiled ``all_gather``.
- :func:`copy_to_model_group`: the identity; backward all-reduces (SUM)
  over the group. It goes on the features entering a class-sharded
  ``fc2``, whose gradient each shard holds a part of.
- :func:`all_reduce`: SUM / MAX / MIN whose backward is the identity, for
  a value every rank then uses as the same replicated number (the sharded
  cross-entropy's sums). ``torch.distributed.nn.functional.all_reduce``
  all-reduces the gradient too, which multiplies a replicated loss's
  gradient by the group size.
- :func:`pmean`, :func:`gather_rows`: means and gathers without a
  gradient, for metrics and buffers.
- :func:`global_argmax`: each rank's winner of a row reduced over the
  group (a MAX of the value, then a MIN of the global index among the
  ranks that hold it), for a class or gallery axis sharded in blocks.

A group of one (or ``None``) makes each of them the identity. A gloo
group takes card tensors through the host: gloo's collectives are the
CPU's. Booleans travel as uint8.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` that ``group``'s backend takes."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x.detach().clone()
    if x.dtype == torch.bool:
        return _all_reduce(x.to(torch.uint8), op, group).bool()
    buf = _wire(x, group)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(x.device)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x.detach().clone()
    if x.dtype == torch.bool:
        return _all_gather(x.to(torch.uint8), group).bool()
    buf = _wire(x, group)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=0).to(x.device)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        full = _all_reduce(grad, "sum", ctx.group)
        i = group_rank(ctx.group)
        return full[i * ctx.rows:(i + 1) * ctx.rows], None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, "sum", ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        return _all_reduce(x, op, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, ...]`` on each of ``k`` ranks -> ``[k * n, ...]``, the
    blocks in rank order; the gradient of this rank's block is the sum
    over ranks of the gathered gradient's block."""
    if group_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, group)


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose gradient is summed over ``group``."""
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` (``sum``, ``max``, ``min``) over ``group``; the gradient
    passes through unchanged."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, op, group)


@torch.no_grad()
def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group`` (no gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    return _all_reduce(x, "sum", group) / n


@torch.no_grad()
def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-gather without a gradient (metrics, labels)."""
    if group_size(group) == 1:
        return x
    return _all_gather(x, group)


@torch.no_grad()
def global_argmax(local_idx: torch.Tensor, local_max: torch.Tensor,
                  offset: int, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's ``(index, max)`` over an axis sharded in blocks over
    ``group``, from this rank's winners (``local_idx`` into its block,
    which starts at global index ``offset``, and ``local_max``): the
    largest value over the ranks, and the smallest global index that has
    it (``np.argmax``'s first maximum). The index comes back as int64."""
    best = all_reduce(local_max, "max", group)
    big = torch.iinfo(torch.int64).max
    cand = torch.where(local_max >= best, local_idx.to(torch.int64) + offset,
                       big)
    return all_reduce(cand, "min", group), best


@torch.no_grad()
def reduce_tensors_(tensors: list[torch.Tensor], group,
                    divide: int = 1) -> None:
    """All-reduce (SUM) ``tensors`` in place over ``group`` in one
    flattened buffer a dtype, then divide by ``divide``: the gradient
    reduction of a step."""
    if group_size(group) == 1 and divide == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        flat = _all_reduce(flat, "sum", group)
        if divide != 1:
            flat = flat / divide
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_object(obj, group=None, src: int = 0):
    """``obj`` of rank ``src`` on every rank of ``group`` (the world by
    default); a plain run returns it."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
