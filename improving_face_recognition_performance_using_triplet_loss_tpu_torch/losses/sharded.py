"""Class-parallel (tensor-parallel) softmax cross-entropy and argmax.

Twin of the JAX package's ``losses/sharded.py``: the class dim of the
logits is sharded over a process group, each rank owning the contiguous
block ``[i * C_local, (i + 1) * C_local)``; labels hold global class ids.

The stabilizing max is taken over detached logits (a constant: the
log-sum-exp's gradient does not depend on it). The sum of exponentials
and the label's logit, which only its owner holds, are all-reduced with
the identity as backward (``parallel.collectives.all_reduce``): every rank
then holds the same replicated loss, and the gradient of its own logits
is exactly that loss's. An all-reduce that also reduces the gradient
would scale every gradient behind it by the group size.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_reduce, global_argmax, group_rank


def class_parallel_softmax_ce(local_logits: torch.Tensor,
                              labels: torch.Tensor, group) -> torch.Tensor:
    """Mean softmax CE where the class dim of ``local_logits``
    ``[B, C / m]`` is sharded over ``group`` and ``labels`` ``[B]`` hold
    global class ids."""
    c_local = local_logits.shape[-1]
    idx = group_rank(group)
    gmax = all_reduce(local_logits.detach().amax(dim=-1), "max", group)
    sumexp = all_reduce(
        torch.exp(local_logits - gmax[:, None]).sum(dim=-1), "sum", group)
    local_label = labels.long() - idx * c_local
    in_shard = (local_label >= 0) & (local_label < c_local)
    safe = local_label.clamp(0, c_local - 1)
    picked = torch.gather(local_logits, 1, safe[:, None])[:, 0]
    label_logit = all_reduce(torch.where(in_shard, picked, 0.0), "sum",
                             group)
    return (torch.log(sumexp) + gmax - label_logit).mean()


@torch.no_grad()
def class_parallel_argmax(local_logits: torch.Tensor, group) -> torch.Tensor:
    """Global argmax over the sharded class dim; a tie goes to the
    smallest global class id (``np.argmax``'s rule)."""
    larg = torch.argmax(local_logits, dim=-1)
    lmax = torch.gather(local_logits, -1, larg[:, None])[:, 0]
    return global_argmax(larg, lmax, group_rank(group)
                         * local_logits.shape[-1], group)[0]
