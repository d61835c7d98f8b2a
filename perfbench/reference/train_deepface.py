"""The DeepFace training step, plain: the thesis's joint loss (as
``train.py``'s LightCNN-29 step) on the published DeepFace.

Softmax cross-entropy of the anchors' F8 logits, taken over F7 after
dropout 0.5 (the mask drawn from the step's generator), plus 0.1 x the
triplet loss (margin 0.2) of the L2-normalized anchor, positive and a
semi-hard negative mined from the batch's ``[anchors | positives]``
pool; Adam with weight decay added to the gradient. The batches, the
step generator, the mining rule and the rate schedule are ``train.py``'s.

Near-ties: where two candidates of an anchor's pool lie within rounding
of each other (or of its positive's distance), the program's float32
mining and the reference's may pick either. ``picks`` hands the step the
negatives the program picked; each one the reference would not pick
itself is taken if its own distances put it within a tie of its own
pick, and the largest such distance over the step is returned
(``tie_gap``: 0 where every pick agrees, infinite where a pick is not a
negative of its anchor or the picks do not fit the batch).
"""

from __future__ import annotations

import torch

from . import deepface
from .plain import l2n
from .train import _images, batches, lr_at, semi_hard, step_generator


def tie_gap(d: torch.Tensor, pos_sq: torch.Tensor, neg: torch.Tensor,
            own: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Per anchor, how far its squared distances ``d`` [B, N] would have
    to move for the semi-hard rule to pick ``other`` where it picks
    ``own``: into the semi-hard set and nearest when ``own`` is semi-hard,
    else the farthest negative or into the semi-hard set."""
    rows = torch.arange(d.shape[0], device=d.device)
    d_own, d_other = d[rows, own], d[rows, other]
    semi = d_own > pos_sq
    gap = torch.where(semi, torch.maximum(d_other - d_own, pos_sq - d_other),
                      torch.minimum(d_own - d_other, pos_sq - d_other))
    gap = torch.where(neg[rows, other], gap.clamp_min(0.0),
                      torch.full_like(gap, float("inf")))
    return torch.where(own == other, torch.zeros_like(gap), gap)


def loss(p: dict, images: torch.Tensor, labels: torch.Tensor,
         gen: torch.Generator, cfg: dict, picks: torch.Tensor | None = None):
    """``(joint loss, own picks, tie gap)`` of one ``[anchors |
    positives]`` batch, mining with the program's ``picks`` where a
    near-tie explains them."""
    b = labels.shape[0]
    feat = deepface.embed(p, images)
    u = torch.rand(feat.shape, generator=gen, device=feat.device)
    keep = 1.0 - cfg["dropout"]
    dropped = torch.where(u >= cfg["dropout"], feat / keep,
                          torch.zeros_like(feat))
    logit = deepface.logits(p, dropped)
    anc, pos = feat[:b], feat[b:]
    pool = torch.cat([anc, pos])
    pool_lab = torch.cat([labels, labels])
    with torch.no_grad():
        an, pn, pool_n = l2n(anc), l2n(pos), l2n(pool)
        pos_sq = ((an - pn) ** 2).sum(-1)
        own = semi_hard(an, pool_n, pos_sq, labels, pool_lab)
        idx, tie = own, 0.0
        if picks is not None:
            picks = picks.to(own.device).long()
            if picks.shape != own.shape:
                tie = float("inf")
            else:
                d = torch.clamp_min((an * an).sum(-1, keepdim=True)
                                    + (pool_n * pool_n).sum(-1)[None, :]
                                    - 2.0 * an @ pool_n.T, 0.0)
                neg = labels[:, None] != pool_lab[None, :]
                gaps = tie_gap(d, pos_sq, neg, own, picks)
                tie = float(gaps.max())
                idx = picks
    neg_feat = pool[idx]
    ce = -torch.log_softmax(logit[:b], -1).gather(
        1, labels.long()[:, None])[:, 0].mean()
    a, q, n = l2n(anc), l2n(pos), l2n(neg_feat)
    tl = torch.clamp_min(((a - q) ** 2).sum(-1) - ((a - n) ** 2).sum(-1)
                         + cfg["margin"], 0.0).mean()
    return ce + cfg["alpha"] * tl, own, tie


def _adam(params: dict, cfg: dict, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg["weight_decay"])


def run(weights: dict, store_images, store_labels, seed: int, cfg: dict,
        steps: int, device, picks=None):
    """``steps`` steps from ``weights``; returns ``(losses, first
    gradients, changes, own picks, tie gaps)``: each step's loss, each
    parameter's gradient as Adam takes it in the first step (weight decay
    added), each parameter's change over the steps, and each step's own
    picks and tie gap against ``picks[step]`` (None: its own)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = _adam(params, cfg, cfg["lr"])
    losses, first, owns, ties = [], {}, [], []
    for s, (anc, pos, lab) in enumerate(batches(
            store_labels, store_images, cfg["pairs"], seed, steps)):
        opt.zero_grad(set_to_none=True)
        total, own, tie = loss(params, _images(anc, pos, device),
                               torch.as_tensor(lab, device=device),
                               step_generator(seed, s, device), cfg,
                               None if picks is None else picks[s])
        total.backward()
        opt.step()
        losses.append(float(total.detach()))
        owns.append(own)
        ties.append(tie)
        if s == 0:
            first = {k: opt.state[t]["exp_avg"] / 0.1
                     for k, t in params.items()}
    change = {k: (t.detach() - weights[k]) for k, t in params.items()}
    return losses, first, change, owns, ties


def replay(snap: dict, store_images, store_labels, seed: int, cfg: dict,
           step: int, every: int, device, picks=None):
    """Step ``step`` alone, from ``snap`` (the parameters and Adam's
    ``exp_avg``, ``exp_avg_sq`` and ``step`` before it). Returns ``(loss,
    gradients, changes, own picks, tie gap)``: the step's loss, each
    parameter's gradient as Adam takes it (weight decay added), its
    change, and the picks as in ``run``."""
    start = snap["params"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    opt = _adam(params, cfg, lr_at(cfg, step, every))
    for k, t in params.items():
        opt.state[t] = {"step": torch.tensor(snap["step"][k]),
                        "exp_avg": snap["exp_avg"][k].clone(),
                        "exp_avg_sq": snap["exp_avg_sq"][k].clone()}
    (anc, pos, lab), = batches(store_labels, store_images, cfg["pairs"],
                               seed, 1, start=step)
    total, own, tie = loss(params, _images(anc, pos, device),
                           torch.as_tensor(lab, device=device),
                           step_generator(seed, step, device), cfg, picks)
    total.backward()
    grad = {k: t.grad + cfg["weight_decay"] * start[k]
            for k, t in params.items()}
    opt.step()
    change = {k: t.detach() - start[k] for k, t in params.items()}
    return float(total.detach()), grad, change, own, tie
