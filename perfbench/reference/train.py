"""The LightCNN-29 training step, plain (the ``train_efm.py`` recipe).

Joint loss: softmax cross-entropy of the anchors' ID logits plus 0.1 x
the triplet loss (margin 0.2) of the L2-normalized anchor, positive and a
semi-hard negative mined from the batch's ``[anchors | positives]`` pool
(FaceNet's rule: the nearest candidate of another identity farther than
the positive, else the farthest of another identity). The net runs in
training mode: dropout 0.7 before fc2, the feature's BatchNorm on the
batch. The update is Adam (b1 0.9, b2 0.999, eps 1e-8) with weight decay
added to the gradient, at the step's rate.

The batches are the pair batcher's (each anchor pairs with the first row
of its identity in the store; each epoch's rows in a new permutation from
one seeded stream, the last partial batch dropped; each anchor and
positive mirrored with probability 1/2 from a second seeded stream),
worked out again here from the store and the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lightcnn29
from .plain import l2n

INV_255 = float(np.float32(1.0) / np.float32(255.0))


def batches(labels: np.ndarray, images: np.ndarray, batch: int, seed: int,
            count: int, start: int = 0):
    """``(anchor, positive, labels)`` uint8 batches ``start`` to ``start +
    count - 1`` of the epochs over the store."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    first = np.full(int(labels.max()) + 1, -1, np.int64)
    uniq, at = np.unique(labels, return_index=True)
    first[uniq] = at
    per_epoch = labels.size // batch
    shuffle = np.random.default_rng(seed)
    mirror = np.random.default_rng(seed + 101)
    out = []
    for i in range(start + count):
        if i % per_epoch == 0:
            order = shuffle.permutation(np.arange(labels.size,
                                                  dtype=np.int64))
        j = i % per_epoch
        flip_a = mirror.random(batch) < 0.5
        flip_p = mirror.random(batch) < 0.5
        if i < start:
            continue
        idx = np.sort(order[j * batch:(j + 1) * batch])
        lab = labels[idx]
        anc, pos = images[idx], images[first[lab]]
        anc = np.where(flip_a[:, None, None, None], anc[:, :, ::-1, :], anc)
        pos = np.where(flip_p[:, None, None, None], pos[:, :, ::-1, :], pos)
        out.append((anc, pos, lab))
    return out


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator a step draws its dropout mask from: seeded from
    ``(seed, step)`` through numpy's SeedSequence."""
    word = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(word) & ((1 << 63) - 1))
    return gen


def semi_hard(anc_n, pool_n, pos_sq, anc_lab, pool_lab) -> torch.Tensor:
    d = torch.clamp_min((anc_n * anc_n).sum(-1, keepdim=True)
                        + (pool_n * pool_n).sum(-1)[None, :]
                        - 2.0 * anc_n @ pool_n.T, 0.0)
    neg = anc_lab[:, None] != pool_lab[None, :]
    semi = neg & (d > pos_sq[:, None])
    near = torch.argmin(torch.where(semi, d, 1e30), -1)
    far = torch.argmax(torch.where(neg, d, -1e30), -1)
    return torch.where(semi.any(-1), near, far)


def loss(p: dict, images: torch.Tensor, labels: torch.Tensor,
         gen: torch.Generator, cfg: dict):
    """The joint loss of one ``[anchors | positives]`` batch."""
    b = labels.shape[0]
    raw = lightcnn29.embed(p, images)
    u = torch.rand(raw.shape, generator=gen, device=raw.device)
    keep = 1.0 - cfg["dropout"]
    dropped = torch.where(u >= cfg["dropout"], raw / keep,
                          torch.zeros_like(raw))
    logits = lightcnn29.logits(p, dropped)
    feat = lightcnn29.batch_norm(p, raw, train=True)
    anc, pos = feat[:b], feat[b:]
    pool = torch.cat([anc, pos])
    pool_lab = torch.cat([labels, labels])
    with torch.no_grad():
        an, pn = l2n(anc), l2n(pos)
        idx = semi_hard(an, l2n(pool), ((an - pn) ** 2).sum(-1), labels,
                        pool_lab)
    neg = pool[idx]
    ce = -torch.log_softmax(logits[:b], -1).gather(
        1, labels.long()[:, None])[:, 0].mean()
    a, q, n = l2n(anc), l2n(pos), l2n(neg)
    tl = torch.clamp_min(((a - q) ** 2).sum(-1) - ((a - n) ** 2).sum(-1)
                         + cfg["margin"], 0.0).mean()
    return ce + cfg["alpha"] * tl


def _images(anc, pos, device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([anc, pos]),
                           device=device).float() * INV_255


def lr_at(cfg: dict, step: int, every: int) -> float:
    """The recipe's rate after ``step`` updates: a factor of
    ``lr_factor`` every ``every`` steps."""
    return cfg["lr"] * cfg["lr_factor"] ** (step // every)


def run(weights: dict, store_images: np.ndarray, store_labels: np.ndarray,
        seed: int, cfg: dict, steps: int, device):
    """``steps`` steps from ``weights``; returns ``(losses, first
    gradients, changes)``: each step's loss, each parameter's gradient as
    Adam takes it in the first step (weight decay added), and each
    parameter's change over the steps."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items() if "running_" not in k}
    fixed = {k: v for k, v in weights.items() if "running_" in k}
    opt = torch.optim.Adam(list(params.values()), lr=cfg["lr"],
                           betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg["weight_decay"])
    losses, first = [], {}
    for s, (anc, pos, lab) in enumerate(batches(
            store_labels, store_images, cfg["pairs"], seed, steps)):
        images = _images(anc, pos, device)
        labels = torch.as_tensor(lab, device=device)
        opt.zero_grad(set_to_none=True)
        total = loss({**params, **fixed}, images, labels,
                     step_generator(seed, s, device), cfg)
        total.backward()
        opt.step()
        losses.append(float(total.detach()))
        if s == 0:
            first = {k: opt.state[t]["exp_avg"] / 0.1
                     for k, t in params.items()}
    change = {k: (t.detach() - weights[k]) for k, t in params.items()}
    return losses, first, change


def replay(snap: dict, weights: dict, store_images: np.ndarray,
           store_labels: np.ndarray, seed: int, cfg: dict, step: int,
           every: int, device):
    """Step ``step`` alone, from ``snap``: the parameters (``params``) and
    Adam's ``exp_avg``, ``exp_avg_sq`` and ``step`` before it. Returns
    ``(loss, gradients, changes)``: the step's loss, each parameter's
    gradient as Adam takes it (weight decay added) and its change."""
    start = snap["params"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    fixed = {k: v for k, v in weights.items() if "running_" in k}
    opt = torch.optim.Adam(list(params.values()),
                           lr=lr_at(cfg, step, every), betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=cfg["weight_decay"])
    for k, t in params.items():
        opt.state[t] = {"step": torch.tensor(snap["step"][k]),
                        "exp_avg": snap["exp_avg"][k].clone(),
                        "exp_avg_sq": snap["exp_avg_sq"][k].clone()}
    (anc, pos, lab), = batches(store_labels, store_images, cfg["pairs"],
                               seed, 1, start=step)
    total = loss({**params, **fixed}, _images(anc, pos, device),
                 torch.as_tensor(lab, device=device),
                 step_generator(seed, step, device), cfg)
    total.backward()
    grad = {k: t.grad + cfg["weight_decay"] * start[k]
            for k, t in params.items()}
    opt.step()
    change = {k: t.detach() - start[k] for k, t in params.items()}
    return float(total.detach()), grad, change
