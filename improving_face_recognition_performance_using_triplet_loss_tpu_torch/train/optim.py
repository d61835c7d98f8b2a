"""Optimizers, the reference's learning-rate schedule and a parameter EMA.

Port of the JAX package's ``train/optim.py`` (optax there). An
``OptimizerSpec`` stands in for an optax ``GradientTransformation``: it
names the family, the base rate, the factor schedule, the coupled weight
decay and an optional EMA, and ``build`` makes the torch optimizer over a
module's parameters. Every family is the optax chain
``add_decayed_weights(wd) -> core -> scale_by_learning_rate(schedule)``:
the decay is added to the gradient *before* the core transform (MXNet's
coupled decay, not AdamW's), and the schedule reads the update count
before it is incremented, ``lr = max(base * factor^(step // every),
stop_lr)``.

- ``sgd`` is ``torch.optim.SGD(weight_decay=wd)``, ``mom`` the same with
  Nesterov momentum 0.9 (optax ``trace(0.9, nesterov=True)``) and ``adam``
  ``torch.optim.Adam(weight_decay=wd)`` (optax ``scale_by_adam``: eps
  outside the square root; torch folds the bias corrections into the step
  size, equal up to float32 rounding).
- ``adagrad`` (optax ``scale_by_rss(0.1)``), ``rmsprop`` (``scale_by_rms(
  0.9, eps=1.0)``, eps inside the rsqrt, then ``trace(0.9)``) and
  ``adadelta`` (``scale_by_adadelta(0.9, 1e-6)``) have no torch class with
  the same rule; :class:`OptaxRule` writes them over tensors.

The train state sets each group's ``lr`` from :meth:`OptimizerSpec.lr_at`
before every update (``TrainState.apply_update``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FAMILIES = ("adam", "adagrad", "adadelta", "rmsprop", "mom", "sgd")


def factor_schedule(base_lr: float, decay_every_steps: int,
                    factor: float = 0.88, stop_lr: float = 5e-15):
    """``lr(step) = max(base * factor^(step // decay_every), stop_lr)``, in
    float32 as the JAX schedule computes it (MXNet's ``FactorScheduler``)."""
    every = max(int(decay_every_steps), 1)

    def schedule(step: int) -> float:
        lr = np.float32(base_lr) * np.power(np.float32(factor),
                                            np.float32(int(step) // every))
        return float(max(np.float32(lr), np.float32(stop_lr)))

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What to build over a module's parameters: ``family`` at ``lr``,
    decayed by ``factor`` every ``decay_every_steps`` updates (0: a
    constant rate) down to ``stop_lr``, with coupled ``weight_decay``, and
    a parameter EMA when ``ema_decay > 0``."""

    lr: float = 2.4e-4
    weight_decay: float = 1e-5
    ema_decay: float = 0.0
    family: str = "sgd"
    decay_every_steps: int = 0
    factor: float = 0.88
    stop_lr: float = 5e-15

    def lr_at(self, step: int) -> float:
        """The rate of the update that follows ``step`` updates."""
        if not self.decay_every_steps:
            return self.lr
        return factor_schedule(self.lr, self.decay_every_steps, self.factor,
                               self.stop_lr)(step)

    def build(self, params) -> torch.optim.Optimizer:
        wd, lr = self.weight_decay, self.lr
        if self.family == "sgd":
            return torch.optim.SGD(params, lr=lr, weight_decay=wd)
        if self.family == "mom":
            return torch.optim.SGD(params, lr=lr, weight_decay=wd,
                                   momentum=0.9, nesterov=True)
        if self.family == "adam":
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=wd)
        return OptaxRule(params, rule=self.family, lr=lr, weight_decay=wd)


class OptaxRule(torch.optim.Optimizer):
    """optax's ``adagrad``, ``rmsprop`` and ``adadelta`` cores, after
    coupled weight decay and before the learning rate, with the constants
    of the JAX package's ``backbone_optimizer``. State per parameter:
    ``sum_of_squares`` (adagrad, starting at 0.1), ``nu`` and ``trace``
    (rmsprop), ``e_g`` and ``e_x`` (adadelta)."""

    RULES = ("adagrad", "rmsprop", "adadelta")

    def __init__(self, params, *, rule: str, lr: float, weight_decay: float):
        if rule not in self.RULES:
            raise ValueError(f"rule {rule!r}; choose from {self.RULES}")
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay,
                                  "rule": rule})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd, rule = group["lr"], group["weight_decay"], group["rule"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p
                st = self.state[p]
                if rule == "adagrad":
                    if not st:
                        st["sum_of_squares"] = torch.full_like(p, 0.1)
                    sos = st["sum_of_squares"]
                    sos.add_(torch.square(g))
                    u = torch.where(sos > 0, torch.rsqrt(sos + 1e-7),
                                    torch.zeros_like(sos)) * g
                elif rule == "rmsprop":
                    if not st:
                        st["nu"] = torch.zeros_like(p)
                        st["trace"] = torch.zeros_like(p)
                    nu, tr = st["nu"], st["trace"]
                    nu.copy_((1 - 0.9) * torch.square(g) + 0.9 * nu)
                    u = g * torch.rsqrt(nu + 1.0)
                    tr.copy_(u + 0.9 * tr)
                    u = tr
                else:
                    if not st:
                        st["e_g"] = torch.zeros_like(p)
                        st["e_x"] = torch.zeros_like(p)
                    e_g, e_x = st["e_g"], st["e_x"]
                    e_g.copy_((1 - 0.9) * torch.square(g) + 0.9 * e_g)
                    u = torch.sqrt(e_x + 1e-6) / torch.sqrt(e_g + 1e-6) * g
                    e_x.copy_((1 - 0.9) * torch.square(u) + 0.9 * e_x)
                p.add_(u, alpha=-lr)


def backbone_optimizer(name: str, base_lr: float = 2.4e-4,
                       decay_every_steps: int = 1, factor: float = 0.88,
                       stop_lr: float = 5e-15,
                       weight_decay: float = 1e-5) -> OptimizerSpec:
    """The facenet optimizer family (``adam``, the reference default;
    ``adagrad``, ``adadelta``, ``rmsprop``, ``mom``, ``sgd``) on the
    reference backbone recipe's factor schedule and coupled decay."""
    if name not in FAMILIES:
        raise ValueError(f"optimizer {name!r}; choose from "
                         f"{sorted(FAMILIES)}")
    return OptimizerSpec(lr=base_lr, weight_decay=weight_decay, family=name,
                         decay_every_steps=max(int(decay_every_steps), 1),
                         factor=factor, stop_lr=stop_lr)


def adam_factor(base_lr: float = 2.4e-4, decay_every_steps: int = 1,
                factor: float = 0.88, stop_lr: float = 5e-15,
                weight_decay: float = 1e-5) -> OptimizerSpec:
    """Adam + factor schedule + coupled weight decay (the reference's
    backbone optimizer; ``backbone_optimizer("adam", ...)``)."""
    return backbone_optimizer("adam", base_lr, decay_every_steps, factor,
                              stop_lr, weight_decay)


def sgd_wd(lr: float = 2.4e-4, weight_decay: float = 1e-5) -> OptimizerSpec:
    """Plain SGD with coupled weight decay (the head's optimizer)."""
    return OptimizerSpec(lr=lr, weight_decay=weight_decay)


def with_param_ema(tx: OptimizerSpec, decay: float = 0.999) -> OptimizerSpec:
    """``tx`` plus an exponential moving average of the parameters, which
    the train state carries and checkpoints (read it with
    :func:`get_ema_params`)."""
    return dataclasses.replace(tx, ema_decay=decay)


@torch.no_grad()
def init_ema(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The EMA's starting point: a copy of the parameters."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


@torch.no_grad()
def update_ema(ema: dict[str, torch.Tensor], model: torch.nn.Module,
               decay: float) -> None:
    """``ema = decay * ema + (1 - decay) * params``, in place."""
    for k, p in model.named_parameters():
        ema[k].mul_(decay).add_((1.0 - decay) * p)


def get_ema_params(state) -> dict[str, torch.Tensor]:
    """The EMA parameters of a train state built with
    :func:`with_param_ema`, keyed like ``model.named_parameters()``."""
    if state.ema is None:
        raise TypeError("optimizer was not wrapped with with_param_ema")
    return state.ema
