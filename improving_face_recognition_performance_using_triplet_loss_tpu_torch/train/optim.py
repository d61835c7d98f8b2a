"""The head's optimizer: SGD with coupled weight decay, and a parameter EMA.

Port of ``sgd_wd``, ``with_param_ema`` and ``get_ema_params`` from the JAX
package's ``train/optim.py``. optax's ``add_decayed_weights`` followed by
``scale_by_learning_rate`` is ``p - lr * (g + wd * p)``, which is exactly
``torch.optim.SGD(lr=lr, weight_decay=wd)``. The EMA is
``decay * ema + (1 - decay) * params``, taken after each update and
starting from the initial params. ``adam_factor``, ``factor_schedule`` and
``backbone_optimizer`` come with the backbone slice (ROADMAP.md A8).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What to build over a module's parameters (the port's stand-in for
    an optax ``GradientTransformation``): SGD at ``lr`` with coupled
    ``weight_decay``, and a parameter EMA when ``ema_decay > 0``."""

    lr: float = 2.4e-4
    weight_decay: float = 1e-5
    ema_decay: float = 0.0

    def build(self, params) -> torch.optim.Optimizer:
        return torch.optim.SGD(params, lr=self.lr,
                               weight_decay=self.weight_decay)


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
