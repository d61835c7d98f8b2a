"""Train state: the module, its optimizer and its spec, an optional
parameter EMA, extra state (``aux``), the step counter and a base seed.

Port of the JAX package's ``train/state.py``. The JAX state is a pytree
threaded through a jitted step; here the step updates the module and the
optimizer in place and returns the same state. BatchNorm running
statistics (the JAX ``batch_stats``) live in the module's buffers; ``aux``
holds what else a step threads through, the center-loss table. Per-step
random draws come from a generator derived from ``(seed, step)``
(:func:`step_generator`, the port's form of the JAX ``_step_keys``
fold-in; a data-parallel step folds in its data rank), so a resumed run replays the same draws without storing a
generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .optim import OptimizerSpec, init_ema, update_ema


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    seed: int
    step: int = 0
    ema: dict[str, torch.Tensor] | None = None
    ema_decay: float = 0.0
    spec: OptimizerSpec = dataclasses.field(default_factory=OptimizerSpec)
    aux: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_update(self) -> None:
        """The scheduled rate, the optimizer step, then the EMA, then
        ``step += 1``."""
        lr = self.spec.lr_at(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema is not None:
            update_ema(self.ema, self.model, self.ema_decay)
        self.step += 1


def create_train_state(model: torch.nn.Module, tx: OptimizerSpec,
                       seed: int, aux: torch.Tensor | None = None
                       ) -> TrainState:
    """Wrap ``model`` (already initialised and on its device) with the
    optimizer ``tx`` describes; ``aux`` is extra state a step threads
    through (the center-loss table, ``[num_classes, D]`` zeros to start)."""
    ema = init_ema(model) if tx.ema_decay > 0 else None
    return TrainState(model=model, optimizer=tx.build(model.parameters()),
                      seed=int(seed), ema=ema, ema_decay=tx.ema_decay,
                      spec=tx, aux=aux)


def step_generator(state: TrainState,
                   rank: int | None = None) -> torch.Generator:
    """A generator on the state's device seeded from ``(seed, step)``, or
    from ``(seed, step, rank)`` for a data-parallel step (the JAX step's
    fold-in of its data-axis index)."""
    words = [state.seed, state.step] + ([] if rank is None else [int(rank)])
    word = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=state.device)
    gen.manual_seed(int(word) & ((1 << 63) - 1))
    return gen
