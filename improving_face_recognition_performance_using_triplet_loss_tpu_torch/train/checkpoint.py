"""Checkpoint and resume of the train state.

The port's twin of the JAX package's ``train/checkpoint.py`` (which uses
orbax, a JAX library), with the same interface: ``save(step, state,
wait)``, ``latest_step``, ``restore``, ``wait`` and ``max_to_keep``. Each
checkpoint is ``<directory>/<step>/state.pt``, written with ``torch.save``:
the module's state dict (BatchNorm running statistics included), the
optimizer's (every family's moments and counts), the EMA, ``aux`` (the
center-loss table), the step and the seed, so a restored state continues
the same sequence of updates. The two packages' checkpoints are not interchangeable; their exports
(``serve/export.py``) are.
"""

from __future__ import annotations

import os
import shutil

import torch

_FILE = "state.pt"


class Checkpointer:
    """Keeps the newest ``max_to_keep`` checkpoints under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _FILE)))

    def save(self, step: int, state, wait: bool = False) -> None:
        """Write ``state`` as checkpoint ``step`` (synchronously, so
        ``wait`` has nothing to wait for), then drop the oldest beyond
        ``max_to_keep``."""
        path = os.path.join(self.directory, str(int(step)))
        os.makedirs(path, exist_ok=True)
        blob = {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "ema": state.ema, "ema_decay": state.ema_decay,
                "aux": state.aux,
                "step": state.step, "seed": state.seed}
        tmp = os.path.join(path, _FILE + ".tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(path, _FILE))
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state, step: int | None = None):
        """Load checkpoint ``step`` (the latest by default) into ``state``,
        a state built the same way as the saved one; returns it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        blob = torch.load(os.path.join(self.directory, str(int(step)), _FILE),
                          map_location=state.device, weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.ema = blob["ema"]
        state.ema_decay = blob["ema_decay"]
        state.aux = blob.get("aux")
        state.step = int(blob["step"])
        state.seed = int(blob["seed"])
        return state

    def wait(self) -> None:
        """Saves are synchronous; nothing is in flight."""
