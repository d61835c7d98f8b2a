"""Epoch-level training loop, preemption guard and resume.

Port of the JAX package's ``train/loops.py``: per-epoch train and
validation passes, the cosine-similarity CSV sink fed from each step's
per-row metrics, per-epoch checkpoints with resume, and a guard that turns
SIGTERM into a checkpoint and a clean stop. ``EpochStats`` also keeps each
train step's scalar metrics and wall seconds (``steps``), which the JAX
loop does not. ``scan_chunk = K`` feeds a scanned step
(``train.steps.make_scanned_step``) K stacked batches a call and drops an
epoch's trailing partial chunk, as the JAX loop does.
"""

from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from ..eval.cosine import CosineSimilaritySink

log = logging.getLogger("facejax.train")


@dataclass
class EpochStats:
    """Per-epoch means of the scalar step metrics, and per train step its
    scalar metrics plus ``seconds`` (wall time from the call to the synced
    loss)."""

    epoch: int
    train: dict[str, float] = field(default_factory=dict)
    valid: dict[str, float] = field(default_factory=dict)
    seconds: float = 0.0
    steps: list[dict[str, float]] = field(default_factory=list)


class NonFiniteLossError(RuntimeError):
    """Raised when the training loss goes NaN or inf."""


class PreemptionGuard:
    """On SIGTERM (by default), let the loop finish the current batch,
    checkpoint and stop, so ``--resume`` continues where it stopped."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._signals = signals
        self._previous = {}

    def __enter__(self):
        def handler(signum, frame):
            self.requested = True

        for sig in self._signals:
            try:
                self._previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread; polling still works
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        return False


def _scalars(metrics: dict, check_finite_key: str | None = None
             ) -> dict[str, float]:
    out = {}
    for k, v in metrics.items():
        if v.ndim == 0:
            val = float(v)
            if check_finite_key == k and not np.isfinite(val):
                raise NonFiniteLossError(f"non-finite {k}: {val}")
            out[k] = val
    return out


def _stack(parts):
    return torch.stack(parts) if isinstance(parts[0], torch.Tensor) \
        else np.stack(parts)


def _chunked_batches(batches: Iterable, k: int):
    """Stack k consecutive ``(anc, pos, lab)`` batches along a new leading
    dim (on the batches' device, for tensors); drops a trailing partial
    chunk."""
    group: list = []
    for batch in batches:
        group.append(batch)
        if len(group) == k:
            yield tuple(_stack(parts) for parts in zip(*group))
            group = []


def _unstack_metrics(metrics: dict, k: int):
    """``[K, ...]``-stacked metrics -> K per-step metric dicts (moved to
    the host at once, so the chunk syncs once)."""
    host = {key: v.cpu() for key, v in metrics.items()}
    return tuple({key: v[i] for key, v in host.items()} for i in range(k))


def _means(rows: list[dict[str, float]]) -> dict[str, float]:
    sums: dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            sums[k] = sums.get(k, 0.0) + v
    return {k: v / len(rows) for k, v in sums.items()}


def train_loop(
    state,
    train_step: Callable,
    train_batches: Callable[[], Iterable],
    *,
    epochs: int,
    eval_step: Callable | None = None,
    eval_batches: Callable[[], Iterable] | None = None,
    sink: CosineSimilaritySink | None = None,
    checkpointer=None,
    checkpoint_every_epochs: int = 1,
    start_epoch: int = 0,
    on_epoch_end: Callable[[EpochStats], None] | None = None,
    preemption_guard: PreemptionGuard | None = None,
    scan_chunk: int = 0,
):
    """Run epochs ``start_epoch .. epochs - 1``; returns ``(state,
    [EpochStats])``.

    ``train_batches`` / ``eval_batches`` are zero-argument callables that
    return a fresh iterator of ``(anchor, positive, labels)``; the steps
    move each batch to the state's device. ``sink`` receives every train
    batch's per-row ``pos_cos`` / ``neg_cos``.

    ``scan_chunk > 1``: ``train_step`` is a scanned step consuming K
    stacked batches a call; the batches that do not fill a last chunk are
    dropped for that epoch (epochs reshuffle, so coverage rotates). Each
    of the chunk's steps gets a ``steps`` row, its ``seconds`` the chunk's
    time over K."""
    history: list[EpochStats] = []
    dropped_logged = False
    k = scan_chunk if scan_chunk > 1 else 1
    for epoch in range(start_epoch, epochs):
        tic = time.time()
        steps: list[dict[str, float]] = []
        batch_iter = (_chunked_batches(train_batches(), k) if k > 1
                      else train_batches())
        for anchor, positive, labels in batch_iter:
            t0 = time.perf_counter()
            state, metrics = train_step(state, anchor, positive, labels)
            per_step = _unstack_metrics(metrics, k) if k > 1 else (metrics,)
            rows = [_scalars(m, check_finite_key="loss") for m in per_step]
            seconds = (time.perf_counter() - t0) / k
            for row, m in zip(rows, per_step):
                row["seconds"] = seconds
                steps.append(row)
                if sink is not None:
                    sink.append(m["pos_cos"].cpu().numpy(),
                                m["neg_cos"].cpu().numpy())
            if preemption_guard is not None and preemption_guard.requested:
                if checkpointer is not None:
                    # saved under the previous completed epoch, so --resume
                    # replays this partial epoch from its start
                    checkpointer.save(max(epoch - 1, 0), state, wait=True)
                log.warning("preemption requested: checkpointed and "
                            "stopping at epoch %d", epoch)
                return state, history
        if k > 1 and not dropped_logged:
            dropped_logged = True
            log.info("scan_chunk=%d: trailing partial chunks are dropped "
                     "per epoch (drop-last)", k)
        valid: list[dict[str, float]] = []
        if eval_step is not None and eval_batches is not None:
            for anchor, positive, labels in eval_batches():
                valid.append(_scalars(eval_step(state, anchor, positive,
                                                labels)))
        if sink is not None:
            sink.flush()
        train = _means([{k: v for k, v in s.items() if k != "seconds"}
                        for s in steps]) if steps else {}
        stats = EpochStats(epoch=epoch, train=train,
                           valid=_means(valid) if valid else {},
                           seconds=time.time() - tic, steps=steps)
        history.append(stats)
        log.info("Epoch %d: %s, in %.1f sec", epoch, ", ".join(
            [f"train {k} {v:g}" for k, v in stats.train.items()]
            + [f"valid {k} {v:g}" for k, v in stats.valid.items()]),
            stats.seconds)
        if checkpointer is not None and (epoch + 1) % checkpoint_every_epochs == 0:
            checkpointer.save(epoch, state)
        if on_epoch_end is not None:
            on_epoch_end(stats)
    if checkpointer is not None:
        checkpointer.wait()
    return state, history


def resume_if_available(checkpointer, state):
    """Restore the latest checkpoint if there is one; returns ``(state,
    first epoch to run)``."""
    if checkpointer is None:
        return state, 0
    step = checkpointer.latest_step()
    if step is None:
        return state, 0
    return checkpointer.restore(state, step), int(step) + 1
