"""Back-to-back training steps of the program's backbone step, fed as
``train_backbone`` feeds it.

The step, its model and its optimizer are built as ``train_backbone``
builds them (``model_by_name``, ``backbone_optimizer``,
``create_train_state``, ``make_backbone_train_step``), with the benchmark's
weights, made from the seed, loaded into the model. Batches come from the
CLI's own batcher and host mirror (``make_batcher``, ``MirrorBatches``) over
a uint8 store of synthetic identities in host memory; each step takes its
batch from the host and syncs on its metrics as the CLI's loop does.

Set-up drives the very object the window uses through its first three
steps and records, before the window moves it on: each step's loss, each
parameter's first gradient as Adam took it (from its first moment after
one step), and each parameter's change over the three. The check runs the
plain reference through the same three steps from the same weights and
batches, and compares each by the worst parameter.

The window's own steps are held too, past the first epoch's end (where
the batcher starts a new permutation): before a step drawn from the seed
in the first half of the second epoch the driver copies the parameters
and Adam's moments, and after it records the step's loss, each
parameter's gradient as Adam took it (from the two first moments) and
each parameter's change. The reference cannot follow the program through
the steps before it (their rounding compounds), so it replays that one
step from the copy, on the batch it works out again from the store and
the seed, and the check compares the same three numbers.
"""

from __future__ import annotations

import argparse

import numpy as np

from perfbench.core.driver import Base, check, port, tf32
from perfbench.core.synthetic import face_store
from perfbench.counts import kernels, models
from perfbench.reference import lightcnn29, train, weights

STEPS = 3


def leaf_gaps(got: dict, want: dict, ref_grad: dict) -> dict:
    """Each leaf's gap of norms, ``got`` against ``want``, over the larger
    of ``want``'s norm and its median leaf's. Leaves whose reference
    gradient is under a thousandth of the median leaf's move under Adam by
    round-off alone (a key's bias under softmax): they are left out."""
    med = float(np.median(list(ref_grad.values())))
    live = [k for k in ref_grad if ref_grad[k] >= 1e-3 * med]
    m = float(np.median([want[k] for k in live]))
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], m)
            for k in live}


class Driver(Base):
    kind = "train"

    def setup(self) -> None:
        torch = self.torch
        self.full_f32()
        cfg, t = self.cfg, self.traffic
        rec = cfg["train"]
        hw = tuple(cfg["input_hw"])
        self.pairs = t["pairs"]
        self.images, self.labels = face_store(
            self.seed, t["identities"], t["images_per_identity"], hw,
            cfg["num_classes"], self.device)
        self.weights = weights.make(lightcnn29.specs(cfg), self.seed,
                                    self.device, gain=cfg["init_gain"])
        tb = port("cli.train_backbone")
        tr = port("train")
        model = port("models").model_by_name(
            "lightcnn29", cfg["num_classes"], input_hw=hw,
            generator=torch.Generator().manual_seed(self.seed),
            device=self.device)
        weights.load_into(model, self.weights)
        steps_per_epoch = max(self.images.shape[0] // self.pairs, 1)
        tx = tr.backbone_optimizer(
            "adam", base_lr=rec["lr"],
            decay_every_steps=steps_per_epoch * rec["lr_decay_epochs"],
            factor=rec["lr_factor"], weight_decay=rec["weight_decay"])
        self.state = tr.create_train_state(model, tx, self.seed)
        self.step_fn = tr.make_backbone_train_step(
            margin=rec["margin"], alpha=rec["alpha"],
            mining_mode=rec["mining"])
        args = argparse.Namespace(seed=self.seed,
                                  shuffle_window=rec["shuffle_window"])
        batcher = tb.make_batcher(self.images, self.labels, self.pairs, args,
                                  True)
        self.batches = tb.MirrorBatches(batcher, True, self.seed)
        self._iter = iter(self.batches)
        self.steps_per_epoch = len(batcher)
        self.every = steps_per_epoch * rec["lr_decay_epochs"]
        rng = np.random.default_rng([self.seed, 5])
        self.replay_at = self.steps_per_epoch + int(
            rng.integers(0, max(self.steps_per_epoch // 2, 1)))
        self.taken = 0
        self.replay = None
        self._first_steps()
        if self.fault == "control":
            self._control()

    def _batch(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self.batches)
            return next(self._iter)

    def _train_step(self):
        """One step of the program (or the fault under test); its scalar
        metrics on the host. The step the check replays is bracketed by a
        copy of the state before it and a record after it."""
        at = self.taken == self.replay_at
        if at:
            self._snapshot()
        anc, pos, lab = self._batch()
        if self.fault == "half":
            h = self.pairs // 2
            anc, pos, lab = anc[:h], pos[:h], lab[:h]
        if self.fault == "stale":
            out = {"loss": float(self.losses[-1] if self.losses else 0.0)}
        else:
            self.state, metrics = self.step_fn(self.state, anc, pos, lab)
            if self.fault == "alter":
                metrics = dict(metrics)
                metrics["loss"] = metrics["loss"] * 1.01
            # the CLI's loop: every scalar metric to the host
            out = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
        self.taken += 1
        if at:
            self._record(out["loss"])
        return out

    def _moments(self, p):
        """Adam's ``(exp_avg, exp_avg_sq, step)`` of ``p`` (zeros before
        its first update)."""
        st = self.state.optimizer.state.get(p)
        if not st:
            zero = self.torch.zeros_like(p)
            return zero, zero, 0.0
        return st["exp_avg"], st["exp_avg_sq"], float(st["step"])

    def _snapshot(self) -> None:
        """The parameters and Adam's state before the replayed step."""
        snap = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}, "step": {}}
        with self.torch.no_grad():
            for k, p in self.state.model.named_parameters():
                m, v, n = self._moments(p)
                snap["params"][k] = p.detach().clone()
                snap["exp_avg"][k] = m.clone()
                snap["exp_avg_sq"][k] = v.clone()
                snap["step"][k] = n
        self.snap = snap

    def _record(self, loss: float) -> None:
        """The replayed step's loss, and each parameter's gradient as Adam
        took it and change, as norms kept on the device."""
        torch = self.torch
        if self.fault == "control":
            with tf32(torch):
                loss, grad, change = self._replay()
        else:
            params = dict(self.state.model.named_parameters())
            snap = self.snap
            with torch.no_grad():
                grad = {k: (self._moments(params[k])[0]
                            - 0.9 * snap["exp_avg"][k]) / 0.1
                        for k in snap["params"]}
                change = {k: params[k].detach() - snap["params"][k]
                          for k in snap["params"]}
        keys = sorted(grad)
        self.replay = {"loss": float(loss), "keys": keys,
                       "grad": torch.stack([grad[k].norm() for k in keys]),
                       "change": torch.stack([change[k].norm()
                                              for k in keys])}

    def _replay(self):
        return train.replay(self.snap, self.weights, self.images,
                            self.labels, self.seed, self._recipe(),
                            self.replay_at, self.every, self.device)

    def check_steps(self) -> int:
        return self.replay_at - STEPS + 1

    def _first_steps(self) -> None:
        torch = self.torch
        params = dict(self.state.model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        self.losses = []
        for s in range(STEPS):
            self.losses.append(float(self._train_step()["loss"]))
            if s == 0:
                opt = self.state.optimizer
                self.grad_norms = {
                    k: float(opt.state[p]["exp_avg"].norm() / 0.1)
                    if p in opt.state else 0.0 for k, p in params.items()}
        with torch.no_grad():
            self.change_norms = {k: float((p - start[k]).norm())
                                 for k, p in params.items()}
        del start
        self.sync()

    def _control(self) -> None:
        """The reference in the program's place, in TF32, through the same
        three steps (and, in ``_record``, through the replayed step)."""
        with tf32(self.torch):
            losses, first, change = train.run(
                self.weights, self.images, self.labels, self.seed,
                self._recipe(), STEPS, self.device)
        self.losses = losses
        self.grad_norms = {k: float(v.norm()) for k, v in first.items()}
        self.change_norms = {k: float(v.norm()) for k, v in change.items()}

    def _recipe(self) -> dict:
        return {**self.cfg["train"], "pairs": self.pairs}

    def step(self) -> None:
        self._train_step()

    def window_stats(self, win: dict) -> dict:
        self.attempted = win["steps"] * 2 * self.pairs
        return {"train_images_per_s": self.attempted / win["seconds"]}

    def calls(self) -> dict:
        return kernels.train_calls(self.cfg, self.pairs)

    def flops_per_step(self) -> int:
        return models.lightcnn29_train(2 * self.pairs,
                                       tuple(self.cfg["input_hw"]),
                                       self.cfg["num_classes"])

    def close(self) -> None:
        if self.replay is not None:
            self.replay["grad"] = self.replay["grad"].tolist()
            self.replay["change"] = self.replay["change"].tolist()
        self.free("state", "step_fn", "batches", "_iter")

    def _replay_checks(self) -> dict:
        """The window's replayed step: loss, gradient and change."""
        names = ("replay_loss_gap", "replay_grad_gap", "replay_change_gap")
        if self.replay is None:
            return {k: check(float("inf"), self.limits[k]) for k in names}
        loss, grad, change = self._replay()
        grad = {k: float(v.norm()) for k, v in grad.items()}
        moved = {k: float(v.norm()) for k, v in change.items()}
        got = self.replay
        loss_gap = abs(got["loss"] - loss) / abs(loss)
        grad_gaps = leaf_gaps(dict(zip(got["keys"], got["grad"])), grad,
                              grad)
        values = (loss_gap, max(grad_gaps.values()),
                  max(leaf_gaps(dict(zip(got["keys"], got["change"])), moved,
                                grad).values()))
        self.detail.update(replay_at=self.replay_at, replay_grad_worst=max(
            grad_gaps, key=grad_gaps.get))
        return {k: check(v, self.limits[k]) for k, v in zip(names, values)}

    def check(self) -> dict:
        losses, first, change = train.run(
            self.weights, self.images, self.labels, self.seed,
            self._recipe(), STEPS, self.device)
        grad = {k: float(v.norm()) for k, v in first.items()}
        moved = {k: float(v.norm()) for k, v in change.items()}

        def worst(got, want):
            return max(leaf_gaps(got, want, grad).values())

        gaps = [abs(a - b) / abs(b) for a, b in zip(self.losses, losses)]
        self.detail = {"loss_gaps": gaps, "losses": losses}
        # the third step's loss is not held: Adam's sign-like first updates
        # carry rounding into it, which spreads twentyfold over seeds
        loss_gap = max(gaps[:2])
        return {"loss_gap": check(loss_gap, self.limits["loss_gap"]),
                "grad_gap": check(worst(self.grad_norms, grad),
                                  self.limits["grad_gap"]),
                "change_gap": check(worst(self.change_norms, moved),
                                    self.limits["change_gap"]),
                **self._replay_checks()}
