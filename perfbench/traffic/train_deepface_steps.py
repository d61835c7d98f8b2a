"""Back-to-back training steps of DeepFace as published (the program's
``deepface_cvpr14``) on the program's backbone step, fed as
``train_backbone`` feeds it, over 3-channel 152x152 uint8 faces.

The driver is ``train_steps.py``'s, with this net, its store and its
reference: the model, optimizer, state and step are built as
``train_backbone`` builds them (``model_by_name``, ``backbone_optimizer``,
``create_train_state``, ``make_backbone_train_step``) and fed by the CLI's
batcher and host mirror; set-up records steps 1-3 (loss, first gradient,
change) and the window records one step past the first epoch's end; the
check runs the plain reference (``reference/train_deepface.py``) through
the same steps and compares by the worst parameter.

Near-ties: DeepFace's 4,096-d features are nearly parallel, so a
semi-hard pick can rest on distances within rounding of each other. On
the recorded steps the driver keeps F7's output (a forward hook: the
program's computation is untouched) and, at the check, works out the
program's picks from it with the program's own mining, as its step
does. The reference takes each pick where a near-tie explains it, and
the check holds the largest such distance (``tie``) on step 1 and the
replayed step, which both sides start from one state; on steps 2-3 it
only asks that each pick be a negative of its anchor (``check``). The
fault ``unchanged`` runs each step and then puts the parameters back.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from perfbench.core.driver import check, port, tf32
from perfbench.core.synthetic import _field, generator
from perfbench.counts import deepface as counts
from perfbench.reference import deepface, train_deepface, weights
from perfbench.traffic import train_steps
from perfbench.traffic.train_steps import STEPS, leaf_gaps


def rgb_face_store(seed: int, identities: int, per_id: int, hw,
                   classes: int, device):
    """``(images [n, H, W, 3] uint8, labels [n] int64)`` numpy arrays, as
    ``core/synthetic.py::face_store`` makes them, in three channels."""
    gen = generator(seed, 3, device)
    h, w = hw
    ids = torch.randperm(classes, generator=gen, device=device)[:identities]
    base = _field(gen, identities, h, w, 3, device, cell=16)
    own = _field(gen, identities * per_id, h, w, 3, device)
    x = base.repeat_interleave(per_id, 0) * 50.0 + own * 20.0 + 128.0
    x = x + 8.0 * torch.randn(x.shape, generator=gen, device=device)
    images = x.clamp(0, 255).to(torch.uint8).cpu().numpy()
    labels = ids.repeat_interleave(per_id).cpu().numpy().astype(np.int64)
    return images, labels


class Driver(train_steps.Driver):
    def setup(self) -> None:
        torch = self.torch
        self.full_f32()
        cfg, t = self.cfg, self.traffic
        rec = cfg["train"]
        hw = tuple(cfg["input_hw"])
        self.pairs = t["pairs"]
        # the model first: a program without this ladder fails here, at once
        model = port("models").model_by_name(
            cfg["model"], cfg["num_classes"], input_hw=hw,
            in_channels=cfg["in_channels"],
            generator=torch.Generator().manual_seed(self.seed),
            device=self.device)
        self.images, self.labels = rgb_face_store(
            self.seed, t["identities"], t["images_per_identity"], hw,
            cfg["num_classes"], self.device)
        self.weights = weights.make(deepface.specs(cfg), self.seed,
                                    self.device, gain=cfg["init_gain"])
        weights.load_into(model, self.weights)
        tb = port("cli.train_backbone")
        tr = port("train")
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
        self.batches = tb.MirrorBatches(batcher, True, self.seed,
                                        pin=self.device.type == "cuda")
        self._iter = iter(self.batches)
        self.steps_per_epoch = len(batcher)
        self.every = steps_per_epoch * rec["lr_decay_epochs"]
        rng = np.random.default_rng([self.seed, 5])
        self.replay_at = self.steps_per_epoch + int(
            rng.integers(0, max(self.steps_per_epoch // 2, 1)))
        self.taken = 0
        self.replay = None
        # step -> F7's output and the batch's labels; then -> the picks
        self.kept, self.picks = {}, {}
        self.replay_tie = float("inf")
        self._first_steps()
        if self.fault == "control":
            self._control()

    def _batch(self):
        batch = super()._batch()
        self._labels = batch[2]
        return batch

    def _keep_f7(self, module, inputs, output) -> None:
        self._f7 = output.detach()

    def _train_step(self):
        """The program's step (``train_steps.py``'s, with its faults),
        F7's output kept on the steps the check compares."""
        step = self.taken
        watch = self.fault != "control" and (step < STEPS
                                             or step == self.replay_at)
        model = self.state.model
        hook = model.f7.register_forward_hook(self._keep_f7) if watch \
            else None
        saved = None
        if self.fault == "unchanged":
            saved = [p.detach().clone() for p in model.parameters()]
        self._f7 = None
        try:
            out = super()._train_step()
        finally:
            if hook is not None:
                hook.remove()
        if saved is not None:
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
        if watch and self._f7 is not None:
            self.kept[step] = (self._f7, self._labels)
        return out

    def _program_picks(self) -> None:
        """Each kept step's negatives as the program's step mines them
        (``train/steps.py::_mine`` with kernel B1) from its F7 output."""
        mining = port("ops.cuda.mining")
        l2 = port("ops.distances").l2_normalize
        torch = self.torch
        with torch.no_grad():
            for step, (f7, lab) in self.kept.items():
                feat = torch.relu(f7)
                b = feat.shape[0] // 2
                lab = torch.as_tensor(np.asarray(lab)[:b],
                                      device=self.device).to(torch.int32)
                anc, pos = feat[:b], feat[b:]
                anc_n = l2(anc)
                pos_sq = torch.sum(torch.square(anc_n - l2(pos)), dim=-1)
                self.picks[step] = mining.semi_hard_mining(
                    anc_n, pos_sq, lab, l2(torch.cat([anc, pos])),
                    torch.cat([lab, lab])).long()
        self.kept = {}

    def _replay(self):
        loss, grad, change, own, tie = train_deepface.replay(
            self.snap, self.images, self.labels, self.seed, self._recipe(),
            self.replay_at, self.every, self.device,
            self.picks.get(self.replay_at))
        # the control's own picks stand for the program's
        self.picks.setdefault(self.replay_at, own)
        self.replay_tie = tie
        return loss, grad, change

    def _control(self) -> None:
        """The reference in the program's place, in TF32, through the same
        three steps (and, in ``_record``, through the replayed step)."""
        with tf32(self.torch):
            losses, first, change, owns, _ = train_deepface.run(
                self.weights, self.images, self.labels, self.seed,
                self._recipe(), STEPS, self.device)
        self.losses = losses
        self.grad_norms = {k: float(v.norm()) for k, v in first.items()}
        self.change_norms = {k: float(v.norm()) for k, v in change.items()}
        self.picks.update(enumerate(owns))

    def flops_per_step(self) -> int:
        return counts.train(2 * self.pairs, self.cfg)

    def lc_least_s(self) -> float:
        """The LC layers' least seconds a step."""
        return counts.lc_least_s(2 * self.pairs, self.cfg)

    def close(self) -> None:
        if self.replay is not None:
            self.replay["grad"] = self.replay["grad"].tolist()
            self.replay["change"] = self.replay["change"].tolist()
        self._f7 = None
        self.free("state", "step_fn", "batches", "_iter")

    def check(self) -> dict:
        self._program_picks()
        losses, first, change, _, ties = train_deepface.run(
            self.weights, self.images, self.labels, self.seed,
            self._recipe(), STEPS, self.device,
            [self.picks.get(s) for s in range(STEPS)])
        grad = {k: float(v.norm()) for k, v in first.items()}
        moved = {k: float(v.norm()) for k, v in change.items()}
        del first, change

        def worst(got, want):
            return max(leaf_gaps(got, want, grad).values())

        gaps = [abs(a - b) / abs(b) for a, b in zip(self.losses, losses)]
        first_gaps = leaf_gaps(self.grad_norms, grad, grad)
        top = sorted(first_gaps, key=first_gaps.get)[-3:]
        self.detail = {"loss_gaps": gaps, "losses": losses,
                       "grad_worst": {k: [first_gaps[k], self.grad_norms[k],
                                          grad[k]] for k in top}}
        # the third step's loss is not held, as in train_steps.py
        out = {"loss_gap": check(max(gaps[:2]), self.limits["loss_gap"]),
               "grad_gap": check(max(first_gaps.values()),
                                 self.limits["grad_gap"]),
               "change_gap": check(worst(self.change_norms, moved),
                                   self.limits["change_gap"]),
               **self._replay_checks()}
        ties = ties + [self.replay_tie]
        self.detail["ties"] = ties
        # the tie is held where both sides start from one state: step 1
        # and the replayed step. Adam's first update is sign-like, so
        # where rounding decides a gradient's sign the two sides'
        # parameters part by twice the rate, and steps 2-3's distances
        # differ by far more than rounding (up to 1.4e-3 on sound seeds):
        # there the program's picks are shared if each is a negative
        held = [ties[0], ties[-1]] + [t if math.isinf(t) else 0.0
                                      for t in ties[1:-1]]
        out["tie_gap"] = check(max(held), self.limits["tie"])
        return out
