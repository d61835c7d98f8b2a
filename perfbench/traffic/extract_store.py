"""Bulk feature extraction: repeated calls of the program's
``extract_features`` over a uint8 image store in host memory, at the
CLI's batch size, in float32.

The net is built as ``extract_features`` builds it (``model_by_name``) and
the benchmark's weights, made from the seed, are loaded into it. Each call
embeds every row of the store (uint8 batches uploaded and scaled on the
card), and returns the L2-normalized features and the top-1 ID of each row
on the host.

The check: rows drawn from the seed of the window's last call, their
features and top-1 against the plain reference's eval forward on the same
images. A top-1 that differs counts only where the reference's best two
logits are apart by more than rounding (random nets make near-ties).
"""

from __future__ import annotations

import numpy as np

from perfbench.core.driver import Base, check, port, tf32
from perfbench.core.synthetic import face_store
from perfbench.counts import kernels, models
from perfbench.reference import lightcnn29, weights
from perfbench.reference.plain import l2n


class Driver(Base):
    kind = "extract"

    def setup(self) -> None:
        torch = self.torch
        self.full_f32()
        cfg, t = self.cfg, self.traffic
        self.extract = port("extract").extract_features
        hw = tuple(cfg["input_hw"])
        model = port("models").model_by_name(
            "lightcnn29", cfg["num_classes"], input_hw=hw,
            generator=torch.Generator().manual_seed(self.seed),
            device=self.device)
        weights.load_into(model, self.cfg_weights())
        self.model = model
        del self._w
        self.batch = t["batch_size"]
        self.images, _ = face_store(self.seed, t["store_rows"], 1, hw,
                                    cfg["num_classes"], self.device)
        self.rows = self.images.shape[0]
        self.extract(self.model, self.images[:self.batch],
                     batch_size=self.batch)
        self.sync()
        self.last = None

    def _call(self):
        if self.fault == "control":
            feats, preds, _ = self._reference(
                np.arange(self.rows), self.cfg_weights(), precision=tf32)
            return feats, preds
        if self.fault == "half":
            feats, _, _, preds = self.extract(
                self.model, self.images[:self.rows // 2],
                batch_size=self.batch)
            return np.concatenate([feats, feats]), np.concatenate([preds,
                                                                   preds])
        feats, _, _, preds = self.extract(self.model, self.images,
                                          batch_size=self.batch)
        if self.fault == "alter":
            preds = preds.copy()
            preds[0] += 1
        return feats, preds

    def step(self) -> None:
        self.last = self._call()

    def window_stats(self, win: dict) -> dict:
        self.attempted = win["steps"] * self.rows
        return {"embeddings_per_s": self.attempted / win["seconds"]}

    def batches_per_step(self) -> int:
        return -(-self.rows // self.batch)

    def calls(self) -> dict:
        return kernels.extract_calls(self.cfg, self.batch)

    def flops_per_step(self) -> int:
        return self.batches_per_step() * models.lightcnn29(
            self.batch, tuple(self.cfg["input_hw"]), self.cfg["num_classes"])

    def close(self) -> None:
        self.free("model")

    def cfg_weights(self):
        if not hasattr(self, "_w"):
            self._w = weights.make(lightcnn29.specs(self.cfg), self.seed,
                                   self.device, gain=self.cfg["init_gain"])
        return self._w

    def _reference(self, rows, p, precision=None):
        """Features, top-1 and the best two logits' gap of ``rows``, in
        blocks of the batch size."""
        torch = self.torch
        feats, preds, gaps = [], [], []
        ctx = precision(torch) if precision else torch.no_grad()
        with ctx, torch.no_grad():
            for s in range(0, len(rows), self.batch):
                x = torch.as_tensor(self.images[rows[s:s + self.batch]],
                                    device=self.device).float()
                raw = lightcnn29.embed(p, x * np.float32(1 / 255.0))
                feat = l2n(lightcnn29.batch_norm(p, raw, train=False))
                top = torch.topk(lightcnn29.logits(p, raw), 2, dim=-1)
                feats.append(feat.cpu().numpy())
                preds.append(top.indices[:, 0].cpu().numpy())
                gaps.append((top.values[:, 0] - top.values[:, 1]).cpu()
                            .numpy())
        return (np.concatenate(feats), np.concatenate(preds),
                np.concatenate(gaps))

    def check(self) -> dict:
        feats_p, preds_p = self.last
        rng = np.random.default_rng(self.seed)
        rows = np.sort(rng.choice(self.rows, size=min(
            self.traffic["check_rows"], self.rows), replace=False))
        feats, preds, gaps = self._reference(rows, self.cfg_weights())
        gap = np.linalg.norm(feats_p[rows] - feats, axis=-1)
        spread = np.median(np.linalg.norm(feats - feats.mean(0), axis=-1))
        differ = (preds_p[rows] != preds) & (gaps > self.limits["tie"])
        return {"feature_gap": check(gap.max() / spread,
                                     self.limits["feature_gap"]),
                "top1_differ": check(int(differ.sum()), 0)}
