"""Closed-loop multi-camera serving: each dispatch hands the program's
multi-stream pipeline a batch of new uint8 frames in host memory, one a
camera, and reads back what a server acts on.

The pipeline is built as ``serve_demo --streams`` builds it
(``_embed_model``, ``_detector``, ``make_multistream_pipeline`` with the
demo's keywords); the benchmark's weights, made from the seed, are loaded
into its nets, and its gallery is the benchmark's. Frames come from a
pool of ``pool_dispatches`` distinct dispatches made from the seed, and
are cycled only once the window has used them all; the pipeline uploads
and converts them itself. ``found``, ``index``, ``similarity`` and
``box`` come back to the host at every dispatch: a frame's latency runs
from the call to its results on the host, and every frame of a dispatch
shares it.

The gallery is N(0, 1) rows from the seed, except that a noisy copy of
the plain reference's own embedding of each checked frame sits at a row
drawn from the seed: random-weight embeddings are near-parallel, so
without it every frame would match one row. Set-up runs the reference's
cascade over the checked dispatches for that; the peak memory is read
from after it.

The check: on those dispatches the reference's cascade gives ``found`` and
``box``; it embeds each frame's crop at the program's box (so a near-tie
in the cascade does not hide the embedding net) and matches that embedding
against the gallery (``index`` and ``similarity``).
"""

from __future__ import annotations

import time

import numpy as np

from perfbench.core.driver import Base, check, port, tf32
from perfbench.core.synthetic import frames as make_frames
from perfbench.core.synthetic import generator
from perfbench.counts import kernels, models
from perfbench.reference import mtcnn, weights
from perfbench.reference.plain import l2n

READBACK = ("found", "index", "similarity", "box")


class Driver(Base):
    kind = "serve"

    def _gallery(self, p):
        """The enrolled rows, with each checked frame's own row planted;
        keeps the reference's ``found`` and ``box`` of the checked
        dispatches for the check."""
        torch = self.torch
        cfg = self.cfg
        c = cfg["cascade"]
        h, w = cfg["frame_hw"]
        g = generator(self.seed, 1, self.device)
        d = cfg["embed"]["fc1"] * 2 // 3
        gal = torch.randn((cfg["gallery_rows"], d), generator=g,
                          device=self.device)
        self.ref_faces, embs = {}, []
        with torch.no_grad():
            for n in sorted(self.sample):
                slot = (self.offset + n) % self.slots
                fr = self._frames(slot).to(self.device).float()
                found, box = mtcnn.select_face(mtcnn.cascade(p, fr, c), h, w,
                                               c["margin"])
                self.ref_faces[slot] = (found, box)
                embs.append(mtcnn.embed_boxes(p, fr, box,
                                              cfg["embed"]["image_size"])
                            [found])
            emb = torch.cat(embs)
            if emb.shape[0]:
                rows = torch.randperm(gal.shape[0], generator=g,
                                      device=self.device)[:emb.shape[0]]
                spread = (emb - emb.mean(0)).norm(dim=-1).median()
                noise = l2n(torch.randn(emb.shape, generator=g,
                                        device=self.device))
                gal[rows] = emb + noise * spread * self.traffic["plant_noise"]
        return gal.cpu()

    def setup(self) -> None:
        self.full_f32()
        cfg, t = self.cfg, self.traffic
        serve_demo = port("cli.serve_demo")
        pipeline = port("serve.pipeline")
        c, e = cfg["cascade"], cfg["embed"]
        h, w = cfg["frame_hw"]
        self.streams = s = t["streams"]
        args = serve_demo.parse_args([
            "--streams", str(s), "--frame-size", str(h), str(w),
            "--image-size", str(e["image_size"]),
            "--num-classes", str(e["num_classes"]),
            "--identities", str(cfg["gallery_rows"]),
            "--det-thresholds", *map(str, c["thresholds"]),
            "--sim-threshold", str(cfg["sim_threshold"]),
            "--seed", str(self.seed), "--device", self.device.type])
        model = serve_demo._embed_model(args, self.device)
        det = serve_demo._detector(args, self.device)
        p = weights.make(mtcnn.specs(cfg), self.seed, self.device)
        for net in ("pnet", "rnet", "onet"):
            weights.load_into(getattr(det, net), p, net + ".")
        weights.load_into(model, p, "embed.")
        self.slots = t["pool_dispatches"]
        self.pool = make_frames(self.seed, self.slots * s, h, w, self.device)
        rng = np.random.default_rng(self.seed)
        self.sample = set(rng.choice(t["check_within"],
                                     size=t["check_dispatches"],
                                     replace=False).tolist())
        self.offset = t["warmup"]
        self.gallery = self._gallery(p)
        del p
        self.free()
        # the peak is the program's: the reference's pass is behind it
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats()
        rows = self.gallery.shape[0]
        if self.fault == "half_gallery":
            rows //= 2
        self.pipe = pipeline.make_multistream_pipeline(
            det, model, self.gallery[:rows].numpy(), frame_h=h, frame_w=w,
            embed_size=e["image_size"], thresholds=tuple(c["thresholds"]),
            sim_threshold=cfg["sim_threshold"], device=self.device)
        self.kept, self.enqueue, self.latency = [], [], []
        self.n = 0
        self._last = None
        for i in range(t["warmup"]):
            self._call(self._frames(i))
        self.sync()

    def _frames(self, i: int):
        j = i % self.slots
        return self.pool[j * self.streams:(j + 1) * self.streams]

    def _control(self, frames):
        """The reference in the program's place, in TF32."""
        torch = self.torch
        if not hasattr(self, "_ctl"):
            self._ctl = (weights.make(mtcnn.specs(self.cfg), self.seed,
                                      self.device),
                         l2n(self.gallery.to(self.device)))
        p, gal = self._ctl
        h, w = self.cfg["frame_hw"]
        with tf32(torch), torch.no_grad():
            fr = frames.to(self.device).float()
            faces = mtcnn.cascade(p, fr, self.cfg["cascade"])
            found, box = mtcnn.select_face(faces, h, w,
                                           self.cfg["cascade"]["margin"])
            emb = mtcnn.embed_boxes(p, fr, box, self.cfg["embed"]["image_size"])
            idx, sim, _ = mtcnn.match(emb, gal)
        return {"found": found, "box": box, "embedding": emb,
                "index": torch.where(found & (sim >= self.cfg["sim_threshold"]),
                                     idx, -1),
                "similarity": torch.where(found, sim, -2.0)}

    def _call(self, frames):
        """The program's dispatch, or the fault under test."""
        if self.fault == "control":
            return self._control(frames)
        if self.fault == "half":
            half = self.pipe(frames[:self.streams // 2])
            return {k: v.repeat(2, *([1] * (v.ndim - 1)))
                    for k, v in half.items()}
        out = self.pipe(frames)
        if self.fault == "stale":
            last, self._last = self._last, out
            return out if last is None else last
        if self.fault == "alter":
            out = dict(out)
            out["index"] = out["index"].clone()
            out["index"][0] += 1
        return out

    def step(self) -> None:
        frames = self._frames(self.offset + self.n)
        t0 = time.perf_counter()
        out = self._call(frames)
        t1 = time.perf_counter()
        host = {k: out[k].cpu() for k in READBACK}
        t2 = time.perf_counter()
        self.enqueue.append(t1 - t0)
        self.latency.append(t2 - t0)
        if self.n in self.sample:
            self.kept.append(((self.offset + self.n) % self.slots, host,
                              out["embedding"]))
        self.n += 1

    def check_steps(self) -> int:
        return self.traffic["check_within"]

    def window_stats(self, win: dict) -> dict:
        n = win["steps"]
        self.attempted = n * self.streams
        self.window_enqueue_ms = float(np.mean(self.enqueue[:n]) * 1e3)
        # every frame of a dispatch shares its latency
        self.window_p95_ms = float(np.percentile(
            np.asarray(self.latency[:n]) * 1e3, 95))
        return {"frames_per_s": n * self.streams / win["seconds"]}

    def calls(self) -> dict:
        return kernels.serve_calls(self.cfg, self.streams)

    def flops_per_step(self) -> int:
        return models.serve_dispatch(self.cfg, self.streams)

    def close(self) -> None:
        self.kept = [(slot, host, emb.cpu()) for slot, host, emb in self.kept]
        self.free("pipe")

    def check(self) -> dict:
        torch = self.torch
        p = weights.make(mtcnn.specs(self.cfg), self.seed, self.device)
        gal = l2n(self.gallery.to(self.device))
        lim = self.limits
        found_differ = moved = frames_n = index_differ = 0
        emb_gaps, spreads, sim_gaps, picked, margins = [], [], [], [], []
        with torch.no_grad():
            for slot, host, emb_p in self.kept:
                fr = self._frames(slot).to(self.device).float()
                box_p = host["box"].to(self.device)
                found, rbox = self.ref_faces[slot]
                emb = mtcnn.embed_boxes(p, fr, box_p,
                                        self.cfg["embed"]["image_size"])
                idx, sim, margin = mtcnn.match(emb, gal)
                picked.append(idx[found])
                margins.append(margin[found])
                found_p = host["found"].to(self.device)
                found_differ += int((found != found_p).sum())
                both = found & found_p
                frames_n += int(both.sum())
                moved += int(((rbox - box_p).abs().amax(-1) > lim["box_px"])
                              [both].sum())
                emb_p = emb_p.to(self.device)
                emb_gaps.append((emb_p - emb).norm(dim=-1)[both])
                spreads.append((emb - emb.mean(0)).norm(dim=-1))
                sim_gaps.append((host["similarity"].to(self.device) - sim)
                                .abs()[both])
                differ = host["index"].to(self.device).long() != idx
                index_differ += int((differ & both
                                     & (margin > lim["tie"])).sum())
        if not self.kept:
            return {k: check(float("inf"), 0) for k in (
                "found_differ", "box_moved_pct", "embedding_gap",
                "similarity_gap", "index_differ")}
        picked, margins = torch.cat(picked), torch.cat(margins)
        # each checked frame has a gallery row of its own: how many rows the
        # reference picks, over how many frames, and their least margin
        self.detail = {"frames_checked": int(picked.numel()),
                       "rows_picked": int(picked.unique().numel()),
                       "least_margin": float(margins.min())
                       if margins.numel() else None}
        spread = float(torch.cat(spreads).median())
        emb_gap = float(torch.cat(emb_gaps).max()) / spread
        return {
            "found_differ": check(found_differ, 0),
            "box_moved_pct": check(100.0 * moved / max(frames_n, 1),
                                   lim["box_moved_pct"]),
            "embedding_gap": check(emb_gap, lim["embedding_gap"]),
            "similarity_gap": check(float(torch.cat(sim_gaps).max()),
                                    lim["similarity_gap"]),
            "index_differ": check(index_differ, 0)}
