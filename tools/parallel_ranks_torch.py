#!/usr/bin/env python3
"""One rank of a multi-rank run of the port's parallel paths on the card.

``chip_smoke.py parallel`` starts it under the launcher, one process a
rank, every rank on the one card (gloo, as the port's backend rule picks
when ranks share a card)::

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tools/parallel_ranks_torch.py JOB OUT_DIR [ARG ...]

Jobs (each through the entry points a user calls):

- ``head FEATURES TEST_FEATURES``: ``train_head --data-parallel`` at the
  head cell (batch 16384 split over the ranks, B1 over the gathered
  pool); every B1 call's picks against the plain version on the same
  inputs.
- ``backbone STORE MODEL FLAG REFERENCE [OTHER]``: ``train_backbone``
  with FLAG (``dp``: ``--data-parallel``; ``cpM``: ``--class-parallel
  M``), f32, ``semi_hard_fused``, margin 2: each step's gradients and
  updated ``fc2`` against the world-1 run's in REFERENCE (``fc2``: this
  rank's block), B1's picks and B2 / ``efm3_bwd`` calls against their
  plain versions; the gradients' gaps to a second world-1 run in OTHER
  are reported beside them. A data-parallel run's REFERENCE is a world-1
  run whose step computes what the ranks compute
  (:func:`ranks_in_one_process`).
- ``serve``: the slice's 16 streams of 240x320 (EFMNet342 at 64x64,
  random seeded MTCNN and net, 1,000 gallery rows) through
  ``make_gallery_sharded_multistream_pipeline`` with the gallery rows
  sharded over the ranks, against the unsharded pipeline on the same
  frames (all 16 at once, and in the ranks' 8-stream batches); every
  B5, B3 and B2 call of the sharded dispatch against its plain version.

Each rank writes ``OUT_DIR/rank<r>.json``: its job, backend, device,
launch counts (set to 0 just before the job's run, read just after),
seconds, peak GiB and checks. A failed check fails the rank's exit code.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the smoke test's helpers and constants)
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

PKG = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"

# a recorded B2 call's input is at most this many elements (the largest
# LightCNN29 activations would take GiBs of copies)
RECORD_NUMEL, RECORD_CALLS = 1 << 24, 3


def _counters():
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        efm3,
        mining,
        nms,
        stem,
    )

    return {"mining": mining.launches, "efm3": efm3.launches,
            "efm3_bwd": efm3.bwd_launches, "stem": stem.launches,
            "nms": nms.launches}


class Recorder:
    """Within ``with``: B1's calls in the train step (all), and B2's
    forward and backward calls (the first few of a bounded size), kept to
    be held to the plain versions after the run."""

    def __enter__(self):
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
            mfm,
        )
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
            efm3,
        )
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
            steps,
        )

        self.mining, self.fwd, self.bwd = [], [], []
        self._mods = steps, mfm, efm3
        self._saved = steps.semi_hard_mining, mfm.efm3_rows, efm3.efm3_rows_bwd

        def mine(*args):
            out = self._saved[0](*args)
            self.mining.append(([a.detach().clone() for a in args],
                                out.clone()))
            return out

        def fwd(x):
            out = self._saved[1](x)
            if len(self.fwd) < RECORD_CALLS and x.numel() <= RECORD_NUMEL:
                self.fwd.append((x.detach().clone(), out.detach().clone()))
            return out

        def bwd(x, g):
            out = self._saved[2](x, g)
            if len(self.bwd) < RECORD_CALLS and x.numel() <= RECORD_NUMEL:
                self.bwd.append((x.clone(), g.clone(), out.clone()))
            return out

        steps.semi_hard_mining, mfm.efm3_rows, efm3.efm3_rows_bwd = (
            mine, fwd, bwd)
        return self

    def __exit__(self, *exc):
        steps, mfm, efm3 = self._mods
        steps.semi_hard_mining, mfm.efm3_rows, efm3.efm3_rows_bwd = \
            self._saved
        return False

    def held(self) -> dict:
        """The recorded calls against the plain versions: B1's picks (a
        differing pick must be explained by rounding: a 1e-5 tie of the
        two picks' distances, or either on the semi-hard threshold within
        1e-5, ``chip_smoke._b1_gaps``), B2 forward and backward bit for
        bit."""
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
            efm3,
        )

        gaps = chip_smoke._b1_gaps(torch, self.mining)
        fwd_ok = all(torch.equal(out, efm3.efm3_rows_plain(x))
                     for x, out in self.fwd)
        bwd_ok = all(torch.equal(out, efm3.efm3_rows_bwd_plain(x, g))
                     for x, g, out in self.bwd)
        return {"b1_calls": len(self.mining),
                "b1_differing": gaps["differing"],
                "b1_unexplained": gaps["unexplained"],
                "b1_picks_negatives": gaps["all_negatives"],
                "b2_calls_held": len(self.fwd), "b2_bit_equal": fwd_ok,
                "efm3_bwd_calls_held": len(self.bwd),
                "efm3_bwd_bit_equal": bwd_ok}

    @staticmethod
    def b1_ok(held: dict) -> bool:
        return held["b1_unexplained"] == 0 and held["b1_picks_negatives"]


def record_grads(sink: list, fc2_after: list):
    """Make every train state's update first copy each parameter's
    gradient (by name, on the host) into ``sink``, and then the updated
    ``fc2`` weight into ``fc2_after``; returns an undo."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train.state import (
        TrainState,
    )

    update = TrainState.apply_update

    def apply_update(self):
        sink.append({n: p.grad.detach().cpu().clone()
                     for n, p in self.model.named_parameters()
                     if p.grad is not None})
        update(self)
        fc2_after.append(self.model.fc2.weight.detach().cpu().clone())

    TrainState.apply_update = apply_update

    def undo():
        TrainState.apply_update = update

    return undo


def ranks_in_one_process(ranks: int):
    """A stand-in for ``make_backbone_train_step`` whose step computes
    what ``ranks`` data ranks of a ``--data-parallel`` step compute, in
    one process and with no collective: each rank's rows (its block of
    the anchors and of the positives) embedded on their own, with that
    rank's generator (dropout) and BatchNorm statistics; every rank's
    anchors mined against the concatenated pool; the gradient of the sum
    of the ranks' losses divided by ``ranks``, the BatchNorm running
    statistics the mean of the ranks'. A world-1 run with ``--data-parallel``
    (whose step folds in data rank 0) patched with it is the reference
    of a multi-rank run: the same batch sizes through the net, the same
    dropout masks, the same picks. Returns an undo."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
        train,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.losses.triplet import (
        joint_id_triplet_loss,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.distances import (
        rowwise_cosine,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        steps,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train.state import (
        step_generator,
    )

    factory = train.make_backbone_train_step

    def make(*, margin, alpha, mining_mode, center_weight=0.0,
             mirror_augment=False, crop_size=None, compute_dtype=None,
             **_):
        if (center_weight or mirror_augment or crop_size is not None
                or compute_dtype is not None):
            raise ValueError("ranks_in_one_process: plain f32 steps only")

        def step(state, anchor, positive, labels):
            images, labels = steps._images(state, anchor, positive, labels)
            b = labels.shape[0]
            n = b // ranks
            model = state.model
            model.train()
            bufs = [t for t in model.buffers() if t.is_floating_point()]
            start = [t.clone() for t in bufs]
            moved = [torch.zeros_like(t) for t in bufs]
            ranked = []
            for r in range(ranks):
                rows = slice(r * n, (r + 1) * n)
                gen = step_generator(state, r)
                for t, s in zip(bufs, start):
                    t.copy_(s)
                steps._set_dropout_generator(model, gen)
                try:
                    logits, feat = model.classify(model.embed(torch.cat(
                        [images[:b][rows], images[b:][rows]])))
                finally:
                    steps._set_dropout_generator(model, None)
                for m, t in zip(moved, bufs):
                    m.add_(t)
                ranked.append((gen, labels[rows], logits, feat))
            pool = torch.cat([feat for *_, feat in ranked])
            pool_labels = torch.cat([torch.cat([lab, lab])
                                     for _, lab, *_ in ranked])
            state.optimizer.zero_grad(set_to_none=True)
            totals, scalars, pos_cos, neg_cos = [], [], [], []
            for gen, lab, logits, feat in ranked:
                anc, pos = feat[:n], feat[n:]
                neg = steps._mine(mining_mode, gen, anc, pos, pool, lab,
                                  pool_labels)
                total, id_loss, tl = joint_id_triplet_loss(
                    logits[:n], lab, anc, pos, neg, margin=margin,
                    alpha=alpha, normalize_embeddings=True)
                totals.append(total)
                with torch.no_grad():
                    acc = (torch.argmax(logits, dim=-1) == torch.cat(
                        [lab, lab])).float().mean()
                    scalars.append(torch.stack([total, id_loss, tl, acc]))
                    pos_cos.append(rowwise_cosine(anc, pos))
                    neg_cos.append(rowwise_cosine(anc, neg))
            sum(totals).backward()
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(ranks)
            with torch.no_grad():
                for t, m in zip(bufs, moved):
                    t.copy_(m / ranks)
            state.apply_update()
            mean = (sum(scalars) / ranks).detach()
            return state, {"loss": mean[0], "id_loss": mean[1],
                           "tl_loss": mean[2], "acc": mean[3],
                           "pos_cos": torch.cat(pos_cos),
                           "neg_cos": torch.cat(neg_cos)}

        return step

    train.make_backbone_train_step = make

    def undo():
        train.make_backbone_train_step = factory

    return undo


def backbone_argv(store, model, flag, out) -> list[str]:
    """The backbone runs' arguments: 3 steps of 64 pairs, f32,
    ``semi_hard_fused``, the CLI's Adam (SGD at its rate diverges from
    the random init at 55,005 classes), margin 2 (the triplet term, the
    only path into LightCNN29's ``fc1_bn``, is on)."""
    extra = (["--data-parallel"] if flag == "dp" else
             ["--class-parallel", flag[2:]] if flag.startswith("cp") else [])
    return ["--images", store, "--model", model, "--epochs", "1",
            "--batch-size", str(chip_smoke.BACKBONE_PAIRS), "--mining",
            "semi_hard_fused", "--margin", "2.0",
            "--device", "cuda", "--out-dir", out, *extra]


def _rel(got, want) -> float:
    den = float(torch.linalg.vector_norm(want.double()))
    num = float(torch.linalg.vector_norm((got - want).double()))
    return num / den if den else num


def _block(t, index: int, parts: int):
    n = t.shape[0] // parts
    return t[index * n:(index + 1) * n]


def job_head(out_dir, features, test_features):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        train_head,
    )

    argv = ["--features", features, "--test-features", test_features,
            "--batch-size", str(chip_smoke.HEAD_BATCH), "--epochs",
            str(chip_smoke.HEAD_EPOCHS), "--mining", "semi_hard_fused",
            "--device", "cuda", "--data-parallel", "--out-dir",
            os.path.join(out_dir, "head")]
    with Recorder() as rec:
        _, hist = train_head.main(argv)
    torch.cuda.synchronize()
    held = rec.held()
    # each call's (anchors, pool) shapes: local B x the gathered pool
    shapes = sorted({(tuple(args[0].shape), tuple(args[3].shape))
                     for args, _ in rec.mining})
    return {"losses": [s["loss"] for h in hist for s in h.steps],
            "valid_loss": [h.valid["loss"] for h in hist],
            "b1_shapes": shapes, **held}, Recorder.b1_ok(held)


def _grad_gaps(got: dict, want: dict, index: int, parts: int,
               fc2_sq: list) -> dict[str, float]:
    """Each parameter's relative gap of ``got`` to ``want`` (``fc2``: this
    rank's block of it), adding the ``fc2`` blocks' squared gap and norm
    to ``fc2_sq``."""
    gaps = {}
    for name, g in got.items():
        w = want[name]
        if name.startswith("fc2.") and parts > 1:
            w = _block(w, index, parts)
            fc2_sq[0] += float(((g - w).double() ** 2).sum())
            fc2_sq[1] += float((w.double() ** 2).sum())
        gaps[name] = _rel(g, w)
    return gaps


def job_backbone(out_dir, store, model, flag, reference, *other):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        train_backbone,
    )

    ref = torch.load(reference, weights_only=True)
    grads, fc2_after = [], []
    undo = record_grads(grads, fc2_after)
    try:
        with Recorder() as rec:
            state, hist = train_backbone.main(backbone_argv(
                store, model, flag, os.path.join(out_dir, "bb")))
        torch.cuda.synchronize()
    finally:
        undo()
    parts = int(flag[2:]) if flag.startswith("cp") else 1
    index = dist.get_rank() % parts
    steps, fc2_sq = [], [[0.0, 0.0] for _ in grads]
    for i, (got, want) in enumerate(zip(grads, ref["grads"])):
        gaps = _grad_gaps(got, want, index, parts, fc2_sq[i])
        worst = max(gaps, key=gaps.get)
        steps.append({"max_grad_rel_gap": gaps[worst], "at": worst,
                      "without_grad": sorted(set(want) - set(got)),
                      "zero_grads": sorted(n for n, g in got.items()
                                           if not bool(g.abs().max() > 0))})
    for path in other:
        for s, got, want in zip(steps, grads, torch.load(
                path, weights_only=True)["grads"]):
            gaps = _grad_gaps(got, want, index, parts, [0.0, 0.0])
            worst = max(gaps, key=gaps.get)
            s["other_max_grad_rel_gap"] = gaps[worst]
            s["other_at"] = worst
    fc2_gaps = [float((got - _block(want, index, parts)).abs().max())
                for got, want in zip(fc2_after, ref["fc2_after"])]
    losses = [s["loss"] for h in hist for s in h.steps]
    held = rec.held()
    result = {"steps": steps, "fc2_block_sq": fc2_sq,
              "fc2_local_shape": list(state.model.fc2.weight.shape),
              "fc2_max_abs_gap_after_step": fc2_gaps,
              "losses": losses, "reference_losses": ref["losses"], **held}
    ok = (held["b2_bit_equal"] and held["efm3_bwd_bit_equal"]
          and held["b2_calls_held"] > 0 and held["efm3_bwd_calls_held"] > 0
          and Recorder.b1_ok(held)
          and len(steps) == len(ref["grads"])
          and not any(s["without_grad"] or s["zero_grads"] for s in steps))
    return result, ok


def serving_setup(device):
    """The slice's nets, gallery and frames (``serve_demo --streams 16``'s
    seeded builds) on ``device``."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )

    args = serve_demo.build_parser().parse_args(
        chip_smoke.slice_argv(chip_smoke.STREAMS, "cuda"))
    model = serve_demo._embed_model(args, device)
    det = serve_demo._detector(args, device)
    import numpy as np

    rng = np.random.default_rng(args.seed + 1)
    gallery = rng.normal(size=(args.identities, model.feature_dim)).astype(
        np.float32)
    frames = torch.as_tensor(
        rng.uniform(0, 255, (args.streams, *chip_smoke.FRAME_HW, 3)),
        dtype=torch.float32, device=device)
    kw = dict(frame_h=chip_smoke.FRAME_HW[0], frame_w=chip_smoke.FRAME_HW[1],
              embed_size=args.image_size,
              thresholds=tuple(args.det_thresholds),
              sim_threshold=args.sim_threshold)
    return det, model, gallery, frames, kw


def job_serve(out_dir):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
        parallel,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        pipeline,
    )

    device = parallel.rank_device("cuda")
    det, model, gallery, frames, kw = serving_setup(device)
    mesh = parallel.make_2d_mesh(dist.get_world_size())
    gal_n, rows = pipeline.shard_gallery(gallery, mesh, device=device)
    sharded = pipeline.make_gallery_sharded_multistream_pipeline(
        det, model, mesh, device=device, **kw)
    sharded(frames, gal_n, rows)              # warm: cuDNN plans, caches
    torch.cuda.synchronize()
    for c in _counters().values():
        c.reset()
    with chip_smoke.PathCalls(keep=None, nms=True) as calls:
        out = sharded(frames, gal_n, rows)
        torch.cuda.synchronize()
    launches = {k: c.count for k, c in _counters().items()}
    held = chip_smoke.hold_path_calls(torch, calls.calls)
    unsharded = pipeline.make_multistream_pipeline(
        det, model, gallery, device=device, **kw)
    # the unsharded pipeline over all 16 streams at once, and over the
    # same 8-stream batches the ranks embed (cuDNN picks its algorithms
    # by batch size, which moves an embedding by rounding)
    whole = unsharded(frames)
    per = frames.shape[0] // dist.get_world_size()
    same = {k: torch.cat([unsharded(frames[i:i + per])[k]
                          for i in range(0, frames.shape[0], per)])
            for k in ("index", "found", "similarity")}
    sim_gap = float((out["similarity"] - same["similarity"]).abs().max())
    whole_gap = float((out["similarity"] - whole["similarity"]).abs().max())
    checks = {
        "index_equal": bool(torch.equal(out["index"], same["index"])
                            and torch.equal(out["index"], whole["index"])),
        "found_equal": bool(torch.equal(out["found"], same["found"])
                            and torch.equal(out["found"], whole["found"])),
        "similarity_atol_1e-5": sim_gap <= 1e-5,
        "some_found": bool(whole["found"].any()),
        "kernels_equal_plain": all(v["ok"] for v in held.values())
        and {"nms", "stem", "efm3"} <= set(held)}
    return {"launches_sharded_dispatch": launches, "held": held,
            "max_similarity_gap": sim_gap,
            "max_similarity_gap_16_stream_batch": whole_gap,
            "local_frames": frames.shape[0] // dist.get_world_size(),
            "gallery_block": list(gal_n.shape),
            "found": int(whole["found"].sum()), "checks": checks}, \
        all(checks.values())


JOBS = {"head": job_head, "backbone": job_backbone, "serve": job_serve}


def main(argv: list[str]) -> int:
    job, out_dir, *args = argv
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
        parallel,
    )

    device = parallel.rank_device("cuda")
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    with parallel.process_group("cuda"):
        rank, world = parallel.process_info()
        backend = dist.get_backend()
        torch.cuda.reset_peak_memory_stats()
        for c in _counters().values():
            c.reset()
        result, ok = JOBS[job](out_dir, *args)
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in _counters().items()}
        dist.barrier()
    report = {"job": job, "rank": rank, "world": world, "backend": backend,
              "device": str(device),
              "card": torch.cuda.get_device_name(device),
              "launches": launches, "ok": bool(ok),
              "seconds": time.perf_counter() - t0,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              **result}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f, default=str)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
