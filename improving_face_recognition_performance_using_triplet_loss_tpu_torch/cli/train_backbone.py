"""Joint softmax + triplet backbone training.

The port's ``train_backbone``, with the JAX package's flags and defaults
plus ``--device``: LightCNN-29 (or EFMNet342, LightCNN9) from scratch at
1x128x128, batch 64 pairs, Adam(2.4e-4) with factor decay 0.88 every 6
epochs (coupled weight decay 1e-5), the ID softmax CE plus 0.1 x the
triplet loss at margin 0.2 with in-batch negatives, the per-row cosine
similarities appended to ``cosine_similarity.csv`` every batch, a
checkpoint per epoch (``--resume`` continues the same sequence of
updates), and an export (``weights.npz`` + ``manifest.json``, with
``batch_stats`` and, under ``--ema-decay``, the averaged weights) that the
port's extractor and the JAX package load. ``--mining semi_hard_fused``
mines with kernel B1 on the card, and every EFM3 runs kernel B2 forward
and backward. Runs on ``cuda`` unless ``--device cpu`` is given.
``--data-parallel`` and ``--class-parallel`` are not ported yet
(ROADMAP.md A10), nor is ``--model deepface`` (A12).

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.train_backbone \\
        --images store/ --epochs 2 --mining semi_hard_fused --out-dir /tmp/bb
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import os

import numpy as np
import torch

from ..models import MODEL_NAMES
from ..train.optim import FAMILIES
from ..train.steps import MINING_MODES

_ROADMAP = "ROADMAP.md queue A"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", help=".npz image store (images+labels), or a "
                                    "directory = streaming mmap store "
                                    "(pack_dataset --mmap)")
    p.add_argument("--shuffle-window", type=int, default=65536,
                   help="two-level shuffle window for the mmap store loader")
    p.add_argument("--eval-images", help="optional eval .npz image store")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--synthetic-channels", type=int, default=0,
                   help="0 = per-model default (1)")
    p.add_argument("--model", default="lightcnn29", choices=MODEL_NAMES)
    p.add_argument("--out-dir", default="runs/train_backbone")
    p.add_argument("--epochs", type=int, default=280)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2.4e-4)
    p.add_argument("--lr-factor", type=float, default=0.88)
    p.add_argument("--optimizer", default="adam", choices=FAMILIES,
                   help="the facenet optimizer family on the reference's "
                        "factor schedule (adam = the reference default)")
    p.add_argument("--lr-decay-epochs", type=int, default=6)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--center-loss-weight", type=float, default=0.0,
                   help="add center loss on the anchor embeddings")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="track a parameter EMA at this decay; the export "
                        "uses the averaged weights")
    p.add_argument("--mining", default="random", choices=MINING_MODES)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay f32)")
    p.add_argument("--no-mirror", action="store_true")
    p.add_argument("--device-augment", action="store_true",
                   help="mirror on the device inside the step instead of "
                        "on host numpy")
    p.add_argument("--crop-size", type=int,
                   help="rand_crop: pack images LARGER (e.g. 144) and "
                        "random-crop to this size on the device every step "
                        "(eval center-crops)")
    p.add_argument("--prefetch", type=int, default=0,
                   help="copy N batches to the device ahead of compute "
                        "(pinned buffers, a side stream); the backbone "
                        "step's card idles < 3%% without it")
    p.add_argument("--scan-chunk", type=int, default=0, metavar="K",
                   help="K train steps per call over K stacked batches; an "
                        "epoch's trailing partial chunk is dropped. Kept "
                        "for parity with the JAX CLI: the port runs the K "
                        "steps one by one, so it gains no speed")
    p.add_argument("--data-parallel", action="store_true",
                   help="not ported yet (ROADMAP.md A10)")
    p.add_argument("--class-parallel", type=int, default=0, metavar="M",
                   help="not ported yet (ROADMAP.md A10)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def _check_args(args) -> None:
    if args.data_parallel or args.class_parallel:
        flag = "--data-parallel" if args.data_parallel else "--class-parallel"
        raise SystemExit(f"{flag} is not ported; data and class "
                         f"parallelism are queued in {_ROADMAP}, item 10")
    if args.model == "deepface":
        raise SystemExit("--model deepface is not ported; DeepFace is "
                         f"queued in {_ROADMAP}, item 12")


def load_images(args):
    """``(images, labels, is_mmap)``: an mmap store stays a uint8 memmap
    (batches normalize on the device in the step); an ``.npz`` store is
    scaled to float32 [0, 1] on the host, as the JAX CLI does."""
    from ..data.records import load_image_store, load_image_store_mmap
    from ..data.synthetic import synthetic_faces

    if args.synthetic:
        channels = getattr(args, "synthetic_channels", 0) or 1
        images, labels = synthetic_faces(num_ids=16, per_id=16,
                                         size=args.synthetic_size,
                                         channels=channels, seed=args.seed)
        return images, labels, False
    if args.images:
        if os.path.isdir(args.images):
            images, labels = load_image_store_mmap(args.images)
            return images, labels, True
        images, labels = load_image_store(args.images)
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        return images, labels, False
    raise SystemExit("provide --images or --synthetic")


class MirrorBatches:
    """Host-side rand_mirror over a pair batcher (ImageRecordIter
    rand_mirror=True), a numpy copy of the JAX CLI's: each anchor and
    positive row is mirrored with probability 1/2."""

    def __init__(self, batcher, enabled: bool, seed: int):
        self.batcher = batcher
        self.enabled = enabled
        self.rng = np.random.default_rng(seed + 101)

    def __iter__(self):
        for anc, pos, lab in self.batcher:
            if self.enabled:
                flip = self.rng.random(anc.shape[0]) < 0.5
                anc = np.where(flip[:, None, None, None], anc[:, :, ::-1, :],
                               anc)
                flip = self.rng.random(pos.shape[0]) < 0.5
                pos = np.where(flip[:, None, None, None], pos[:, :, ::-1, :],
                               pos)
            yield anc, pos, lab


def main(argv=None):
    """Train; returns ``(state, [EpochStats])``."""
    args = build_parser().parse_args(argv)
    _check_args(args)
    from ..data import PairBatcher, ShardedPairBatcher, load_image_store
    from ..data.prefetch import prefetch_to_device
    from ..device import full_f32, resolve_device
    from ..eval.cosine import CosineSimilaritySink
    from ..models import model_by_name
    from ..serve.convert import export_model
    from ..train import (
        Checkpointer, PreemptionGuard, backbone_optimizer,
        create_train_state, get_ema_params, make_backbone_eval_step,
        make_backbone_train_step, make_scanned_step, resume_if_available,
        train_loop, with_param_ema,
    )
    from ._common import log_config, setup_logging

    full_f32()
    device = resolve_device(args.device)
    log = setup_logging(os.path.join(args.out_dir, "log"), "train_backbone")
    log_config(log, args)

    images, labels, is_mmap = load_images(args)
    num_classes = int(labels.max()) + 1
    batch = min(args.batch_size, images.shape[0])
    steps_per_epoch = max(images.shape[0] // batch, 1)
    log.info("images %s%s, %d classes, %d steps/epoch", images.shape,
             " [mmap]" if is_mmap else "", num_classes, steps_per_epoch)
    in_hw = tuple(images.shape[1:3])
    if args.crop_size:
        if args.crop_size > images.shape[1]:
            raise SystemExit(
                f"--crop-size {args.crop_size} exceeds packed size "
                f"{images.shape[1]}: pack larger (rand_crop recipe)")
        # the net is sized by the cropped input it sees
        in_hw = (args.crop_size, args.crop_size)

    model = model_by_name(args.model, num_classes, input_hw=in_hw,
                          in_channels=images.shape[3],
                          generator=torch.Generator().manual_seed(args.seed),
                          device=device)
    tx = backbone_optimizer(
        args.optimizer, base_lr=args.lr,
        decay_every_steps=steps_per_epoch * args.lr_decay_epochs,
        factor=args.lr_factor, weight_decay=args.weight_decay)
    if args.ema_decay > 0:
        tx = with_param_ema(tx, decay=args.ema_decay)
    aux = (torch.zeros(num_classes, model.feature_dim, device=device)
           if args.center_loss_weight > 0 else None)
    state = create_train_state(model, tx, args.seed, aux=aux)

    compute_dtype = torch.bfloat16 if args.bf16 else None
    train_step = make_backbone_train_step(
        margin=args.margin, alpha=args.alpha, mining_mode=args.mining,
        center_weight=args.center_loss_weight,
        mirror_augment=args.device_augment and not args.no_mirror,
        crop_size=args.crop_size, compute_dtype=compute_dtype)
    eval_step = make_backbone_eval_step(
        margin=args.margin, alpha=args.alpha, mining_mode=args.mining,
        crop_size=args.crop_size, compute_dtype=compute_dtype)
    if args.scan_chunk > 1:
        train_step = make_scanned_step(train_step)

    ckpt = Checkpointer(os.path.join(args.out_dir, "ckpt"))
    start_epoch = 0
    if args.resume:
        state, start_epoch = resume_if_available(ckpt, state)
        log.info("resumed at epoch %d", start_epoch)

    if is_mmap:
        # the streaming loader: windowed shuffle, uint8 batches normalized
        # on the device in the step
        batcher = ShardedPairBatcher(
            (images, labels), batch, shuffle=True,
            shuffle_window=args.shuffle_window, seed=args.seed)
    else:
        batcher = PairBatcher(images, labels, batch, shuffle=True,
                              seed=args.seed)
    host_mirror = not args.no_mirror and not args.device_augment
    train_batches = MirrorBatches(batcher, host_mirror, args.seed)
    eval_batches = None
    if args.eval_images:
        ei, el = load_image_store(args.eval_images)
        if ei.dtype == np.uint8:
            ei = ei.astype(np.float32) / 255.0
        eb = PairBatcher(ei, el, min(batch, ei.shape[0]), shuffle=False)
        eval_batches = lambda: iter(eb)  # noqa: E731

    sink = CosineSimilaritySink(
        os.path.join(args.out_dir, "cosine_similarity.csv"))
    batch_source = lambda: iter(train_batches)  # noqa: E731
    if args.prefetch > 0:
        batch_source = lambda: prefetch_to_device(  # noqa: E731
            iter(train_batches), size=args.prefetch, device=device)
    with PreemptionGuard() as guard:
        state, history = train_loop(
            state, train_step, batch_source, epochs=args.epochs,
            eval_step=eval_step if eval_batches else None,
            eval_batches=eval_batches, sink=sink, checkpointer=ckpt,
            checkpoint_every_epochs=args.checkpoint_every,
            start_epoch=start_epoch, preemption_guard=guard,
            scan_chunk=args.scan_chunk)
    sink.flush()

    net = state.model
    if args.ema_decay > 0:
        net = copy.deepcopy(net)
        net.load_state_dict(get_ema_params(state), strict=False)
        log.info("export uses EMA weights (decay %.4f)", args.ema_decay)
    export_model(os.path.join(args.out_dir, "export"), net,
                 extra={"precision": "bf16" if args.bf16 else "f32"})

    if history and importlib.util.find_spec("matplotlib") is not None:
        from ..eval.plots import draw_curve

        draw_curve(
            {"training": [h.train.get("acc", 0) * 100 for h in history],
             "testing": [h.valid.get("acc", 0) * 100 for h in history]},
            "accuracy", os.path.join(args.out_dir, "train_acc.jpg"))
    elif history:
        log.info("matplotlib is not installed: train_acc.jpg not drawn")
    log.info("done")
    return state, history


if __name__ == "__main__":
    main()
