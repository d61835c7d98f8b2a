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
``--model deepface`` trains the 3-channel DeepFace on the JAX twin's
ladder, ``--model deepface_cvpr14`` on the paper's (``--synthetic`` faces
at 72x72 at least: the floors are 65 and 72 pixels).

``--data-parallel`` shards each batch over the ranks (a data mesh of
every rank); ``--class-parallel M`` shards the ID softmax's ``fc2`` over M
ranks of a 2-D ``(data, model)`` mesh, the batch over the other axis.
The global batch is ``--batch-size`` either way: the ``.npz`` path draws
the same global batch on every rank from the seed and each data rank
takes its block (a world-1 run sees the same batches); an mmap store is
read in one contiguous shard a data rank (``host_id`` / ``num_hosts``),
``--batch-size / data ranks`` rows at a time, every rank stopping at the
smallest shard's count. Run plainly these flags are one rank; under
``python -m torch.distributed.run --nproc-per-node N`` they span N ranks
(gloo where ranks share a card), and only rank 0 writes the logs, the
CSV, checkpoints (``--class-parallel``: the whole ``fc2`` gathered) and
the export (always the whole ``fc2``).

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.train_backbone \\
        --images store/ --epochs 2 --mining semi_hard_fused --out-dir /tmp/bb
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import importlib.util
import itertools
import os

import numpy as np
import torch

from ..models import MODEL_NAMES, RGB_MODELS
from ..train.optim import FAMILIES
from ..train.steps import MINING_MODES
from ..utils.profiling import span


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
                   help="0 = per-model default (3 for deepface and "
                        "deepface_cvpr14, else 1)")
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
                   help="shard each batch over every rank (a plain run is "
                        "one rank; launch with torch.distributed.run for "
                        "more)")
    p.add_argument("--class-parallel", type=int, default=0, metavar="M",
                   help="shard the ID-softmax head over M ranks (a 2-D "
                        "data x model mesh)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def load_images(args):
    """``(images, labels, is_mmap)``: an mmap store stays a uint8 memmap
    (batches normalize on the device in the step); an ``.npz`` store is
    scaled to float32 [0, 1] on the host, as the JAX CLI does."""
    from ..data.records import load_image_store, load_image_store_mmap
    from ..data.synthetic import synthetic_faces

    if args.synthetic:
        # DeepFace is the RGB 152x152 pipeline: its synthetic stand-in
        # defaults to 3 channels and respects its ladder's floor (65 px,
        # the paper's 72; other CLIs share this loader with parsers that
        # have no --model)
        model = getattr(args, "model", "")
        channels = getattr(args, "synthetic_channels", 0) or (
            3 if model in RGB_MODELS else 1)
        size = args.synthetic_size
        if model in RGB_MODELS and size < 72:
            size = 72
        images, labels = synthetic_faces(num_ids=16, per_id=16, size=size,
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


class _Local:
    """This rank's block of each batch of ``batches`` (an iterable)."""

    def __init__(self, batches, mesh):
        self.batches, self.mesh = batches, mesh

    def __iter__(self):
        from ._common import local_batches

        return local_batches(self.batches, self.mesh)


def _host_array(shape, dtype, pin: bool) -> np.ndarray:
    """An empty numpy array, in page-locked memory (torch's caching host
    allocator, which takes the block back once the array is gone) where
    ``pin``."""
    if not pin:
        return np.empty(shape, dtype)
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    block = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return block.numpy().view(dtype).reshape(shape)


def _mirror(rows: np.ndarray, flip: np.ndarray,
            pin: bool = False) -> np.ndarray:
    """A copy of ``[N, H, W, C]`` ``rows`` with the rows ``flip`` selects
    mirrored left to right, page-locked where ``pin``. Each pixel is
    viewed as one C-wide item, so the reversed copy moves whole pixels:
    numpy's ``where`` over a reversed view of single uint8 channels took
    ~30 ms a 152x152x3 batch of 64 rows, this ~5, on one thread."""
    out = _host_array(rows.shape, rows.dtype, pin)
    out[...] = rows
    selected = rows[flip]
    pixel = np.dtype((np.void, selected.shape[3] * selected.itemsize))
    out.view(pixel)[flip] = selected.view(pixel)[:, :, ::-1]
    return out


class MirrorBatches:
    """Host-side rand_mirror over a pair batcher (ImageRecordIter
    rand_mirror=True), a numpy copy of the JAX CLI's: each anchor and
    positive row is mirrored with probability 1/2.

    Each batch is assembled (the batcher's next and the mirror, numpy
    alone) on one worker thread while the caller works on the batch
    before it, so the card does not wait for the host's copies; the same
    batches come in the same order, from the same draws, as assembled
    one by one. The caller's wait for a batch is the span
    ``train.batch``, closed before the batch is handed on.

    ``pin`` makes the mirrored copies in page-locked memory, so that the
    step's upload is the card's own copy and takes no host CPU; each
    batch's memory is its own, as unpinned."""

    def __init__(self, batcher, enabled: bool, seed: int, pin: bool = False):
        self.batcher = batcher
        self.enabled = enabled
        self.pin = pin
        self.rng = np.random.default_rng(seed + 101)

    def _assemble(self, batches):
        batch = next(batches, None)
        if batch is None or not self.enabled:
            return batch
        anc, pos, lab = batch
        anc = _mirror(anc, self.rng.random(anc.shape[0]) < 0.5, self.pin)
        pos = _mirror(pos, self.rng.random(pos.shape[0]) < 0.5, self.pin)
        return anc, pos, lab

    def __iter__(self):
        batches = iter(self.batcher)
        pool = concurrent.futures.ThreadPoolExecutor(1)
        ahead = pool.submit(self._assemble, batches)
        try:
            while True:
                with span("train.batch"):
                    batch = ahead.result()
                    if batch is None:
                        return
                    ahead = pool.submit(self._assemble, batches)
                yield batch
        finally:
            # closed early: the batch under way is dropped
            ahead.cancel()
            pool.shutdown(wait=True)


class TakeBatches:
    """The first ``steps`` batches of ``batcher`` each pass."""

    def __init__(self, batcher, steps: int):
        self.batcher, self.steps = batcher, steps

    def __iter__(self):
        return itertools.islice(iter(self.batcher), self.steps)


def make_batcher(images, labels, batch: int, args, is_mmap: bool,
                 data_rank: int = 0, data_ranks: int = 1):
    """The training batches a data rank iterates: from an mmap store, its
    contiguous shard (``host_id=data_rank``, ``num_hosts=data_ranks``)
    ``batch / data_ranks`` rows at a time, cut to the smallest shard's
    batch count so every rank takes as many steps; from an ``.npz``
    store, the global batches (the rank takes its block of each)."""
    from ..data import PairBatcher, ShardedPairBatcher

    if not is_mmap:
        return PairBatcher(images, labels, batch, shuffle=True,
                           seed=args.seed)
    local = batch // data_ranks
    # the streaming loader: windowed shuffle, uint8 batches normalized
    # on the device in the step
    batcher = ShardedPairBatcher(
        (images, labels), local, host_id=data_rank, num_hosts=data_ranks,
        shuffle=True, shuffle_window=args.shuffle_window, seed=args.seed)
    if data_ranks == 1:
        return batcher
    return TakeBatches(batcher, (images.shape[0] // data_ranks) // local)


def main(argv=None):
    """Train; returns ``(state, [EpochStats])``."""
    args = build_parser().parse_args(argv)
    if args.data_parallel or args.class_parallel:
        from ..parallel import process_group, rank_device

        with process_group(args.device):
            return _main(args, rank_device(args.device))
    from ..device import resolve_device

    return _main(args, resolve_device(args.device))


def _mesh(args, num_classes: int, batch: int):
    """The run's mesh (None without a parallel flag) and its data axis's
    ``(rank, size)``."""
    from ..parallel import axis_index, axis_size, make_2d_mesh, make_mesh

    if args.class_parallel:
        if num_classes % args.class_parallel:
            raise SystemExit(
                f"--class-parallel {args.class_parallel} must divide the "
                f"class count {num_classes}")
        if args.center_loss_weight > 0:
            raise SystemExit("--center-loss-weight is incompatible with "
                             "--class-parallel")
        mesh = make_2d_mesh(model_size=args.class_parallel)
    elif args.data_parallel:
        mesh = make_mesh()
    else:
        return None, 0, 1
    rank, size = axis_index(mesh, "data"), axis_size(mesh, "data")
    if batch % size:
        raise SystemExit(f"--batch-size {batch} must divide over the "
                         f"{size} data ranks")
    return mesh, rank, size


def _main(args, device):
    from ..data import PairBatcher, load_image_store
    from ..data.prefetch import prefetch_to_device
    from ..device import full_f32
    from ..models import model_by_name
    from ..serve.convert import export_model
    from ..train import (
        BACKBONE_METRIC_KEYS, Checkpointer, ClassShards, PreemptionGuard,
        backbone_optimizer, create_train_state, get_ema_params,
        infer_class_parallel_specs, make_backbone_eval_step,
        make_backbone_train_step, make_scanned_step, resume_if_available,
        shard_map_scanned_step, shard_map_scanned_step_2d, shard_map_step,
        shard_map_step_2d, train_loop, with_param_ema,
    )
    from ._common import (is_writer, local_batches, log_config,
                          setup_logging, writer_sink)

    full_f32()
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

    mesh, data_rank, data_ranks = _mesh(args, num_classes, batch)
    model = model_by_name(args.model, num_classes, input_hw=in_hw,
                          in_channels=images.shape[3],
                          generator=torch.Generator().manual_seed(args.seed),
                          device=device)
    shards = None
    if args.class_parallel:
        # every rank builds the whole model from the seed, then keeps its
        # block of the fc2 classes
        shards = ClassShards(infer_class_parallel_specs(
            model, num_classes, "model"), mesh)
        shards.shard_model_(model)
        log.info("class-parallel softmax: %d-way head shard x %d-way data",
                 args.class_parallel, data_ranks)
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
    data_axis = "data" if mesh is not None else None
    class_axis = "model" if args.class_parallel else None
    train_step = make_backbone_train_step(
        margin=args.margin, alpha=args.alpha, mining_mode=args.mining,
        axis_name=data_axis, class_axis_name=class_axis,
        center_weight=args.center_loss_weight,
        mirror_augment=args.device_augment and not args.no_mirror,
        crop_size=args.crop_size, compute_dtype=compute_dtype)
    eval_step = make_backbone_eval_step(
        margin=args.margin, alpha=args.alpha, mining_mode=args.mining,
        axis_name=data_axis, class_axis_name=class_axis,
        crop_size=args.crop_size, compute_dtype=compute_dtype)
    if shards is not None:
        train_step = (
            shard_map_scanned_step_2d(train_step, mesh, shards.specs)
            if args.scan_chunk > 1 else shard_map_step_2d(
                train_step, mesh, shards.specs, has_state_out=True))
        eval_step = shard_map_step_2d(eval_step, mesh, shards.specs,
                                      has_state_out=False)
    elif mesh is not None:
        train_step = (shard_map_scanned_step(train_step, mesh)
                      if args.scan_chunk > 1 else shard_map_step(
                          train_step, mesh, has_state_out=True))
        eval_step = shard_map_step(eval_step, mesh, has_state_out=False,
                                   metric_keys=BACKBONE_METRIC_KEYS)
    elif args.scan_chunk > 1:
        train_step = make_scanned_step(train_step)

    ckpt = Checkpointer(os.path.join(args.out_dir, "ckpt"), shards=shards)
    start_epoch = 0
    if args.resume:
        state, start_epoch = resume_if_available(ckpt, state)
        log.info("resumed at epoch %d", start_epoch)

    batcher = make_batcher(images, labels, batch, args, is_mmap, data_rank,
                           data_ranks)
    host_mirror = not args.no_mirror and not args.device_augment
    train_batches = MirrorBatches(batcher, host_mirror, args.seed,
                                  pin=device.type == "cuda")
    if not is_mmap:
        train_batches = _Local(train_batches, mesh)
    eval_batches = None
    if args.eval_images:
        ei, el = load_image_store(args.eval_images)
        if ei.dtype == np.uint8:
            ei = ei.astype(np.float32) / 255.0
        eb = PairBatcher(ei, el, min(batch, ei.shape[0]), shuffle=False)
        eval_batches = lambda: local_batches(eb, mesh)  # noqa: E731

    sink = writer_sink(args.out_dir)
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
    if sink is not None:
        sink.flush()

    net = state.model
    if args.ema_decay > 0:
        net = copy.deepcopy(net)
        net.load_state_dict(get_ema_params(state), strict=False)
        log.info("export uses EMA weights (decay %.4f)", args.ema_decay)
    if shards is not None:
        net = shards.full_model(net)   # every rank takes part
    if not is_writer():
        return state, history
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
