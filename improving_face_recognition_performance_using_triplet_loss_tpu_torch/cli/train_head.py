"""Triplet-head training over precomputed features.

The port's ``train_head``, with the JAX package's flags plus ``--device``:
a bias-free Dense(128) head over 342-d feature rows, triplet loss at margin
0.5, SGD(2.4e-4, wd 1e-5), in-batch negative mining, the per-row
pos/neg cosine similarities appended to ``cosine_similarity.csv`` every
batch, a checkpoint per epoch (``--resume`` continues), and an export
(``weights.npz`` + ``manifest.json``) that the JAX package loads.
``--mining semi_hard_fused`` mines with kernel B1 on the card. Runs on
``cuda`` unless ``--device cpu`` is given. ``--data-parallel`` and
``--export-projector`` are not ported yet (ROADMAP.md A10, A13).

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.train_head \\
        --synthetic --epochs 3 --batch-size 256 --out-dir /tmp/head
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

from ..train.steps import MINING_MODES

_ROADMAP = "ROADMAP.md queue A"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--features", help=".npz feature store (features+labels)")
    p.add_argument("--train-img-csv", help="reference-format train_img.csv")
    p.add_argument("--train-id-csv", help="reference-format train_id.csv")
    p.add_argument("--test-features", help="optional eval .npz store")
    p.add_argument("--synthetic", action="store_true",
                   help="run on synthetic clustered features")
    p.add_argument("--out-dir", default="runs/train_head")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16384)
    p.add_argument("--embedding-dim", type=int, default=128)
    p.add_argument("--margin", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=2.4e-4)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--mining", default="random", choices=MINING_MODES)
    p.add_argument("--normalize-embeddings", action="store_true",
                   help="FaceNet-style triplet on L2-normalized head outputs "
                        "(reference uses raw outputs)")
    p.add_argument("--export-projector", action="store_true",
                   help="not ported yet (ROADMAP.md A13)")
    p.add_argument("--data-parallel", action="store_true",
                   help="not ported yet (ROADMAP.md A10)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="parameter EMA; the export uses the averaged "
                        "weights")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def load_features(args):
    from ..data import load_feature_store, read_feature_csv, read_labels_csv
    from ..data.synthetic import synthetic_features

    if args.synthetic:
        return synthetic_features(num_ids=256, per_id=16, dim=342,
                                  seed=args.seed)
    if args.features:
        return load_feature_store(args.features)
    if args.train_img_csv and args.train_id_csv:
        return (read_feature_csv(args.train_img_csv),
                read_labels_csv(args.train_id_csv).astype(np.int64))
    raise SystemExit("provide --features, --train-img-csv/--train-id-csv, "
                     "or --synthetic")


def _check_args(args) -> None:
    if args.data_parallel:
        raise SystemExit("--data-parallel is not ported; data parallelism "
                         f"is queued in {_ROADMAP}, item 10")
    if args.export_projector:
        raise SystemExit("--export-projector is not ported; the projector "
                         f"export is queued in {_ROADMAP}, item 13")


def main(argv=None):
    """Train; returns ``(state, [EpochStats])``."""
    args = build_parser().parse_args(argv)
    _check_args(args)
    from ..data import PairBatcher, load_feature_store
    from ..device import full_f32, resolve_device
    from ..eval.cosine import CosineSimilaritySink
    from ..models.heads import LinearHead
    from ..serve.export import export_params
    from ..train import (
        Checkpointer, PreemptionGuard, create_train_state, get_ema_params,
        make_head_eval_step, make_head_train_step, resume_if_available,
        sgd_wd, train_loop, with_param_ema,
    )
    from ._common import log_config, setup_logging

    full_f32()
    device = resolve_device(args.device)
    log = setup_logging(os.path.join(args.out_dir, "log"), "train_head")
    log_config(log, args)

    feats, labels = load_features(args)
    batch = min(args.batch_size, feats.shape[0])
    log.info("features: %s, %d identities", feats.shape,
             len(np.unique(labels)))

    model = LinearHead(feats.shape[1], args.embedding_dim, device=device,
                       generator=torch.Generator().manual_seed(args.seed))
    tx = sgd_wd(lr=args.lr, weight_decay=args.weight_decay)
    if args.ema_decay > 0:
        tx = with_param_ema(tx, decay=args.ema_decay)
    state = create_train_state(model, tx, args.seed)

    train_step = make_head_train_step(
        margin=args.margin, mining_mode=args.mining,
        normalize_embeddings=args.normalize_embeddings)
    eval_step = make_head_eval_step(margin=args.margin,
                                    mining_mode=args.mining)

    ckpt = Checkpointer(os.path.join(args.out_dir, "ckpt"))
    start_epoch = 0
    if args.resume:
        state, start_epoch = resume_if_available(ckpt, state)
        log.info("resumed at epoch %d", start_epoch)

    batcher = PairBatcher(feats, labels, batch, shuffle=True, seed=args.seed)
    eval_batches = None
    if args.test_features:
        ef, el = load_feature_store(args.test_features)
        eb = PairBatcher(ef, el, min(batch, ef.shape[0]), shuffle=False)
        eval_batches = lambda: iter(eb)  # noqa: E731

    sink = CosineSimilaritySink(
        os.path.join(args.out_dir, "cosine_similarity.csv"))
    with PreemptionGuard() as guard:
        state, history = train_loop(
            state, train_step, lambda: iter(batcher),
            epochs=args.epochs, eval_step=eval_step if eval_batches else None,
            eval_batches=eval_batches, sink=sink, checkpointer=ckpt,
            start_epoch=start_epoch, preemption_guard=guard)
    sink.flush()

    head = state.model
    if args.ema_decay > 0:
        head = copy.deepcopy(head)
        head.load_state_dict(get_ema_params(state))
        log.info("export uses EMA weights (decay %.4f)", args.ema_decay)
    export_params(os.path.join(args.out_dir, "export"), head.flax_params(),
                  model_name="linear_head", feature_dim=args.embedding_dim,
                  input_hw=(1, feats.shape[1]), input_channels=1)
    log.info("done; final train loss %g",
             history[-1].train["loss"] if history else float("nan"))
    return state, history


if __name__ == "__main__":
    main()
