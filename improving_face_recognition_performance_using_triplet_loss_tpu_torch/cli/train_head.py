"""Triplet-head training over precomputed features.

The port's ``train_head``, with the JAX package's flags plus ``--device``:
a bias-free Dense(128) head over 342-d feature rows, triplet loss at margin
0.5, SGD(2.4e-4, wd 1e-5), in-batch negative mining, the per-row
pos/neg cosine similarities appended to ``cosine_similarity.csv`` every
batch, a checkpoint per epoch (``--resume`` continues), and an export
(``weights.npz`` + ``manifest.json``) that the JAX package loads.
``--mining semi_hard_fused`` mines with kernel B1 on the card. Runs on
``cuda`` unless ``--device cpu`` is given. ``--export-projector`` writes
the projector TSVs of the features before and after the head
(``eval/projector.py``). ``--data-parallel`` runs the step over a data
mesh of every rank: each rank draws the same global batch from the seed
and steps on its block, mining from the gathered pool (kernel B1 over
``local B x world * 2B``); run plainly it is a group of one, under
``python -m torch.distributed.run --nproc-per-node N`` it spans N ranks
(ranks that share a card talk over gloo), and only rank 0 writes logs,
the CSV, checkpoints and the export.

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
                   help="write the embedding-projector TSVs of the "
                        "features before and after the trained head")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each batch over every rank (a plain run is "
                        "one rank; launch with torch.distributed.run for "
                        "more)")
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


def main(argv=None):
    """Train; returns ``(state, [EpochStats])``."""
    args = build_parser().parse_args(argv)
    if args.data_parallel:
        from ..parallel import process_group, rank_device

        with process_group(args.device):
            return _main(args, rank_device(args.device))
    from ..device import resolve_device

    return _main(args, resolve_device(args.device))


def _main(args, device):
    from ..data import PairBatcher, load_feature_store
    from ..device import full_f32
    from ..models.heads import LinearHead
    from ..serve.export import export_params
    from ..train import (
        HEAD_METRIC_KEYS, Checkpointer, PreemptionGuard, create_train_state,
        get_ema_params, make_head_eval_step, make_head_train_step,
        resume_if_available, sgd_wd, shard_map_step, train_loop,
        with_param_ema,
    )
    from ._common import (is_writer, local_batches, log_config,
                          setup_logging, writer_sink)

    full_f32()
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

    axis = "data" if args.data_parallel else None
    train_step = make_head_train_step(
        margin=args.margin, mining_mode=args.mining, axis_name=axis,
        normalize_embeddings=args.normalize_embeddings)
    eval_step = make_head_eval_step(margin=args.margin,
                                    mining_mode=args.mining, axis_name=axis)
    mesh = None
    if args.data_parallel:
        from ..parallel import make_mesh

        mesh = make_mesh()
        train_step = shard_map_step(train_step, mesh, has_state_out=True,
                                    metric_keys=HEAD_METRIC_KEYS)
        eval_step = shard_map_step(eval_step, mesh, has_state_out=False,
                                   metric_keys=HEAD_METRIC_KEYS)

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
        eval_batches = lambda: local_batches(eb, mesh)  # noqa: E731

    sink = writer_sink(args.out_dir)
    with PreemptionGuard() as guard:
        state, history = train_loop(
            state, train_step, lambda: local_batches(batcher, mesh),
            epochs=args.epochs, eval_step=eval_step if eval_batches else None,
            eval_batches=eval_batches, sink=sink, checkpointer=ckpt,
            start_epoch=start_epoch, preemption_guard=guard)
    if sink is not None:
        sink.flush()

    if not is_writer():
        return state, history
    if args.export_projector:
        from ..eval.projector import export_projector

        with torch.no_grad():
            head_out = state.model(torch.from_numpy(
                np.ascontiguousarray(feats, np.float32)).to(device))
        export_projector(feats, labels,
                         os.path.join(args.out_dir, "projector_before"))
        export_projector(head_out.cpu().numpy(), labels,
                         os.path.join(args.out_dir, "projector_after"))
        log.info("projector TSVs written (before/after triplet)")

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
