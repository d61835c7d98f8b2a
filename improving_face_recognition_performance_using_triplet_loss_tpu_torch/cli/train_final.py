"""Frozen-backbone + trainable 342-d projection training.

The port's ``train_final`` (the reference's final_efm.py), with the JAX
package's flags plus ``--device``: load an exported backbone (JAX's or the
port's ``train_backbone`` export; a random init from seed 1 without
``--export-dir``), freeze it, L2-normalize its features per row, and train
a bias-free Dense(342) head over them with the triplet loss (margin 0.2)
and SGD(2.4e-4, wd 1e-5), a checkpoint per epoch, the per-row cosine CSV,
and an export of the head. The frozen backbone runs at inference (kernels
B3 / B6 / B4 and B2 on the card), the head step's ``semi_hard_fused``
kernel B1. Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.train_final \\
        --images store.npz --export-dir runs/train_backbone/export
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

from ..train.steps import MINING_MODES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", help="train image store (.npz, or an mmap "
                                    "store directory)")
    p.add_argument("--eval-images")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--export-dir", help="frozen backbone export; random init "
                                        "if omitted")
    p.add_argument("--model", default="efmnet342",
                   choices=["lightcnn29", "efmnet342", "lightcnn9"])
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--out-dir", default="runs/train_final")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=40)
    p.add_argument("--head-dim", type=int, default=342)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--lr", type=float, default=2.4e-4)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--mining", default="random", choices=MINING_MODES)
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="parameter EMA decay for the head (0 disables); the "
                        "export uses the averaged weights")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def _synthetic_size(args) -> int:
    """The export's input side (its manifest), else 64."""
    if not args.export_dir:
        return 64
    with open(os.path.join(args.export_dir, "manifest.json")) as f:
        return int(json.load(f)["input"]["height"])


class FeatureBatches:
    """Run the frozen backbone over each batch's anchors and positives and
    yield their L2-normalized features (on the backbone's device)."""

    def __init__(self, batcher, extract, device):
        self.batcher, self.extract, self.device = batcher, extract, device

    def __iter__(self):
        for anc, pos, lab in self.batcher:
            _, fa = self.extract(torch.from_numpy(np.ascontiguousarray(
                anc)).to(self.device))
            _, fp = self.extract(torch.from_numpy(np.ascontiguousarray(
                pos)).to(self.device))
            yield fa, fp, lab


def main(argv=None):
    """Train the head; returns ``(state, [EpochStats])``."""
    args = build_parser().parse_args(argv)
    from ..data import PairBatcher
    from ..device import full_f32, resolve_device
    from ..eval.cosine import CosineSimilaritySink
    from ..extract import make_extract_fn
    from ..models import model_by_name
    from ..models.heads import LinearHead
    from ..serve.convert import from_jax_params
    from ..serve.export import export_params
    from ..train import (Checkpointer, create_train_state, get_ema_params,
                         make_head_train_step, sgd_wd, train_loop,
                         with_param_ema)
    from ._common import log_config, setup_logging
    from .train_backbone import load_images

    full_f32()
    device = resolve_device(args.device)
    log = setup_logging(os.path.join(args.out_dir, "log"), "train_final")
    log_config(log, args)

    args.synthetic_size = _synthetic_size(args)
    images, labels, _ = load_images(args)
    if images.dtype == np.uint8:  # an mmap store loads raw uint8
        images = np.asarray(images, np.float32) / 255.0
    batch = min(args.batch_size, images.shape[0])

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.export_dir:
        backbone = from_jax_params(args.export_dir, dtype=dtype,
                                   device=device)
    else:
        backbone = model_by_name(args.model, args.num_classes,
                                 input_hw=images.shape[1:3],
                                 in_channels=images.shape[3], dtype=dtype,
                                 generator=torch.Generator().manual_seed(1),
                                 device=device)
        log.warning("no --export-dir: frozen backbone is randomly "
                    "initialized")
    extract = make_extract_fn(backbone, normalize=True)

    feat_dim = backbone.feature_dim
    head = LinearHead(feat_dim, args.head_dim, device=device,
                      generator=torch.Generator().manual_seed(args.seed))
    tx = sgd_wd(lr=args.lr, weight_decay=args.weight_decay)
    if args.ema_decay > 0:
        tx = with_param_ema(tx, decay=args.ema_decay)
    state = create_train_state(head, tx, args.seed)
    head_step = make_head_train_step(margin=args.margin,
                                     mining_mode=args.mining)

    batcher = PairBatcher(images, labels, batch, shuffle=True, seed=args.seed)
    feature_batches = FeatureBatches(batcher, extract, device)
    ckpt = Checkpointer(os.path.join(args.out_dir, "ckpt"))
    sink = CosineSimilaritySink(
        os.path.join(args.out_dir, "cosine_similarity.csv"))
    state, history = train_loop(
        state, head_step, lambda: iter(feature_batches), epochs=args.epochs,
        sink=sink, checkpointer=ckpt)
    sink.flush()
    head = state.model
    if args.ema_decay > 0:
        head = copy.deepcopy(head)
        head.load_state_dict(get_ema_params(state))
        log.info("export uses EMA weights (decay %.4f)", args.ema_decay)
    export_params(os.path.join(args.out_dir, "export"), head.flax_params(),
                  model_name="linear_head", feature_dim=args.head_dim,
                  input_hw=(1, feat_dim), input_channels=1)
    log.info("done")
    return state, history


if __name__ == "__main__":
    main()
