"""Batch feature extraction (reference extract_feacture_v2.py).

The port's ``extract_features``, with the JAX package's flags plus
``--device``: streams an image store (``.npz``, or a directory = the uint8
mmap store) through an embedding net, writing L2-normalized feature rows +
labels in the reference CSV layout (``feature_vector_{train,valid}.csv`` /
``label_{train,valid}.csv``) and the canonical ``{train,valid}.npz``
feature store, and logging each split's top-1 accuracy. The net is an
export (``--export-dir``, JAX or port; its manifest names the model and
the input) or a random init from seed 0. On the card LightCNN9 runs kernel
B6 (square inputs, multiples of 4) or B4 (other even sizes), LightCNN29
and EFMNet342 kernels B3 and B2. Runs on ``cuda`` unless ``--device cpu``
is given. ``--data-parallel`` and ``--int8`` are not ported yet
(ROADMAP.md A10, A13); ``--model deepface`` is not either (A12).

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.extract_features \\
        --synthetic --model lightcnn9 --out-dir /tmp/extract
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..models import MODEL_NAMES

_ROADMAP = "ROADMAP.md queue A"


class Extracted(NamedTuple):
    """One split's result: L2-normalized features, labels, top-1 accuracy,
    top-1 predictions and the extraction's seconds (without the file
    writes)."""
    features: np.ndarray
    labels: np.ndarray
    accuracy: float
    predictions: np.ndarray
    seconds: float


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-images", help="train image store: .npz, or a "
                                          "directory = streaming mmap store")
    p.add_argument("--valid-images", help="valid image store (.npz or mmap "
                                          "directory)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--export-dir", help="exported model (serve/export.py); "
                                        "random init if omitted")
    p.add_argument("--model", default="lightcnn29", choices=MODEL_NAMES)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--out-dir", default="runs/extract")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16")
    p.add_argument("--data-parallel", action="store_true",
                   help="not ported yet (ROADMAP.md A10)")
    p.add_argument("--int8", action="store_true",
                   help="not ported yet (ROADMAP.md A13)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def _check_args(args) -> None:
    if args.data_parallel:
        raise SystemExit("--data-parallel is not ported; data parallelism "
                         f"is queued in {_ROADMAP}, item 10")
    if args.int8:
        raise SystemExit("--int8 is not ported; int8 extraction is queued "
                         f"in {_ROADMAP}, item 13")


def _load_splits(args) -> dict:
    from ..data import load_image_store, load_image_store_mmap
    from ..data.synthetic import synthetic_faces

    if args.synthetic:
        size, ch = 64, 1
        if args.export_dir:
            # the export manifest knows the trained input size; a fixture at
            # any other size would fail at the dense layer
            with open(os.path.join(args.export_dir, "manifest.json")) as f:
                inp = json.load(f)["input"]
            size, ch = inp["height"], inp["channels"]
        return {"train": synthetic_faces(num_ids=8, per_id=8, size=size,
                                         channels=ch),
                "valid": synthetic_faces(num_ids=8, per_id=4, size=size,
                                         channels=ch, seed=1)}
    # a directory is the mmap store: its rows stay uint8 and are sliced per
    # batch, normalized on the device
    load = lambda p: (load_image_store_mmap(p) if os.path.isdir(p)  # noqa: E731
                      else load_image_store(p))
    splits = {}
    if args.train_images:
        splits["train"] = load(args.train_images)
    if args.valid_images:
        splits["valid"] = load(args.valid_images)
    return splits


def _build_model(args, sample: np.ndarray, device, log):
    from ..models import model_by_name
    from ..serve.convert import from_jax_params

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.export_dir:
        return from_jax_params(args.export_dir, dtype=dtype, device=device)
    log.warning("no --export-dir: using randomly initialized %s", args.model)
    return model_by_name(args.model, args.num_classes,
                         input_hw=sample.shape[1:3],
                         in_channels=sample.shape[3], dtype=dtype,
                         generator=torch.Generator().manual_seed(0),
                         device=device)


def _extract_split(model, images, labels, out_dir, split, batch_size, log):
    from ..data.feature_store import (save_feature_store, write_feature_csv,
                                      write_labels_csv)
    from ..extract import extract_features

    tic = time.perf_counter()
    feats, labels, acc, preds = extract_features(model, images, labels,
                                                 batch_size=batch_size)
    seconds = time.perf_counter() - tic
    fcsv = os.path.join(out_dir, f"feature_vector_{split}.csv")
    lcsv = os.path.join(out_dir, f"label_{split}.csv")
    for pth in (fcsv, lcsv):
        if os.path.exists(pth):
            os.remove(pth)
    write_feature_csv(fcsv, feats)
    write_labels_csv(lcsv, labels)
    save_feature_store(os.path.join(out_dir, f"{split}.npz"), feats, labels)
    log.info("[%s] %d rows, dim %d, acc %.4f, %.1f sec (%.1f rows/s "
             "extracting)", split, feats.shape[0], feats.shape[1], acc,
             time.perf_counter() - tic, feats.shape[0] / seconds)
    return Extracted(feats, labels, acc, preds, seconds)


def main(argv=None):
    """Extract every split; returns ``{split: Extracted}``."""
    args = build_parser().parse_args(argv)
    _check_args(args)
    from ..device import full_f32, resolve_device
    from ._common import log_config, setup_logging

    full_f32()
    device = resolve_device(args.device)
    log = setup_logging(os.path.join(args.out_dir, "log"), "extract")
    log_config(log, args)
    os.makedirs(args.out_dir, exist_ok=True)
    splits = _load_splits(args)
    if not splits:
        raise SystemExit("provide --train-images/--valid-images or "
                         "--synthetic")
    model = _build_model(args, next(iter(splits.values()))[0], device, log)
    return {split: _extract_split(model, images, labels, args.out_dir, split,
                                  args.batch_size, log)
            for split, (images, labels) in splits.items()}


if __name__ == "__main__":
    main()
