"""LFW 10-fold verification evaluation (BASELINE generator; SURVEY.md §6).

The port's ``lfw_eval``, with the JAX package's flags plus ``--device``:
given an image store of pair images (2N rows, interleaved) + ``issame``,
or precomputed pair embeddings, it extracts embeddings with the chosen
model in bfloat16, as the JAX CLI does, and reports accuracy / VAL@FAR
under the facenet protocol (facenet.py:428-520, ``eval/lfw.py``). The net
is an export (``--export-dir``, JAX or port; its tree names the model and
its manifest the input) or a random init of ``--model`` from seed 0. On
the card LightCNN29 and EFMNet342 run kernels B3 (on the tensor cores) and
B2, LightCNN9 at 128x128 kernel B6 (on the tensor cores); DeepFace runs
no kernel of the port. Runs on ``cuda`` unless ``--device cpu`` is
given.

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.lfw_eval \\
        --images pairs.npz --export-dir runs/bb/export
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..models import MODEL_NAMES


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--embeddings", help=".npz with embeddings1, embeddings2, issame")
    p.add_argument("--images", help=".npz image store of pair images "
                               "(2N rows, interleaved) + issame array")
    p.add_argument("--export-dir", help="exported model dir (serve/export.py)")
    p.add_argument("--model", default="lightcnn29", choices=MODEL_NAMES)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--distance-metric", type=int, default=0, choices=[0, 1])
    p.add_argument("--subtract-mean", action="store_true")
    p.add_argument("--far-target", type=float, default=1e-3)
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--out", help="write results JSON here")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def scale_pair_images(images: np.ndarray) -> np.ndarray:
    """uint8 pair images to [0, 1] float32 on the host, with the true
    division the JAX CLIs run in numpy (``images / 255.0``). The port's
    extractor would scale uint8 on the card as ``x * float32(1/255)``
    (the jitted form), which differs from this by an ulp on some pixels."""
    if images.dtype == np.uint8:
        return images.astype(np.float32) / 255.0
    return images


def pair_embeddings(model, images: np.ndarray, batch_size: int) -> np.ndarray:
    """L2-normalized embeddings of the pair images, one row per image."""
    from ..extract import extract_features

    feats, _, _, _ = extract_features(model, scale_pair_images(images),
                                      batch_size=batch_size)
    return feats


def evaluate_pairs(e1, e2, issame, args) -> dict:
    """The protocol's JSON result for pair embeddings ``e1``, ``e2``."""
    from ..eval import lfw

    _, _, acc, acc_std, val, val_std, far = lfw.evaluate(
        e1, e2, issame, nrof_folds=args.folds,
        distance_metric=args.distance_metric,
        subtract_mean=args.subtract_mean, far_target=args.far_target)
    return {"accuracy_mean": acc, "accuracy_std": acc_std,
            "val": val, "val_std": val_std, "far": far,
            "n_pairs": int(len(issame))}


def build_model(args, sample_shape, device):
    """The bf16 embedding net: ``--export-dir``'s, else ``--model`` at the
    images' size from seed 0."""
    import torch

    from ..models import model_by_name
    from ..serve.convert import from_jax_params

    if args.export_dir:
        return from_jax_params(args.export_dir, dtype=torch.bfloat16,
                               device=device)
    return model_by_name(args.model, args.num_classes,
                         input_hw=tuple(sample_shape[1:3]),
                         in_channels=sample_shape[3], dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0),
                         device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.embeddings:
        with np.load(args.embeddings) as z:
            e1, e2, issame = z["embeddings1"], z["embeddings2"], z["issame"]
    elif args.images:
        from ..device import full_f32, resolve_device

        full_f32()
        device = resolve_device(args.device)
        with np.load(args.images) as z:
            images, issame = z["images"], z["issame"]
        model = build_model(args, images.shape, device)
        emb = pair_embeddings(model, images, args.batch_size)
        e1, e2 = emb[0::2], emb[1::2]
    else:
        raise SystemExit("provide --embeddings or --images")

    result = evaluate_pairs(e1, e2, issame, args)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
