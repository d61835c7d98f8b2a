"""One-command LFW harness: tarball/tree + pairs.txt -> accuracy table.

The port's ``lfw_run``, with the JAX package's flags plus ``--device``.
Given the LFW archive (or extracted tree) and pairs.txt, it runs the
chain the reference splits across align_dataset_mtcnn.py + validate_on_lfw-
style facenet evaluation (facenet.py:428-520): MTCNN align (``--align``,
with ``--device-cascade`` on the card's batched cascade) -> per-model
embedding extraction in bfloat16 -> 10-fold accuracy / VAL@FAR, one table
row per export (input size and channels from its manifest) or random-init
``--model``, with an optional append into BASELINE.md. Reading the pair
images needs cv2. ``--det-weights`` (the port's one flag beyond the JAX
CLI's and ``--device``) gives ``--align`` its detector's weights, where
the JAX CLI always aligns with a random-init detector. Runs on ``cuda``
unless ``--device cpu`` is given.

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.lfw_run \\
        --lfw lfw.tgz --pairs pairs.txt --align \\
        --export-dir runs/efm/export --append-baseline BASELINE.md
"""

from __future__ import annotations

import argparse
import json
import os
import tarfile
import tempfile

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lfw", required=True,
                   help="LFW .tgz/.tar.gz archive or extracted directory "
                        "(tree of <Name>/<Name>_NNNN.jpg)")
    p.add_argument("--pairs", required=True, help="pairs.txt protocol file")
    p.add_argument("--export-dir", action="append", default=[],
                   help="exported model dir (repeatable; one table row each)")
    p.add_argument("--model", action="append", default=[],
                   help="random-init model baseline row (repeatable; "
                        "pipeline smoke when no export exists)")
    p.add_argument("--align", action="store_true",
                   help="MTCNN-align the tree first (otherwise images are "
                        "center-used as-is, suitable for pre-aligned sets)")
    p.add_argument("--align-size", type=int, default=182)
    p.add_argument("--align-margin", type=int, default=44)
    p.add_argument("--device-cascade", action="store_true",
                   help="use the batched on-device MTCNN cascade for --align")
    p.add_argument("--det-weights", nargs=3, metavar=("DET1", "DET2", "DET3"),
                   help="det1/det2/det3 .npy weights of --align's detector "
                        "(the port's addition; random init otherwise, as "
                        "the JAX CLI always aligns — for pipeline testing "
                        "only)")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--far-target", type=float, default=1e-3)
    p.add_argument("--distance-metric", type=int, default=0, choices=[0, 1])
    p.add_argument("--subtract-mean", action="store_true")
    p.add_argument("--prewhiten", action="store_true",
                   help="per-image standardization of pair crops before "
                        "embedding (facenet validate_on_lfw convention) "
                        "instead of the 1/255 scale")
    p.add_argument("--file-ext", default="jpg")
    p.add_argument("--out", help="write results JSON here")
    p.add_argument("--append-baseline",
                   help="append the markdown table to this file")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def _resolve_lfw_dir(lfw: str, workdir: str) -> str:
    """Extract an archive if needed; return the directory whose children are
    identity folders."""
    if os.path.isdir(lfw):
        root = lfw
    else:
        with tarfile.open(lfw) as tf:
            tf.extractall(workdir, filter="data")
        root = workdir
    # descend through single-directory wrappers (lfw.tgz unpacks to lfw/)
    while True:
        entries = [e for e in sorted(os.listdir(root))
                   if not e.startswith(".")]
        dirs = [e for e in entries
                if os.path.isdir(os.path.join(root, e))]
        if len(dirs) == 1 and len(entries) == 1:
            root = os.path.join(root, dirs[0])
        else:
            break
    return root


def _load_pair_images(paths: list[str], hw: tuple[int, int],
                      channels: int) -> np.ndarray:
    import cv2

    out = np.empty((len(paths), hw[0], hw[1], channels), np.uint8)
    for i, p in enumerate(paths):
        img = cv2.imread(p)
        if img is None:
            raise SystemExit(f"undecodable pair image: {p}")
        if channels == 1:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[..., None]
        else:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)
        out[i] = img[..., None] if img.ndim == 2 else img
    return out


def _evaluate_one(name, model, paths, issame, args, log, input_hw, channels):
    import torch

    from ..data.records import prewhiten
    from ..eval import lfw
    from .lfw_eval import pair_embeddings

    images = _load_pair_images(paths, input_hw, channels)
    if args.prewhiten:
        images = prewhiten(torch.from_numpy(images)).numpy()
    # uint8 is scaled on the host, as the JAX CLI does
    emb = pair_embeddings(model, images, args.batch_size)
    _, _, acc, acc_std, val, val_std, far = lfw.evaluate(
        emb[0::2], emb[1::2], issame, nrof_folds=args.folds,
        distance_metric=args.distance_metric,
        subtract_mean=args.subtract_mean, far_target=args.far_target)
    row = {"name": name, "accuracy_mean": acc, "accuracy_std": acc_std,
           "val": val, "val_std": val_std, "far": far,
           "n_pairs": int(len(issame)), "embedding_dim": int(emb.shape[1])}
    log.info("%s: acc %.4f±%.4f, VAL %.4f±%.4f @ FAR %.5f", name, acc,
             acc_std, val, val_std, far)
    return row


def results_table(rows: list[dict]) -> str:
    lines = ["| Model | Accuracy | VAL | FAR | dim | pairs |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['accuracy_mean']:.4f}±"
            f"{r['accuracy_std']:.4f} | {r['val']:.4f}±{r['val_std']:.4f} "
            f"| {r['far']:.5f} | {r['embedding_dim']} | {r['n_pairs']} |")
    return "\n".join(lines)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ..data.lfw import get_paths, read_pairs
    from ..device import full_f32, resolve_device
    from ..models import RGB_MODELS, model_by_name
    from ..serve.convert import from_jax_params
    from ..serve.export import load_exported_params
    from ..utils import enable_compilation_cache
    from ._common import log_config, setup_logging

    full_f32()
    enable_compilation_cache()   # a no-op: the kernels' build dir caches
    device = resolve_device(args.device)
    log = setup_logging(None, "lfw_run")
    log_config(log, args)
    if not args.export_dir and not args.model:
        raise SystemExit("provide at least one --export-dir or --model")

    with tempfile.TemporaryDirectory(prefix="lfw_run_") as workdir:
        lfw_dir = _resolve_lfw_dir(args.lfw, os.path.join(workdir, "raw"))
        file_ext = args.file_ext
        if args.align:
            from ..detect.align import align_directory
            from ..detect.pipeline import MTCNNDetector

            detector = (MTCNNDetector.from_npy(*args.det_weights,
                                               device=device)
                        if args.det_weights else None)
            aligned = os.path.join(workdir, "aligned")
            res = align_directory(
                lfw_dir, aligned, detector, image_size=args.align_size,
                margin=args.align_margin,
                device_cascade=args.device_cascade, device=device)
            log.info("aligned %d/%d images (%d skipped)", res.aligned,
                     res.total, res.skipped)
            lfw_dir, file_ext = aligned, "png"

        pairs = read_pairs(args.pairs)
        paths, issame = get_paths(lfw_dir, pairs, file_ext=file_ext)
        if not paths:
            raise SystemExit("no resolvable pairs — check --lfw/--pairs/"
                             "--file-ext")
        log.info("%d pairs (%d positive)", len(issame), int(issame.sum()))

        rows = []
        for export_dir in args.export_dir:
            _, _, manifest = load_exported_params(export_dir)
            model = from_jax_params(export_dir, dtype=torch.bfloat16,
                                    device=device)
            hw = (manifest["input"]["height"], manifest["input"]["width"])
            ch = manifest["input"]["channels"]
            rows.append(_evaluate_one(
                f"{manifest['model']} ({os.path.basename(os.path.dirname(export_dir)) or export_dir})",
                model, paths, issame, args, log, hw, ch))
        for name in args.model:
            ch = 3 if name in RGB_MODELS else 1
            hw = (152, 152) if name in RGB_MODELS else (128, 128)
            model = model_by_name(
                name, args.num_classes, input_hw=hw, in_channels=ch,
                dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(0), device=device)
            rows.append(_evaluate_one(f"{name} (random init)", model,
                                      paths, issame, args, log, hw, ch))

    table = results_table(rows)
    print(table)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    if args.append_baseline:
        import datetime

        with open(args.append_baseline, "a") as f:
            f.write(f"\n### LFW 10-fold results "
                    f"({datetime.date.today().isoformat()}, lfw_run)\n\n")
            f.write(table + "\n")
    return rows


if __name__ == "__main__":
    main()
