"""68-point landmark CLI: train an ERT shape predictor / refine detections.

User-facing surface for reference capability C16 (``MTCNN_Dlib_Detection``,
MTCNN.hpp:1326-1421): dlib ships no source for its shape_predictor and no
.dat model exists in this environment, so the predictor is trainable here
(Kazemi-Sullivan, detect/ert.py) and applied seeded by MTCNN's 5 points.

The port's ``landmarks68``, with the JAX package's four subcommands
(``train``, ``import-dat``, ``export-dat``, ``detect``) and their flags,
plus ``--device`` on ``detect``, whose MTCNN nets run on ``cuda`` unless
``--device cpu`` is given (the ERT cascade is numpy on the host, as in
the JAX package and in dlib).

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.landmarks68 \
        train --annotations lmk.npz --out sp.npz
    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.landmarks68 \
        detect --predictor sp.npz face.jpg --out lmk.jsonl
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train an ERT shape predictor")
    t.add_argument("--annotations", required=True,
                   help=".npz with images [N,H,W(,C)], rects [N,4], "
                        "shapes [N,L,2] (image coords)")
    t.add_argument("--out", required=True, help="output predictor .npz")
    t.add_argument("--cascades", type=int, default=10)
    t.add_argument("--trees", type=int, default=500,
                   help="trees per cascade (dlib default 500)")
    t.add_argument("--depth", type=int, default=4)
    t.add_argument("--feature-pool", type=int, default=400)
    t.add_argument("--nu", type=float, default=0.1)
    t.add_argument("--oversampling", type=int, default=20)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--export-native", metavar="NPZ",
                   help="also write the uncompressed f32 .npz the native "
                        "regressor reads (cpp/include/facejax/ert.hpp)")

    i = sub.add_parser(
        "import-dat",
        help="convert a dlib shape_predictor .dat (e.g. shape_predictor_"
             "68_face_landmarks.dat) to this framework's ERT formats")
    i.add_argument("dat", help="dlib .dat file")
    i.add_argument("--out", required=True, help="output predictor .npz")
    i.add_argument("--export-native", metavar="NPZ",
                   help="also write the native-regressor .npz "
                        "(cpp/include/facejax/ert.hpp)")

    e = sub.add_parser(
        "export-dat",
        help="serialize a predictor .npz in dlib's .dat format (for "
             "dlib-consuming apps; also the round-trip test vector)")
    e.add_argument("predictor", help="predictor .npz (train's --out)")
    e.add_argument("--out", required=True, help="output .dat")

    d = sub.add_parser("detect",
                       help="MTCNN detect + ERT 68-pt refinement on images")
    d.add_argument("--predictor", required=True)
    d.add_argument("images", nargs="+", help="image files")
    d.add_argument("--out", help="write results JSONL here")
    d.add_argument("--minsize", type=int, default=20)
    d.add_argument("--thresholds", type=float, nargs=3,
                   default=[0.6, 0.7, 0.7])
    d.add_argument("--device", default=None,
                   help="torch device of the MTCNN nets (default cuda; "
                        "'cpu' runs the plain PyTorch path)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from ..detect.ert import (ShapePredictor, mtcnn_ert_detect,
                              train_shape_predictor)
    from ..device import full_f32

    full_f32()

    if args.command == "train":
        with np.load(args.annotations) as z:
            images = z["images"]
            rects = z["rects"]
            shapes = z["shapes"]
        pred = train_shape_predictor(
            list(images), rects, shapes, cascades=args.cascades,
            trees_per_cascade=args.trees, tree_depth=args.depth,
            feature_pool=args.feature_pool, nu=args.nu,
            oversampling=args.oversampling, seed=args.seed)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        pred.save(args.out)
        if args.export_native:
            from ..serve.export import export_ert

            export_ert(args.export_native, pred)
            print(f"native export: {args.export_native}")
        # report training-set residual (normalized by rect width)
        errs = []
        for i in range(min(len(images), 64)):
            init = None
            out = pred.predict(images[i], rects[i], init)
            w = rects[i][2] - rects[i][0]
            errs.append(float(np.linalg.norm(out - shapes[i],
                                             axis=1).mean() / w))
        print(f"trained {args.cascades}x{args.trees} trees, "
              f"{pred.num_points} points -> {args.out}; "
              f"train residual {np.mean(errs):.4f} (of rect width)")
        return pred

    if args.command == "import-dat":
        from ..detect.dlib_import import read_shape_predictor_dat

        pred = read_shape_predictor_dat(args.dat)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        pred.save(args.out)
        msg = (f"imported {len(pred.levels)} cascades x "
               f"{pred.levels[0].split_idx1.shape[0]} trees, "
               f"{pred.num_points} points -> {args.out}")
        if args.export_native:
            from ..serve.export import export_ert

            export_ert(args.export_native, pred)
            msg += f"; native export: {args.export_native}"
        print(msg)
        return pred

    if args.command == "export-dat":
        from ..detect.dlib_import import write_shape_predictor_dat

        pred = ShapePredictor.load(args.predictor)
        write_shape_predictor_dat(args.out, pred)
        print(f"wrote dlib-format {args.out} ({pred.num_points} points, "
              f"{len(pred.levels)} cascades)")
        return pred

    # detect
    import cv2

    pred = ShapePredictor.load(args.predictor)
    results = []
    from ..detect.pipeline import MTCNNDetector

    detector = MTCNNDetector(device=args.device)
    for path in args.images:
        img = cv2.imread(path)
        if img is None:
            print(f"{path}: unreadable")
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        boxes, lmk = mtcnn_ert_detect(
            img, pred, detector, minsize=args.minsize,
            thresholds=tuple(args.thresholds))
        results.append({"path": path,
                        "boxes": np.round(boxes, 2).tolist(),
                        "landmarks": np.round(lmk, 2).tolist()})
        print(f"{path}: {boxes.shape[0]} face(s), "
              f"{lmk.shape[1] if lmk.size else 0} pts each")
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


if __name__ == "__main__":
    main()
