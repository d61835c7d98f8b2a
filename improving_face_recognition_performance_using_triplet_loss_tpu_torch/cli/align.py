"""Dataset alignment CLI (reference align_dataset_mtcnn.py:124-139 + align.sh).

The port's ``align``, with the JAX package's flags plus ``--device``:
walks input_dir/<class>/*.jpg, detects with MTCNN, writes aligned PNG
crops and a bounding_boxes log to output_dir (``detect/align.py``). The
host cascade runs the nets on the card and the box lists on the host;
``--device-cascade`` runs the whole cascade on the card (kernel B5 four
times an image). Needs cv2 to read and write the images. Runs on ``cuda``
unless ``--device cpu`` is given.

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.align \\
        lfw/ lfw_aligned/ --device-cascade
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--image-size", type=int, default=182)
    p.add_argument("--margin", type=int, default=44)
    p.add_argument("--minsize", type=int, default=20)
    p.add_argument("--thresholds", type=float, nargs=3,
                   default=[0.6, 0.7, 0.7])
    p.add_argument("--factor", type=float, default=0.709)
    p.add_argument("--detect-multiple-faces", action="store_true")
    p.add_argument("--det-weights", nargs=3, metavar=("DET1", "DET2", "DET3"),
                   help="det1/det2/det3 .npy weight files (random init "
                        "otherwise — for pipeline testing only)")
    p.add_argument("--export-native-mtcnn", metavar="NPZ",
                   help="also write the detector weights as the flat .npz "
                        "the native cascade reads "
                        "(cpp/include/facejax/mtcnn.hpp)")
    p.add_argument("--device-cascade", action="store_true",
                   help="the batched on-device cascade (one call per image; "
                        "kernel B5 for its NMS) instead of the host cascade")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..detect.align import align_directory
    from ..detect.pipeline import MTCNNDetector
    from ..device import full_f32

    full_f32()
    detector = (MTCNNDetector.from_npy(*args.det_weights, device=args.device)
                if args.det_weights else MTCNNDetector(device=args.device))
    if args.export_native_mtcnn:
        from ..serve.export import export_mtcnn

        path = export_mtcnn(args.export_native_mtcnn, detector.pnet.params(),
                            detector.rnet.params(), detector.onet.params())
        print(f"native MTCNN export: {path}")
    res = align_directory(
        args.input_dir, args.output_dir, detector,
        image_size=args.image_size, margin=args.margin,
        minsize=args.minsize, thresholds=tuple(args.thresholds),
        factor=args.factor, detect_multiple=args.detect_multiple_faces,
        device_cascade=args.device_cascade)
    print(f"Total number of images: {res.total}")
    print(f"Number of successfully aligned images: {res.aligned}")
    return res


if __name__ == "__main__":
    main()
