"""Export the fused recognition pipeline as a deployable artifact.

The port's ``export_aot``, with the JAX package's flags plus ``--device``:
``torch.export`` of the WHOLE detect -> crop -> embed -> gallery-match
program (serve/pipeline.py), saved as a ``.pt2``; a serving process calls
``serve.aot.load_pipeline(artifact)``, with no model code and no weight
files (the weights are constants of the program; the gallery is baked too
by default, or a runtime argument with --dynamic-gallery-rows so the
identity DB can grow without re-exporting). ``--compiled-out`` also
writes an AOTInductor package (``serve.aot.load_compiled``),
``--cache-bundle`` ships the kernel libraries the artifact loads as
``<out>.xcache/`` (and beside the package, ``<compiled-out>.xcache/``). An artifact is tied to one device kind: ``--platforms``
takes ``cuda`` (alias ``gpu``) or ``cpu``, and exports on ``cuda`` unless
``--device cpu`` is given.

  python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.export_aot \\
      --export-dir runs/bb/export --dynamic-gallery-rows 100000 \\
      --frame-size 480 640 --out deploy/pipe.pt2
"""

from __future__ import annotations

import argparse
import os

_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def build_parser():
    from ._common import GALLERY_DTYPE_NAMES

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--export-dir", required=True,
                   help="trained model export (serve/export.py layout)")
    p.add_argument("--gallery",
                   help=".npz feature store: the enrolled gallery to bake "
                        "(required unless --dynamic-gallery-rows)")
    p.add_argument("--dynamic-gallery-rows", type=int, default=0,
                   metavar="G",
                   help="export with the gallery as a RUNTIME argument of "
                        "shape [G, feature_dim]: call the loaded artifact "
                        "as fn(frame, gallery_n, rows) with "
                        "serve.pipeline.normalize_gallery's output and the "
                        "enrolled-row count (rows beyond it never match)")
    p.add_argument("--gallery-dtype", choices=GALLERY_DTYPE_NAMES,
                   default="f32",
                   help="with --dynamic-gallery-rows: storage dtype of the "
                        "gallery operand")
    p.add_argument("--frame-size", type=int, nargs=2, required=True,
                   metavar=("H", "W"))
    p.add_argument("--out", required=True, help="artifact path (.pt2)")
    p.add_argument("--embed-size", type=int, default=0,
                   help="face-crop size fed to the embedder (default: the "
                        "export manifest's input height)")
    p.add_argument("--streams", type=int, default=0,
                   help="export the MULTISTREAM pipeline at a fixed stream "
                        "count: the frame argument becomes [N, H, W, 3]")
    p.add_argument("--max-faces", type=int, default=1,
                   help=">1 exports the multi-face pipeline")
    p.add_argument("--minsize", type=int, default=20)
    p.add_argument("--thresholds", type=float, nargs=3,
                   default=(0.6, 0.7, 0.7))
    p.add_argument("--sim-threshold", type=float, default=0.5)
    p.add_argument("--det-weights", nargs=3,
                   metavar=("DET1", "DET2", "DET3"),
                   help="MTCNN det*.npy files (converted-Caffe layout)")
    p.add_argument("--mtcnn-npz",
                   help="detector weights in this repo's export_mtcnn "
                        "layout (align --export-native-mtcnn writes it)")
    p.add_argument("--precision", choices=("manifest", "bf16", "f32"),
                   default="manifest",
                   help="embedder compute precision baked into the "
                        "artifact; 'manifest' reads the export manifest's "
                        "'precision' field (bf16 where it has none)")
    p.add_argument("--int8-embed", action="store_true",
                   help="bake the int8 conv route of the embed stage "
                        "(ops/quantized.py, one activation scale a frame)")
    p.add_argument("--compiled-out",
                   help="ALSO write an AOTInductor package "
                        "(serve/aot.py::export_compiled) at this path: "
                        "compiled now, for this device kind and torch "
                        "version")
    p.add_argument("--cache-bundle", action="store_true",
                   help="after export, run the artifact once in a fresh "
                        "subprocess and ship the kernel libraries it "
                        "loaded as <out>.xcache/ (and as "
                        "<compiled-out>.xcache/ with --compiled-out): a "
                        "serving machine installs them and skips the "
                        "kernel build")
    p.add_argument("--platforms", nargs="+",
                   help="the device kind of the artifact: cuda (gpu) or "
                        "cpu (default: --device)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def _detector_from_mtcnn_npz(path, device=None):
    """An MTCNNDetector from an export_mtcnn .npz (keys
    {pnet|rnet|onet}/{layer}/{param})."""
    import numpy as np

    from ..detect.pipeline import MTCNNDetector

    nets = {"pnet": {}, "rnet": {}, "onet": {}}
    with np.load(path) as z:
        for key in z.files:
            net, layer, param = key.split("/", 2)
            nets[net].setdefault(layer, {})[param] = z[key]
    return MTCNNDetector(nets["pnet"], nets["rnet"], nets["onet"],
                         device=device)


def _platform_device(args) -> str | None:
    if not args.platforms:
        return args.device
    if len(args.platforms) > 1 or args.platforms[0] not in _PLATFORMS:
        raise SystemExit(
            f"--platforms {' '.join(args.platforms)}: an exported program "
            "is tied to one device kind; give one of cuda (gpu) or cpu")
    dev = _PLATFORMS[args.platforms[0]]
    if args.device is not None and args.device.split(":")[0] != dev:
        raise SystemExit(f"--platforms {args.platforms[0]} and --device "
                         f"{args.device} name different devices")
    return args.device or dev


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.gallery and not args.dynamic_gallery_rows:
        raise SystemExit(
            "one of --gallery (baked) or --dynamic-gallery-rows (runtime "
            "argument) is required")
    if args.gallery and args.dynamic_gallery_rows:
        raise SystemExit(
            "--gallery and --dynamic-gallery-rows are mutually exclusive: "
            "a dynamic artifact takes the gallery at CALL time, so the "
            ".npz would be silently ignored")
    if args.dynamic_gallery_rows < 0:
        raise SystemExit("--dynamic-gallery-rows must be a positive row "
                         "count")
    if args.gallery_dtype != "f32" and not args.dynamic_gallery_rows:
        raise SystemExit("--gallery-dtype applies to the dynamic gallery "
                         "operand (use with --dynamic-gallery-rows); a "
                         "baked gallery is an f32 program constant")
    device = _platform_device(args)

    import numpy as np
    import torch

    from ..data import load_feature_store
    from ..detect.pipeline import MTCNNDetector
    from ..device import full_f32, resolve_device
    from ..serve.aot import export_compiled, export_pipeline
    from ..serve.convert import from_jax_params
    from ..serve.export import load_exported_params
    from ..serve.pipeline import (make_multiface_pipeline,
                                  make_multistream_pipeline,
                                  make_recognition_pipeline)
    from ._common import gallery_dtype

    full_f32()
    dev = resolve_device(device)
    _, _, manifest = load_exported_params(args.export_dir)
    if args.precision == "manifest":
        bf16 = manifest.get("precision", "bf16") == "bf16"
    else:
        bf16 = args.precision == "bf16"
    model = from_jax_params(args.export_dir,
                            dtype=torch.bfloat16 if bf16 else torch.float32,
                            device=dev)
    dynamic = bool(args.dynamic_gallery_rows)
    if dynamic:
        gallery = None
        gallery_shape = (args.dynamic_gallery_rows,
                         int(manifest["feature_dim"]))
    else:
        gallery, _ = load_feature_store(args.gallery)
        gallery_shape = None
    if args.det_weights:
        detector = MTCNNDetector.from_npy(*args.det_weights, device=dev)
    elif args.mtcnn_npz:
        detector = _detector_from_mtcnn_npz(args.mtcnn_npz, device=dev)
    else:
        detector = MTCNNDetector(device=dev)
        print("WARNING: no --det-weights/--mtcnn-npz — a RANDOM-INIT "
              "detector is being baked into the artifact (demo only; "
              "re-export with real weights before deploying)")
    embed_size = args.embed_size or int(manifest["input"]["height"])

    fh, fw = args.frame_size
    kw = dict(frame_h=fh, frame_w=fw, embed_size=embed_size,
              minsize=args.minsize, thresholds=tuple(args.thresholds),
              sim_threshold=args.sim_threshold,
              int8_embed=args.int8_embed, dynamic_gallery=dynamic,
              device=dev)
    gal_arg = None if dynamic else np.asarray(gallery, np.float32)
    if args.max_faces > 1:
        kw["max_faces"] = args.max_faces
    if args.streams > 0:
        pipe = make_multistream_pipeline(detector, model, gal_arg, **kw)
    else:
        maker = (make_recognition_pipeline if args.max_faces <= 1
                 else make_multiface_pipeline)
        pipe = maker(detector, model, gal_arg, **kw)
    gdtype = gallery_dtype(args.gallery_dtype)
    path = export_pipeline(args.out, pipe, fh, fw, streams=args.streams,
                           gallery_shape=gallery_shape,
                           gallery_dtype=gdtype, device=dev)
    if args.compiled_out:
        cpath = export_compiled(args.compiled_out, pipe, fh, fw,
                                streams=args.streams,
                                gallery_shape=gallery_shape,
                                gallery_dtype=gdtype, device=dev,
                                program=torch.export.load(path))
        print(f"compiled package: {cpath} "
              f"({os.path.getsize(cpath) / 1e6:.1f} MB, {dev.type} and "
              f"torch {torch.__version__} only)")
    if args.cache_bundle:
        import shutil

        from ..serve.aot import CACHE_BUNDLE_SUFFIX, prime_cache_bundle

        bundles = [prime_cache_bundle(path)]
        if args.compiled_out:   # the same program, so the same libraries
            bundles.append(shutil.copytree(
                bundles[0], args.compiled_out + CACHE_BUNDLE_SUFFIX,
                dirs_exist_ok=True))
        for bundle in bundles:
            print(f"cache bundle: {bundle} ({len(os.listdir(bundle))} "
                  f"kernel libraries)")
    gal_desc = (f"dynamic gallery [{gallery_shape[0]}, {gallery_shape[1]}] "
                f"runtime arg" if dynamic
                else f"{gallery.shape[0]}-row gallery baked")
    faces = (f"multi-face K={args.max_faces}" if args.max_faces > 1
             else "single-face")
    streams = f"{args.streams}-stream" if args.streams else "1-stream"
    print(f"AOT artifact: {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"{gal_desc}, {streams}, {faces}, platforms=['{dev.type}'])")
    return path


if __name__ == "__main__":
    main()
