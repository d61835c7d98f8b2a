"""Multi-camera throughput serving demo of the port (``--streams N``).

Port of the JAX package's ``cli/serve_demo.py --streams`` mode: N
same-shape camera frames go through the fused pipeline together (MTCNN
cascade -> best face -> crop -> embedding net -> L2 -> gallery argmax), and
the demo prints each stream's result and the frames/s. The embedding net is
``--model efmnet342`` (the default), ``lightcnn9`` or ``lightcnn29`` at
``--image-size``, with random (seeded) weights, unless ``--export-dir``
names a JAX or port export, which runs in bf16 as in the JAX demo. The other modes of the JAX demo (single camera,
``--video``, ``--detect``, ``--native``) are not ported yet.

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.serve_demo \\
        --streams 16 --frames 64 --frame-size 240 320 --image-size 64 \\
        --identities 1000 --det-thresholds 0.3 0.3 0.3
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

_ROADMAP = "ROADMAP.md queue A"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--streams", type=int, default=0,
                   help="identify the best face in N same-shape camera "
                        "streams per dispatch; prints frames/s")
    p.add_argument("--export-dir", help="exported model (weights.npz + "
                                        "manifest.json); random init if "
                                        "omitted")
    p.add_argument("--model", default="efmnet342",
                   choices=["lightcnn29", "efmnet342", "lightcnn9"])
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--identities", type=int, default=4)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--frame-size", type=int, nargs=2, default=(128, 128),
                   metavar=("H", "W"))
    p.add_argument("--det-thresholds", type=float, nargs=3,
                   default=(0.6, 0.7, 0.7),
                   help="cascade thresholds (random-weight demos need "
                        "permissive values)")
    p.add_argument("--sim-threshold", type=float, default=0.6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dynamic-gallery", action="store_true",
                   help="pass the normalized gallery at call time instead "
                        "of baking it into the pipeline")
    p.add_argument("--gallery-dtype", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="with --dynamic-gallery: storage dtype of the rows")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def _check_args(args, unknown) -> None:
    if unknown or not args.streams:
        raise SystemExit(
            "only the --streams mode of serve_demo is ported; the single-"
            "camera, --video, --detect and --native modes are queued in "
            f"{_ROADMAP} ('RecognitionService, the other serve_demo modes')"
            + (f" (unrecognized: {' '.join(unknown)})" if unknown else ""))
    if args.gallery_dtype == "int8":
        raise SystemExit("int8 galleries are not ported; queued in "
                         f"{_ROADMAP} ('DeviceGallery and int8 galleries')")
    if args.gallery_dtype != "f32" and not args.dynamic_gallery:
        raise SystemExit("--gallery-dtype applies to the dynamic-gallery "
                         "pipeline (use with --dynamic-gallery)")


def _embed_model(args, device):
    from ..models import model_by_name
    from ..serve.convert import from_jax_params

    if args.export_dir:
        return from_jax_params(args.export_dir, dtype=torch.bfloat16,
                               device=device)
    print("note: random-init model (pipeline demo; pass --export-dir for a "
          "trained one)")
    return model_by_name(
        args.model, args.num_classes,
        input_hw=(args.image_size, args.image_size), device=device,
        generator=torch.Generator().manual_seed(args.seed))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_streams(args):
    """Set up the multi-stream mode from parsed ``args``: returns ``(pipe,
    frames)``, the pipeline (``pipe(frames)`` is one dispatch) and the
    ``[streams, H, W, 3]`` frames on the device, all made from
    ``--seed``."""
    from ..detect.pipeline import MTCNNDetector
    from ..device import resolve_device
    from ..serve.pipeline import make_multistream_pipeline, normalize_gallery

    device = resolve_device(args.device)
    model = _embed_model(args, device)
    fh, fw = args.frame_size
    det = MTCNNDetector(seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed + 1)
    gallery = rng.normal(size=(max(args.identities, 1),
                               model.feature_dim)).astype(np.float32)
    kw = dict(frame_h=fh, frame_w=fw, embed_size=args.image_size,
              thresholds=tuple(args.det_thresholds),
              sim_threshold=args.sim_threshold, device=device)
    if args.dynamic_gallery:
        base = make_multistream_pipeline(det, model, dynamic_gallery=True,
                                         **kw)
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[
            args.gallery_dtype]
        gal_n = normalize_gallery(gallery, dtype, device=device)
        rows = gallery.shape[0]

        def pipe(f):
            return base(f, gal_n, rows)
    else:
        pipe = make_multistream_pipeline(det, model, gallery, **kw)
    frames = torch.as_tensor(
        rng.uniform(0, 255, (args.streams, fh, fw, 3)), dtype=torch.float32,
        device=device)
    return pipe, frames


def streams_main(args):
    """Run the multi-stream mode; returns a dict with the last dispatch's
    outputs (``out``, on the device), ``fps``, ``found``, ``streams``,
    ``dispatches`` and ``first_s`` (seconds of the first dispatch)."""
    pipe, frames = build_streams(args)
    device = frames.device
    fh, fw = args.frame_size
    t0 = time.perf_counter()
    out = pipe(frames)
    _sync(device)
    first_s = time.perf_counter() - t0
    print(f"first batch: {first_s:.2f}s")
    steps = max(args.frames // args.streams, 1)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = pipe(frames)
    _sync(device)
    dt = time.perf_counter() - t0
    found = out["found"].cpu().numpy()
    sims = out["similarity"].float().cpu().numpy()
    index = out["index"].cpu().numpy()
    for i in range(args.streams):
        state = (f"match idx={int(index[i])} sim {sims[i]:+.3f}"
                 if found[i] else "no face")
        print(f"stream {i:3d}: {state}")
    fps = args.streams * steps / dt
    print(f"{args.streams} streams x {steps} dispatches: {fps:,.1f} "
          f"frames/s ({fh}x{fw}px, {device.type})")
    return {"out": out, "fps": fps, "found": int(found.sum()),
            "streams": args.streams, "dispatches": steps, "first_s": first_s}


def parse_args(argv=None):
    """Parse and check the command line; the modes and options that are not
    ported exit naming their ROADMAP item."""
    args, unknown = build_parser().parse_known_args(argv)
    _check_args(args, unknown)
    return args


def main(argv=None):
    from ..device import full_f32

    full_f32()
    return streams_main(parse_args(argv))


if __name__ == "__main__":
    main()
