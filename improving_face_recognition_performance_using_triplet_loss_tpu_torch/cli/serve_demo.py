"""Live-recognition serving demo of the port (reference C++ runtime flow,
SURVEY.md §3.4).

Port of the JAX package's ``cli/serve_demo.py``, every mode:

- default: ``RecognitionService`` with the embedding net on the card
  enrolls synthetic identities through the registration state machine,
  a producer thread pushes frames through the drop-stale queue, and the
  freshest frames are identified against the native identity store;
- ``--video``: a cv2 source (file or camera index) replaces the synthetic
  stream; the first ``--register-frames`` frames enroll ``--register-name``;
- ``--video --detect``: full scenes through the fused pipeline (MTCNN
  cascade -> crop -> embed -> gallery match on the card, one dispatch a
  frame), the top ``--max-faces`` faces of each frame; with
  ``--dynamic-gallery`` the gallery is a ``DeviceGallery`` passed at call
  time, and ``--person-db`` serves every person of a ``PersonStore``
  through ``PersonGalleryService`` (``--register-frames 0``: identify
  only); ``--gallery-dtype f32|bf16|int8`` sets the rows' storage;
- ``--native`` / ``--video --detect --native --native-mtcnn``: the native
  C++ forward and cascade (``serve/native.py``), no torch in the loop;
- ``--streams N``: N same-shape camera frames a dispatch, with the
  best face of each identified; prints frames/s.

The embedding net is ``--model efmnet342`` (the default), ``lightcnn9`` or
``lightcnn29`` at ``--image-size`` with random (seeded) weights, unless
``--export-dir`` names a JAX or port export, which runs in bf16 as in the
JAX demo. Everything runs on ``--device`` (``cuda`` unless given).

    python -m improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.serve_demo \\
        --video scene.avi --detect --frame-size 240 320 --max-faces 4 \\
        --dynamic-gallery --person-db people.sqlite --register-frames 0 \\
        --gallery-dtype int8 --det-thresholds 0.3 0.3 0.3
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
import time

import numpy as np
import torch

from . import _common


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--export-dir", help="exported model (weights.npz + "
                                        "manifest.json); random init if "
                                        "omitted")
    p.add_argument("--model", default="efmnet342",
                   choices=["lightcnn29", "efmnet342", "lightcnn9"])
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--store", default=os.path.join(tempfile.gettempdir(),
                                                   "facejax_demo.fjdb"),
                   help="native identity store file (replaced each run)")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--identities", type=int, default=4)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--sim-threshold", type=float, default=0.6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--video", help="video source: a file path or camera "
                                   "index — replaces the synthetic frame "
                                   "stream")
    p.add_argument("--register-name", default="live_person",
                   help="with --video: enroll this name from the first "
                        "--register-frames frames")
    p.add_argument("--register-frames", type=int, default=4,
                   help="0 (with --person-db) skips stream enrollment and "
                        "identifies against the DB only")
    p.add_argument("--person-db",
                   help="with --video --detect --dynamic-gallery: a "
                        "PersonStore sqlite DB (identify enroll-person) "
                        "served through PersonGalleryService; "
                        "--register-name enrollments are written through")
    p.add_argument("--gallery-dtype", choices=_common.GALLERY_DTYPE_NAMES,
                   default="f32",
                   help="with --dynamic-gallery: storage dtype of the "
                        "gallery rows on the device")
    p.add_argument("--fps-cap", type=float, default=30.0,
                   help="with --video file sources: max producer fps "
                        "(0: as fast as frames decode)")
    p.add_argument("--detect", action="store_true",
                   help="with --video: frames are full scenes — run the "
                        "fused detect->crop->embed->match pipeline")
    p.add_argument("--frame-size", type=int, nargs=2, default=(128, 128),
                   metavar=("H", "W"), help="with --detect / --streams: "
                                            "scene size")
    p.add_argument("--det-thresholds", type=float, nargs=3,
                   default=(0.6, 0.7, 0.7),
                   help="cascade thresholds (random-weight demos need "
                        "permissive values)")
    p.add_argument("--max-faces", type=int, default=1,
                   help="with --detect: identify the top-K faces per frame "
                        "(K>1 uses make_multiface_pipeline)")
    p.add_argument("--native-mtcnn", metavar="NPZ",
                   help="with --video --detect --native: detect with the "
                        "native C++ cascade (export_mtcnn npz)")
    p.add_argument("--native", action="store_true",
                   help="embed with the native C++ forward (requires "
                        "--export-dir)")
    p.add_argument("--streams", type=int, default=0,
                   help="throughput mode: identify the best face in N "
                        "same-shape camera streams per dispatch; prints "
                        "frames/s")
    p.add_argument("--int8", action="store_true",
                   help="with --native: int8 quantized convs")
    p.add_argument("--dynamic-gallery", action="store_true",
                   help="with --video --detect (or --streams): the gallery "
                        "is a DeviceGallery passed at call time")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def _check_args(args) -> None:
    """The JAX demo's flag checks."""
    if args.dynamic_gallery and not (args.streams or (
            args.video and args.detect and not args.native)):
        raise SystemExit("--dynamic-gallery applies to the fused "
                         "pipelines only (use with --video --detect, or "
                         "with --streams; not --native)")
    if args.person_db and not (args.dynamic_gallery and args.video
                               and args.detect and not args.streams):
        raise SystemExit("--person-db needs the dynamic-gallery streaming "
                         "pipeline (--video --detect --dynamic-gallery, "
                         "without --streams)")
    if args.gallery_dtype != "f32" and not args.dynamic_gallery:
        raise SystemExit("--gallery-dtype applies to the dynamic-gallery "
                         "pipelines (use with --dynamic-gallery)")
    if args.register_frames == 0 and not args.dynamic_gallery:
        raise SystemExit("--register-frames 0 (identify-only) needs "
                         "--dynamic-gallery (the baked-gallery pipeline "
                         "is built FROM the registration features)")


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


def _detector(args, device):
    from ..detect.pipeline import MTCNNDetector

    return MTCNNDetector(seed=args.seed, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _source(args):
    return int(args.video) if args.video.isdigit() else args.video


def _reset_store(args) -> None:
    if os.path.exists(args.store):
        os.remove(args.store)


def _make_embed_fn(args, model, device):
    """The port's extractor on ``device`` by default; the native C++
    forward under --native. Takes and returns numpy."""
    if args.native:
        if not args.export_dir:
            raise SystemExit("--native needs --export-dir (the native "
                             "forward reads weights.npz)")
        from ..serve.native import NativeEmbedder

        emb = NativeEmbedder(args.export_dir, quantized=args.int8)

        def embed_fn(frames):
            frames = np.asarray(frames, np.float32)
            return np.stack([emb.extract(f[..., 0]) for f in frames])

        return embed_fn

    from ..extract import make_extract_fn

    extract = make_extract_fn(model, normalize=True)

    def embed_fn(frames):
        x = torch.as_tensor(np.asarray(frames, np.float32), device=device)
        _, feat = extract(x)
        return feat.float().cpu().numpy()

    return embed_fn


def run_frame(pipeline, frame255: np.ndarray, gallery=None,
              device=None) -> dict:
    """One frame through a fused pipeline, every output read back to the
    host one by one as the JAX demo reads them (one synchronization a
    frame, then a copy per output). ``gallery`` is a ``DeviceGallery`` or
    ``PersonGalleryService`` for a dynamic-gallery pipeline."""
    frame = torch.as_tensor(frame255, dtype=torch.float32, device=device)
    raw = (pipeline(frame, gallery.gallery_n, gallery.rows_arg)
           if gallery is not None else pipeline(frame))
    return {k: v.cpu().numpy() for k, v in raw.items()}


def _video_native_detect_main(args):
    """--video --detect --native --native-mtcnn: camera thread ->
    drop-stale queue -> C++ MTCNN -> crop -> C++ embed -> C++ store
    match/register, no torch compute in the loop."""
    from ..detect.align import crop_face, select_main_face
    from ..serve.native import NativeEmbedder, NativeMtcnn
    from ..serve.recognition import RecognitionService
    from ..serve.video import VideoProducer

    if not (args.export_dir and args.native_mtcnn):
        raise SystemExit("--video --detect --native needs --export-dir "
                         "and --native-mtcnn")
    fh, fw = args.frame_size
    shape = (fh, fw, 3)
    _reset_store(args)
    th = tuple(args.det_thresholds)
    with NativeMtcnn(args.native_mtcnn, quantized=args.int8) as det, \
            NativeEmbedder(args.export_dir, quantized=args.int8) as emb, \
            RecognitionService(
                lambda f: np.zeros((len(f), emb.feature_dim), np.float32),
                args.store, emb.feature_dim,
                sim_threshold=args.sim_threshold, frame_shape=shape) as svc:
        size = int(((emb.manifest or {}).get("input") or {})
                   .get("height", args.image_size))
        n_reg = 0
        results = []

        def face_fv(frame255):
            boxes, _ = det.detect(frame255, thresholds=th)
            if boxes.shape[0] == 0:
                return None
            sel = select_main_face(boxes, frame255.shape)
            crop = crop_face(frame255.astype(np.float32), sel[0],
                             image_size=size, margin=0)
            gray = (0.299 * crop[..., 0] + 0.587 * crop[..., 1]
                    + 0.114 * crop[..., 2]).astype(np.float32) / 255.0
            return emb.extract(gray)

        with VideoProducer(_source(args), svc,
                           fps_cap=args.fps_cap) as producer:
            while True:
                got = svc.queue.consume(int(np.prod(shape)),
                                        remove_old=n_reg
                                        >= args.register_frames)
                if got is None:
                    if producer.finished.is_set():
                        break
                    time.sleep(0.001)
                    continue
                flat, seq = got
                frame255 = flat.reshape(shape) * 255.0
                fv = face_fv(frame255)
                if fv is None:
                    continue
                if n_reg < args.register_frames:
                    svc.store.register(args.register_name, fv)
                    n_reg += 1
                    if n_reg == args.register_frames:
                        print(f"registered '{args.register_name}' from "
                              f"{n_reg} natively detected faces")
                    continue
                name, sim = svc.store.match(fv, args.sim_threshold)
                results.append((seq, name, sim))
                print(f"frame {seq:4d}: {name or '<unknown>'} "
                      f"(sim {sim:+.3f}) [native]")
        matched = sum(1 for _, n, _ in results if n == args.register_name)
        print(f"identified {matched}/{len(results)} streamed frames as "
              f"'{args.register_name}' (fully native loop)")
        return results


def _video_detect_main(args, model, device):
    """--video --detect: full-scene frames through the fused pipeline on
    the card (detect -> crop -> embed -> gallery match, one dispatch a
    frame). Registration crops come from the host cascade; identification
    runs fused."""
    import contextlib

    from ..detect.align import crop_face, select_main_face
    from ..extract import make_extract_fn
    from ..serve.pipeline import (make_multiface_pipeline,
                                  make_recognition_pipeline)
    from ..serve.recognition import RecognitionService
    from ..serve.video import VideoProducer

    fh, fw = args.frame_size
    shape = (fh, fw, 3)
    detector = _detector(args, device)
    extract = make_extract_fn(model, normalize=True)

    def embed_crop(gray01):
        x = torch.as_tensor(np.asarray(gray01, np.float32)[None],
                            device=device)
        return extract(x)[1].float().cpu().numpy()[0]

    _reset_store(args)
    with RecognitionService(lambda f: np.zeros((len(f), model.feature_dim),
                                               np.float32),
                            args.store, model.feature_dim,
                            sim_threshold=args.sim_threshold,
                            frame_shape=shape) as svc, \
            contextlib.ExitStack() as stack:
        reg_feats: list[np.ndarray] = []
        results = []
        pipeline = dg = None
        maker = (make_recognition_pipeline if args.max_faces <= 1
                 else make_multiface_pipeline)
        kw = dict(frame_h=fh, frame_w=fw, embed_size=args.image_size,
                  thresholds=tuple(args.det_thresholds),
                  sim_threshold=args.sim_threshold, device=device)
        if args.max_faces > 1:
            kw["max_faces"] = args.max_faces
        gsvc = reg_pid = None
        if args.dynamic_gallery:
            # the gallery is a call argument: the pipeline is built and
            # warmed once at startup, enrollments write single rows
            from ..serve.device_gallery import DeviceGallery

            pipeline = maker(detector, model, dynamic_gallery=True, **kw)
            dtype = _common.gallery_dtype(args.gallery_dtype)
            if args.person_db:
                # identify against every person in the durable DB; sized
                # so stream enrollments never grow the gallery
                from ..serve.gallery_service import PersonGalleryService
                from ..serve.person_store import PersonStore

                pstore = stack.enter_context(
                    PersonStore(args.person_db, model.feature_dim,
                                device=device))
                n_valid = pstore.valid_faces()[1].shape[0]
                gsvc = PersonGalleryService(
                    pstore, capacity=max(n_valid + args.register_frames, 1),
                    dtype=dtype, device=device)
                dg = gsvc  # same (gallery_n, rows_arg) contract
                print(f"person-db: {n_valid} faces across "
                      f"{len(pstore.persons())} persons on the device")
            else:
                dg = DeviceGallery(model.feature_dim,
                                   capacity=max(args.register_frames, 1),
                                   dtype=dtype, device=device)
            run_frame(pipeline, np.zeros(shape, np.float32), dg, device)
        with VideoProducer(_source(args), svc,
                           fps_cap=args.fps_cap) as producer:
            while True:
                registering = len(reg_feats) < args.register_frames
                got = svc.queue.consume(int(np.prod(shape)),
                                        remove_old=not registering)
                if got is None:
                    if producer.finished.is_set():
                        break
                    time.sleep(0.001)
                    continue
                flat, seq = got
                frame255 = flat.reshape(shape) * 255.0
                if len(reg_feats) < args.register_frames:
                    # host-cascade registration crop (RegImageAcq phase)
                    boxes, _ = detector.detect(
                        frame255, thresholds=tuple(args.det_thresholds))
                    if boxes.shape[0] > 0:
                        det = select_main_face(boxes, frame255.shape)
                        crop = crop_face(frame255.astype(np.float32),
                                         det[0], image_size=args.image_size,
                                         margin=16)
                        gray = crop.mean(-1, keepdims=True) / 255.0
                        fv = embed_crop(gray)
                        reg_feats.append(fv)
                        svc.store.register(args.register_name, fv)
                        if gsvc is not None:
                            # write-through: durable DB row + device row
                            from ..serve.person_store import Person

                            if reg_pid is None:
                                reg_pid = gsvc.enroll(
                                    Person(name=args.register_name), [fv])
                            else:
                                gsvc.add_face(reg_pid, fv)
                        elif args.dynamic_gallery:
                            dg.add(fv)   # one row written on the device
                        if len(reg_feats) == args.register_frames:
                            print(f"registered '{args.register_name}' from "
                                  f"{len(reg_feats)} detected faces")
                            if not args.dynamic_gallery:
                                pipeline = maker(detector, model,
                                                 np.stack(reg_feats), **kw)
                                run_frame(pipeline,
                                          np.zeros(shape, np.float32),
                                          device=device)
                    if not args.dynamic_gallery:
                        continue
                    # dynamic gallery: fall through — identification runs
                    # from frame 1 against the rows enrolled so far (an
                    # empty gallery is fully masked -> <unknown>)
                out = run_frame(pipeline, frame255, dg, device)

                def _name(ix):
                    # the pipeline already applied sim_threshold (ix = -1
                    # below it); with a person DB resolve the row to the
                    # owning person, else it is the single enrolled name
                    if int(ix) < 0:
                        return None
                    if gsvc is not None:
                        res = gsvc.resolve(int(ix), 1.0, sim_th=-2.0)
                        return res.person.name if res.person else None
                    return args.register_name

                if args.max_faces <= 1:
                    name = _name(out["index"])
                    results.append((seq, name, float(out["similarity"])))
                    print(f"frame {seq:4d}: {name or '<unknown>'} "
                          f"(sim {float(out['similarity']):+.3f}, "
                          f"found={bool(out['found'])}, "
                          f"cap_dropped={int(out['cap_dropped'])})")
                else:
                    # per-face results (the reference identifies every
                    # detected face per frame)
                    faces = [(_name(ix), float(sm))
                             for fnd, ix, sm in zip(out["found"],
                                                    out["indices"],
                                                    out["similarities"])
                             if bool(fnd)]
                    best = max(faces, key=lambda x: x[1],
                               default=(None, -2.0))
                    results.append((seq, best[0], best[1]))
                    print(f"frame {seq:4d}: {len(faces)} face(s) "
                          + ", ".join(f"{n or '<unknown>'}({s:+.2f})"
                                      for n, s in faces))
        if gsvc is not None:
            matched = sum(1 for _, n, _ in results if n is not None)
            print(f"identified {matched}/{len(results)} streamed frames "
                  f"against the person DB (fused pipeline)")
        else:
            matched = sum(1 for _, n, _ in results
                          if n == args.register_name)
            print(f"identified {matched}/{len(results)} streamed frames "
                  f"as '{args.register_name}' (fused pipeline)")
        return results


def _video_main(args, model, device):
    """--video: acquire registration frames first (RegImageAcq), enroll
    via the state machine, then identify the rest of the stream."""
    from ..serve.recognition import RecognitionService
    from ..serve.video import VideoProducer

    embed_fn = _make_embed_fn(args, model, device)
    _reset_store(args)
    shape = (args.image_size, args.image_size, 1)
    # warm up BEFORE the stream starts (both batch shapes: per-frame
    # identify and the registration batch), or the drop-stale queue would
    # discard the start of the fixture
    embed_fn(np.zeros((1,) + shape, np.float32))
    embed_fn(np.zeros((args.register_frames,) + shape, np.float32))
    with RecognitionService(embed_fn, args.store, model.feature_dim,
                            sim_threshold=args.sim_threshold,
                            frame_shape=shape) as svc:
        reg_frames: list[np.ndarray] = []
        results = []
        with VideoProducer(_source(args), svc,
                           fps_cap=args.fps_cap) as producer:
            while True:
                got = svc.queue.consume(int(np.prod(shape)),
                                        remove_old=True)
                if got is None:
                    if producer.finished.is_set():
                        break
                    time.sleep(0.001)
                    continue
                flat, seq = got
                frame = flat.reshape(shape)
                if len(reg_frames) < args.register_frames:
                    reg_frames.append(frame)
                    if len(reg_frames) == args.register_frames:
                        stored = svc.register(args.register_name,
                                              np.stack(reg_frames))
                        print(f"registered '{args.register_name}' from "
                              f"{args.register_frames} frames "
                              f"({stored} features)")
                    continue
                emb = np.asarray(embed_fn(frame[None]))[0]
                name, sim = svc.store.match(emb, args.sim_threshold)
                results.append((seq, name, sim))
                print(f"frame {seq:4d}: {name or '<unknown>'} "
                      f"(sim {sim:+.3f})")
        matched = sum(1 for _, n, _ in results if n == args.register_name)
        print(f"identified {matched}/{len(results)} streamed frames as "
              f"'{args.register_name}'")
        return results


def build_streams(args):
    """Set up the multi-stream mode from parsed ``args``: returns ``(pipe,
    frames)``, the pipeline (``pipe(frames)`` is one dispatch) and the
    ``[streams, H, W, 3]`` frames on the device, all made from
    ``--seed``. With ``--dynamic-gallery`` the gallery is a
    ``DeviceGallery`` read at every dispatch."""
    from ..device import resolve_device
    from ..serve.device_gallery import DeviceGallery
    from ..serve.pipeline import make_multistream_pipeline

    device = resolve_device(args.device)
    model = _embed_model(args, device)
    fh, fw = args.frame_size
    det = _detector(args, device)
    rng = np.random.default_rng(args.seed + 1)
    gallery = rng.normal(size=(max(args.identities, 1),
                               model.feature_dim)).astype(np.float32)
    kw = dict(frame_h=fh, frame_w=fw, embed_size=args.image_size,
              thresholds=tuple(args.det_thresholds),
              sim_threshold=args.sim_threshold, device=device)
    if args.dynamic_gallery:
        base = make_multistream_pipeline(det, model, dynamic_gallery=True,
                                         **kw)
        dg = DeviceGallery(model.feature_dim, initial=gallery,
                           capacity=max(args.identities, 1),
                           dtype=_common.gallery_dtype(args.gallery_dtype),
                           device=device)

        def pipe(f):
            return base(f, dg.gallery_n, dg.rows_arg)
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


def _camera_main(args, model, device):
    """The default mode: enroll synthetic identities through the state
    machine, stream frames of random identities from a producer thread,
    and identify the freshest ones."""
    from ..data.synthetic import synthetic_faces
    from ..serve.recognition import RecognitionService

    embed_fn = _make_embed_fn(args, model, device)
    _reset_store(args)
    shape = (args.image_size, args.image_size, 1)
    images, labels = synthetic_faces(num_ids=args.identities, per_id=6,
                                     size=args.image_size, seed=args.seed)
    with RecognitionService(embed_fn, args.store, model.feature_dim,
                            sim_threshold=args.sim_threshold,
                            frame_shape=shape) as svc:
        # enrollment through the state machine
        for ident in range(args.identities):
            frames = images[labels == ident][:4]
            stored = svc.register(f"person_{ident}", frames)
            print(f"enrolled person_{ident}: {stored} representative "
                  f"feature(s); store size {len(svc.store)}")

        # camera thread: stream frames of random identities
        rng = np.random.default_rng(args.seed + 1)
        truth = {}
        stop = threading.Event()

        def camera():
            for seq in range(args.frames):
                ident = int(rng.integers(0, args.identities))
                pool = images[labels == ident]
                truth[seq] = ident
                svc.push_frame(pool[int(rng.integers(0, len(pool)))], seq=seq)
                time.sleep(0.002)
            stop.set()

        t = threading.Thread(target=camera)
        t.start()
        correct = seen = 0
        while True:
            res = svc.identify_latest()
            if res is None:
                if stop.is_set():
                    break  # producer done and queue drained
                time.sleep(0.001)
                continue
            name, sim, seq = res
            expected = f"person_{truth[seq]}"
            ok = name == expected
            correct += int(ok)
            seen += 1
            print(f"frame {seq:3d}: {name or '<unknown>'} (sim {sim:+.3f}) "
                  f"expected {expected} {'OK' if ok else 'MISS'}")
        t.join()
        print(f"identified {correct}/{seen} sampled frames correctly "
              f"(drop-stale queue skips backlog by design)")
        return correct, seen


def parse_args(argv=None):
    """Parse and check the command line (the JAX demo's flag checks)."""
    args = build_parser().parse_args(argv)
    _check_args(args)
    return args


def main(argv=None):
    from ..device import full_f32, resolve_device

    full_f32()
    args = parse_args(argv)
    if args.streams:
        return streams_main(args)
    if args.video and args.detect and args.native:
        resolve_device(args.device)
        return _video_native_detect_main(args)
    device = resolve_device(args.device)
    model = _embed_model(args, device)
    if args.video and args.detect:
        return _video_detect_main(args, model, device)
    if args.video:
        return _video_main(args, model, device)
    return _camera_main(args, model, device)


if __name__ == "__main__":
    main()
