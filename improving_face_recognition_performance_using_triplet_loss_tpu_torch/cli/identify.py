"""Headless enrollment + identification against the native identity store.

Port of the JAX package's ``cli/identify.py``, every subcommand. The
device routes of ``match-person`` (``--tpu``: one product against the
store's rows; ``--device-gallery``: the device-resident gallery) run on
``--device`` (``cuda`` unless given); ``--tpu`` keeps the JAX CLI's name.

The scriptable counterpart of the reference's Register_DB*/Compare_Face_DB
flows (Feature.hpp:453-804): enroll feature rows (deduped, with optional
person metadata) into the durable store, then batch-identify probe features.

  ... cli.identify enroll --store db.fjdb --features gallery.npz
  ... cli.identify match  --store db.fjdb --features probes.npz --sim-th 0.5
"""

from __future__ import annotations

import argparse
import json


def _add_native_mtcnn_args(sp):
    """Raw-frame input: detect faces natively before embedding — the
    reference's complete in-process loop (MTCNN.hpp detection +
    Feature.hpp:189-205 extraction in one C++ runtime)."""
    sp.add_argument("--native-mtcnn", metavar="NPZ",
                    help="with --native-export: treat --features as RAW "
                         "FRAMES; run the native MTCNN cascade "
                         "(serve.export.export_mtcnn npz) on each frame, "
                         "crop the largest-centered face, then embed — "
                         "pixels->identity with zero Python compute")
    sp.add_argument("--mtcnn-minsize", type=int, default=20)
    sp.add_argument("--mtcnn-thresholds", type=float, nargs=3,
                    default=(0.6, 0.7, 0.7))
    sp.add_argument("--mtcnn-margin", type=int, default=0,
                    help="crop margin in px (0 = the serving-style direct "
                         "box crop; align-style dataset prep uses 44)")
    sp.add_argument("--mtcnn-all-faces", action="store_true",
                    help="MATCH ONLY: embed EVERY detected face per frame "
                         "instead of the largest-centered one (the "
                         "reference runs Compare_Face_DB per detection, "
                         "Feature.hpp:763-804); results carry a 'face' "
                         "index next to 'probe'. Rejected for enrollment "
                         "(bystander faces would inherit the frame label)")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("enroll", help="register features into the store")
    e.add_argument("--store", required=True, help="identity store file")
    e.add_argument("--features", required=True,
                   help=".npz feature store (features+labels); with "
                        "--native-export, an IMAGE store instead")
    e.add_argument("--native-export",
                   help="export dir: embed the --features IMAGE store with "
                        "the native C++ forward (the reference's in-process "
                        "flow, Feature.hpp:163-205)")
    e.add_argument("--int8", action="store_true",
                   help="with --native-export: int8 quantized convs "
                        "(2.9x faster, >=0.9997 cosine vs f32)")
    _add_native_mtcnn_args(e)
    e.add_argument("--names-json", help='{"classes": [...]} mapping labels '
                                        "to names (pack_dataset output)")
    e.add_argument("--select-threshold", type=float, default=0.98,
                   help="keep mutually-dissimilar representatives per "
                        "identity below this cosine (clustering.h rule)")
    e.add_argument("--dedup-threshold", type=float, default=0.99999)
    e.add_argument("--skip-existing-names", action="store_true",
                   help="skip identities whose name is already enrolled "
                        "(Register_and_Check_DB_File, Feature.hpp:614-667)")

    m = sub.add_parser("match", help="identify probe features")
    m.add_argument("--store", required=True)
    m.add_argument("--features", required=True)
    m.add_argument("--native-export",
                   help="export dir: embed the --features IMAGE store with "
                        "the native C++ forward (see enroll --native-export)")
    m.add_argument("--int8", action="store_true")
    _add_native_mtcnn_args(m)
    m.add_argument("--sim-th", type=float, default=0.5)
    m.add_argument("--out", help="write results JSONL here")

    # ---- person-level flows (reference PG side, Feature.hpp:679-932) ----
    ep = sub.add_parser("enroll-person",
                        help="register one person with N face features "
                             "(Register_PDB)")
    ep.add_argument("--store", required=True, help="person .sqlite db")
    ep.add_argument("--features", required=True,
                    help=".npz feature store; --label selects this "
                         "person's rows")
    ep.add_argument("--label", type=int, required=True)
    ep.add_argument("--name", default="")
    ep.add_argument("--student-id", default="")
    ep.add_argument("--card-id", default="")
    ep.add_argument("--email", default="")
    ep.add_argument("--role-title", default="")
    ep.add_argument("--data-root", help="save crops under this root")
    ep.add_argument("--native-export",
                    help="export dir: treat --features as IMAGES (or raw "
                         "FRAMES with --native-mtcnn) and embed with the "
                         "native C++ forward")
    ep.add_argument("--int8", action="store_true")
    _add_native_mtcnn_args(ep)

    mp = sub.add_parser("match-person",
                        help="identify probes against the person db "
                             "(Compare_Face_DB)")
    mp.add_argument("--store", required=True)
    mp.add_argument("--features", required=True)
    mp.add_argument("--sim-th", type=float, default=0.5)
    mp.add_argument("--out", help="write results JSONL here")
    mp.add_argument("--native-export",
                    help="export dir: embed images/frames with the native "
                         "C++ forward (see enroll-person)")
    mp.add_argument("--int8", action="store_true")
    mp.add_argument("--tpu", action="store_true",
                    help="bulk-identify all probes with ONE matrix product "
                         "on the card (--device; PersonStore.match_batch "
                         "via serve/gallery.py) instead of the per-probe "
                         "host scan — the right side of the ~100k-face "
                         "crossover; the name is the JAX CLI's")
    mp.add_argument("--device-gallery", action="store_true",
                    help="serve from the device-resident gallery "
                         "(serve/gallery_service.py): cold-start the "
                         "device matrix from the store once, match with "
                         "one product against (gallery_n, rows), "
                         "resolve rows back to persons — the dynamic "
                         "pipelines' serving path")
    from ._common import GALLERY_DTYPE_NAMES

    mp.add_argument("--gallery-dtype", choices=GALLERY_DTYPE_NAMES,
                    default="f32",
                    help="with --device-gallery: storage dtype of the "
                         "gallery rows on the device (bf16 halves / int8 "
                         "quarters the bandwidth-bound match bytes)")
    mp.add_argument("--device", default=None,
                    help="torch device of --tpu / --device-gallery "
                         "(default cuda)")
    _add_native_mtcnn_args(mp)

    rc = sub.add_parser("register-card",
                        help="card-only pre-registration "
                             "(Register_PDB_onlyCard)")
    rc.add_argument("--store", required=True)
    rc.add_argument("--features", required=True)
    rc.add_argument("--label", type=int, required=True)
    rc.add_argument("--card-id", required=True)

    li = sub.add_parser("lookup-id",
                        help="find a person by student-id number "
                             "(isExistIDNumber)")
    li.add_argument("--store", required=True)
    li.add_argument("--id-number", required=True)

    pr = sub.add_parser("promote",
                        help="promote a pending card registration to a "
                             "real person")
    pr.add_argument("--store", required=True)
    pr.add_argument("--rid", type=int, required=True)
    pr.add_argument("--name", default="")
    pr.add_argument("--student-id", default="")
    return p


def _person_main(args):
    import numpy as np

    from ..data import load_feature_store  # noqa: F401 (non-native path)
    from ..serve.person_store import Person, PersonStore

    if args.command == "lookup-id":
        with PersonStore(args.store, 1) as store:
            p = store.exists_id_number(args.id_number)
            print(json.dumps(None if p is None else p.__dict__))
            return p

    if args.command == "promote":
        with PersonStore(args.store, 1) as store:
            pid = store.promote_registration(
                args.rid, Person(name=args.name,
                                 student_id=args.student_id))
            print(f"promoted rid {args.rid} -> pid {pid}")
            return pid

    face_crops = None
    person_probe_idx = None
    if getattr(args, "native_export", None):
        from ..data.records import load_image_store
        from ..serve.native import NativeEmbedder

        images, labels = load_image_store(args.features)
        if getattr(args, "native_mtcnn", None):
            feats, labels, face_crops, person_probe_idx = \
                _detect_and_embed_native(args, images, labels)
        else:
            with NativeEmbedder(args.native_export,
                                quantized=args.int8) as emb:
                feats = np.stack([emb.extract(img) for img in images])
    else:
        feats, labels = load_feature_store(args.features)
    dim = feats.shape[1]
    if args.command == "enroll-person":
        rows = feats[labels == args.label]
        if rows.shape[0] == 0:
            raise SystemExit(f"no rows with label {args.label}")
        sel_crops = None
        if face_crops is not None:
            # the detected crops back the Register_PDB profile images
            # (reference crops under face_db_data_root, Feature.hpp:806-860)
            sel_crops = [face_crops[j] for j in np.where(
                labels == args.label)[0]]
        with PersonStore(args.store, dim,
                         data_root=args.data_root) as store:
            pid = store.register_person(
                Person(name=args.name, student_id=args.student_id,
                       card_id=args.card_id, email=args.email,
                       role_title=args.role_title), list(rows),
                crops=sel_crops)
            print(f"registered pid {pid} with {rows.shape[0]} faces")
            return pid
    if args.command == "register-card":
        rows = feats[labels == args.label]
        with PersonStore(args.store, dim) as store:
            rid = store.register_card_only(args.card_id, list(rows))
            print(f"pending registration rid {rid} "
                  f"({rows.shape[0]} faces, card {args.card_id})")
            return rid
    # match-person
    if person_probe_idx is None:
        person_probe_idx = np.arange(feats.shape[0])
    if getattr(args, "device_gallery", False) and getattr(args, "tpu",
                                                          False):
        raise SystemExit("--device-gallery and --tpu are different match "
                         "paths; pick one")
    if (getattr(args, "gallery_dtype", "f32") != "f32"
            and not getattr(args, "device_gallery", False)):
        raise SystemExit("--gallery-dtype applies to the device gallery "
                         "(use with --device-gallery)")
    results = []
    with PersonStore(args.store, dim, device=args.device) as store:
        if getattr(args, "device_gallery", False):
            from ..serve.gallery_service import PersonGalleryService
            from ._common import gallery_dtype

            matches = PersonGalleryService(
                store, dtype=gallery_dtype(args.gallery_dtype),
                device=args.device).match_batch(feats, sim_th=args.sim_th)
        elif getattr(args, "tpu", False):
            matches = store.match_batch(feats, args.sim_th)
        else:
            matches = [store.match(fv, args.sim_th) for fv in feats]
        for i, res in enumerate(matches):
            # probe = ORIGINAL frame index; 'face' = box index with
            # --mtcnn-all-faces (same contract as plain `match`)
            pi = person_probe_idx[i]
            frame_i, face_i = ((int(pi[0]), int(pi[1]))
                               if np.ndim(pi) else (int(pi), 0))
            results.append({
                "probe": frame_i,
                "face": face_i,
                "label": int(labels[i]) if labels is not None else None,
                "pid": None if res.person is None else res.person.pid,
                "name": None if res.person is None else res.person.name,
                "similarity": round(float(res.similarity), 6),
            })
    matched = sum(1 for r in results if r["pid"] is not None)
    print(f"matched {matched}/{len(results)} probes above {args.sim_th}")
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


def _detect_and_embed_native(args, images, labels):
    """Raw frames -> native MTCNN -> largest-centered crop -> native embed.

    The reference runtime's per-frame flow (tmp.cpp manifest:
    MTCNN_Dlib_Detection -> grayscale crop -> Feature_Extract_exe) with the
    largest-centered selection rule of align_dataset_mtcnn.py:84-97 and the
    cvtColor-style luminance conversion of Feature.hpp:517-523.
    """
    import numpy as np

    from ..detect.align import crop_face, select_main_face
    from ..serve.native import NativeEmbedder, NativeMtcnn

    feats, kept, crops, src_idx = [], [], [], []
    skipped = crop_failed = 0
    with NativeMtcnn(args.native_mtcnn, quantized=args.int8) as det, \
            NativeEmbedder(args.native_export, quantized=args.int8) as emb:
        size = int(((emb.manifest or {}).get("input") or {})
                   .get("height", 64))
        for i, img in enumerate(images):
            frame = np.asarray(img)
            if frame.ndim == 3 and frame.shape[2] == 1:
                frame = frame[..., 0]
            boxes, _ = det.detect(frame, minsize=args.mtcnn_minsize,
                                  thresholds=tuple(args.mtcnn_thresholds))
            if boxes.shape[0] == 0:
                skipped += 1
                continue
            if getattr(args, "mtcnn_all_faces", False):
                dets = boxes[:, :4]
            else:
                dets = select_main_face(boxes, frame.shape)
            frame3 = (frame[..., None].repeat(3, -1) if frame.ndim == 2
                      else frame).astype(np.float32)
            for fi, det_box in enumerate(dets):
                try:
                    # regression offsets are unbounded: a degenerate box
                    # (x2 <= x1 after clamping) must skip the face, not
                    # abort the whole run
                    crop = crop_face(frame3, det_box, image_size=size,
                                     margin=args.mtcnn_margin)
                except Exception:
                    crop_failed += 1
                    continue
                gray = (0.299 * crop[..., 0] + 0.587 * crop[..., 1]
                        + 0.114 * crop[..., 2]).astype(np.float32) / 255.0
                feats.append(emb.extract(gray))
                kept.append(labels[i] if labels is not None else 0)
                crops.append(crop)
                src_idx.append((i, fi))
    if not feats:
        raise SystemExit("no faces detected in any frame — check "
                         "--mtcnn-thresholds / --mtcnn-minsize")
    print(f"native detect+embed: {len(feats)} faces from "
          f"{len(images)} frames ({skipped} frames without a detection, "
          f"{crop_failed} degenerate boxes dropped)")
    return np.stack(feats), np.asarray(kept), crops, np.asarray(src_idx)


def main(argv=None):
    from ..device import full_f32

    full_f32()
    args = build_parser().parse_args(argv)
    import numpy as np

    if (getattr(args, "native_mtcnn", None)
            and not getattr(args, "native_export", None)):
        raise SystemExit("--native-mtcnn needs --native-export (frames are "
                         "embedded by the native forward after detection)")
    if (getattr(args, "mtcnn_all_faces", False)
            and args.command not in ("match", "match-person")):
        raise SystemExit("--mtcnn-all-faces is match-only: during "
                         "enrollment every face in the frame would inherit "
                         "the frame's label, registering bystanders under "
                         "the target identity")

    if args.command in ("enroll-person", "match-person", "register-card",
                        "lookup-id", "promote"):
        return _person_main(args)

    from ..data import load_feature_store
    from ..serve.native import (NativeEmbedder, NativeIdentityStore,
                                native_select_representatives)

    probe_idx = None
    if getattr(args, "native_export", None):
        # pixels -> identity in one native process: embed the image store
        # with the C++ forward, then enroll/match below as usual
        from ..data.records import load_image_store

        images, labels = load_image_store(args.features)
        if getattr(args, "native_mtcnn", None):
            feats, labels, _, probe_idx = _detect_and_embed_native(
                args, images, labels)
        else:
            with NativeEmbedder(args.native_export,
                                quantized=args.int8) as emb:
                feats = np.stack([emb.extract(img) for img in images])
            print(f"natively embedded {feats.shape[0]} images "
                  f"({'int8' if args.int8 else 'f32'}, dim {feats.shape[1]})")
    else:
        feats, labels = load_feature_store(args.features)
    if probe_idx is None:
        probe_idx = np.arange(feats.shape[0])
    dim = feats.shape[1]

    if args.command == "enroll":
        names = None
        if args.names_json:
            with open(args.names_json) as f:
                names = json.load(f)["classes"]
        stored = deduped = skipped_names = 0
        with NativeIdentityStore(args.store, dim) as store:
            for ident in np.unique(labels):
                rows = feats[labels == ident]
                sel = native_select_representatives(
                    rows.astype(np.float32), args.select_threshold)
                name = (names[int(ident)] if names else f"id_{int(ident)}")
                if args.skip_existing_names and store.exists(name):
                    skipped_names += 1
                    continue
                for i in sel:
                    if store.register(name, rows[i],
                                      args.dedup_threshold) >= 0:
                        stored += 1
                    else:
                        deduped += 1
            print(f"enrolled {stored} features ({deduped} deduped, "
                  f"{skipped_names} names already present); "
                  f"store size {len(store)}")
        return stored

    # match
    results = []
    with NativeIdentityStore(args.store, dim) as store:
        if len(store) == 0:
            raise SystemExit(f"store {args.store} is empty — enroll first")
        for i, fv in enumerate(feats):
            name, sim = store.match(fv, args.sim_th)
            # probe = ORIGINAL input-frame index (native detection may
            # skip frames, so row order alone would mislabel consumers);
            # with --mtcnn-all-faces, 'face' is the box index in the frame
            pi = probe_idx[i]
            frame_i, face_i = ((int(pi[0]), int(pi[1]))
                               if np.ndim(pi) else (int(pi), 0))
            results.append({"probe": frame_i, "face": face_i,
                            "label": int(labels[i]) if labels is not None else None,
                            "name": name, "similarity": round(float(sim), 6)})
    matched = sum(1 for r in results if r["name"] is not None)
    print(f"matched {matched}/{len(results)} probes above {args.sim_th}")
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


if __name__ == "__main__":
    main()
