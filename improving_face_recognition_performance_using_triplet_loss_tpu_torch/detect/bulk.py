"""Bulk face detection (reference ``bulk_detect_face``, detect_face.py:402-623).

The reference buckets images by resolution and runs each pyramid scale as
ONE batched PNet pass over every image in the bucket, then batches RNet/ONet
across all images' candidate boxes with per-image bookkeeping. Same design
here: same-shape groups share pyramid scales and batched device calls, so a
dataset-alignment sweep costs one PNet dispatch per (bucket, scale) instead
of one per (image, scale).

``detection_window_size_ratio`` follows the reference: minsize is derived
per bucket as ``ratio * min(H, W)`` (detect_face.py:407-430).

Port of the JAX package's ``detect/bulk.py`` over the port's host cascade
(``detect/pipeline.py``): the nets run on the detector's device, the box
bookkeeping and NMS stay in numpy on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops.boxes import bbreg, generate_bounding_box, nms, rerec
from .pipeline import MTCNNDetector, imresample, pyramid_scales


def detect_faces_bulk(
    images: Sequence[np.ndarray],
    detection_window_size_ratio: float = 0.1,
    detector: MTCNNDetector | None = None,
    thresholds: Sequence[float] = (0.6, 0.7, 0.7),
    factor: float = 0.709,
):
    """Detect faces in many images; returns a list of (boxes, points) per
    image (None entries where nothing was found). Without a ``detector``,
    one random-init detector on ``cuda``."""
    det = detector or MTCNNDetector()
    images = [np.asarray(im) for im in images]
    images = [np.repeat(im[..., None], 3, -1) if im.ndim == 2 else im
              for im in images]
    results: list = [None] * len(images)

    # bucket by resolution (detect_face.py:432-445)
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, im in enumerate(images):
        buckets.setdefault(im.shape[:2], []).append(i)

    for (h, w), idxs in buckets.items():
        minsize = max(int(detection_window_size_ratio * min(h, w)), 12)
        scales = pyramid_scales(h, w, minsize, factor)
        per_image_boxes = {i: np.empty((0, 9)) for i in idxs}

        # stage 1: one batched PNet pass per scale across the whole bucket
        for scale in scales:
            hs = int(np.ceil(h * scale))
            ws = int(np.ceil(w * scale))
            batch = np.stack([
                (imresample(images[i], (hs, ws)) - 127.5) * 0.0078125
                for i in idxs])
            batch = np.transpose(batch, (0, 2, 1, 3))  # TF orientation
            prob, reg = det._run(det.pnet, batch)
            prob = np.transpose(prob, (0, 2, 1, 3))
            reg = np.transpose(reg, (0, 2, 1, 3))
            for bi, i in enumerate(idxs):
                boxes, _ = generate_bounding_box(
                    prob[bi, :, :, 1].copy(), reg[bi].copy(), scale,
                    thresholds[0])
                pick = nms(boxes.copy(), 0.5, "Union")
                if boxes.size and pick.size:
                    per_image_boxes[i] = np.append(per_image_boxes[i],
                                                   boxes[pick], axis=0)

        # per-image cross-scale NMS + regression + square (as single path)
        rnet_crops = []
        rnet_owner = []
        total_by_image: dict[int, np.ndarray] = {}
        for i in idxs:
            tb = per_image_boxes[i]
            if tb.shape[0] == 0:
                continue
            pick = nms(tb.copy(), 0.7, "Union")
            tb = tb[pick]
            regw = tb[:, 2] - tb[:, 0]
            regh = tb[:, 3] - tb[:, 1]
            tb = np.transpose(np.vstack([
                tb[:, 0] + tb[:, 5] * regw, tb[:, 1] + tb[:, 6] * regh,
                tb[:, 2] + tb[:, 7] * regw, tb[:, 3] + tb[:, 8] * regh,
                tb[:, 4]]))
            tb = rerec(tb.copy())
            tb[:, 0:4] = np.fix(tb[:, 0:4]).astype(np.int32)
            total_by_image[i] = tb
            crops = det._crops(images[i], tb, 24)
            rnet_crops.append(crops)
            rnet_owner += [i] * crops.shape[0]

        # stage 2: one batched RNet pass over every candidate in the bucket
        if rnet_crops:
            crops = np.concatenate(rnet_crops, 0)
            prob, reg = det._run(det.rnet, crops)
            owners = np.asarray(rnet_owner)
            onet_inputs = {}
            for i in idxs:
                sel = owners == i
                if not sel.any() or i not in total_by_image:
                    continue
                score = prob[sel, 1]
                tb = total_by_image[i]
                ipass = score > thresholds[1]
                tb = np.hstack([tb[ipass, 0:4], score[ipass, None]])
                mv = reg[sel][ipass].T
                if tb.shape[0]:
                    pick = nms(tb, 0.7, "Union")
                    tb = bbreg(tb[pick].copy(), np.transpose(mv[:, pick]))
                    tb = rerec(tb.copy())
                    onet_inputs[i] = np.fix(tb).astype(np.int32).astype(
                        np.float64)

            # stage 3: one batched ONet pass
            onet_crops = []
            onet_owner = []
            for i, tb in onet_inputs.items():
                crops = det._crops(images[i], tb, 48)
                onet_crops.append(crops)
                onet_owner += [i] * crops.shape[0]
            if onet_crops:
                crops = np.concatenate(onet_crops, 0)
                prob, reg, lmk = det._run(det.onet, crops)
                owners = np.asarray(onet_owner)
                for i, tb in onet_inputs.items():
                    sel = owners == i
                    score = prob[sel, 1]
                    pts = lmk[sel].T
                    ipass = score > thresholds[2]
                    pts = pts[:, ipass]
                    boxes_i = np.hstack([tb[ipass, 0:4],
                                         score[ipass, None]])
                    mv = reg[sel][ipass].T
                    bw = boxes_i[:, 2] - boxes_i[:, 0] + 1
                    bh = boxes_i[:, 3] - boxes_i[:, 1] + 1
                    pts = pts.copy()
                    pts[0:5, :] = (np.tile(bw, (5, 1)) * pts[0:5, :]
                                   + np.tile(boxes_i[:, 0], (5, 1)) - 1)
                    pts[5:10, :] = (np.tile(bh, (5, 1)) * pts[5:10, :]
                                    + np.tile(boxes_i[:, 1], (5, 1)) - 1)
                    if boxes_i.shape[0]:
                        boxes_i = bbreg(boxes_i.copy(), np.transpose(mv))
                        pick = nms(boxes_i.copy(), 0.7, "Min")
                        results[i] = (boxes_i[pick], pts[:, pick])
    return results
