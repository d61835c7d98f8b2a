"""Dataset alignment (reference align_dataset_mtcnn.py:21-121).

Port of the JAX package's ``detect/align.py``: walks class-per-directory
image trees, detects faces, picks the largest-centered detection, pads by
a margin, resizes to the target size, and writes crops + a bounding_boxes
log, with the reference's selection rule (area minus 2x squared center
offset, align_dataset_mtcnn.py:86-95). The same PNG names, the same log
lines and the same skip accounting as the JAX function; detection runs the
host cascade, or ``DeviceCascade`` (kernel B5) with ``device_cascade``.
Image files are read and written with cv2, imported when a directory is
aligned.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .pipeline import MTCNNDetector, imresample


@dataclass
class AlignResult:
    total: int = 0
    aligned: int = 0
    skipped: int = 0


def select_main_face(bounding_boxes: np.ndarray, img_shape,
                     detect_multiple: bool = False) -> np.ndarray:
    """Pick det(s): all when detect_multiple, else largest-centered
    (align_dataset_mtcnn.py:84-97)."""
    nrof_faces = bounding_boxes.shape[0]
    det = bounding_boxes[:, 0:4]
    if nrof_faces == 1 or detect_multiple:
        return det
    img_size = np.asarray(img_shape)[0:2]
    bounding_box_size = ((det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1]))
    img_center = img_size / 2
    offsets = np.vstack([
        (det[:, 0] + det[:, 2]) / 2 - img_center[1],
        (det[:, 1] + det[:, 3]) / 2 - img_center[0],
    ])
    offset_dist_squared = np.sum(np.power(offsets, 2.0), 0)
    index = np.argmax(bounding_box_size - offset_dist_squared * 2.0)
    return det[index][None]


def crop_face(img: np.ndarray, det: np.ndarray, image_size: int = 182,
              margin: int = 44) -> np.ndarray:
    """Margin-pad + crop + resize (align_dataset_mtcnn.py:99-107)."""
    img_size = np.asarray(img.shape)[0:2]
    det = np.squeeze(det)
    bb = np.zeros(4, dtype=np.int32)
    bb[0] = np.maximum(det[0] - margin / 2, 0)
    bb[1] = np.maximum(det[1] - margin / 2, 0)
    bb[2] = np.minimum(det[2] + margin / 2, img_size[1])
    bb[3] = np.minimum(det[3] + margin / 2, img_size[0])
    cropped = img[bb[1]:bb[3], bb[0]:bb[2], :]
    return imresample(cropped.astype(np.float32),
                      (image_size, image_size)).astype(np.uint8)


def align_directory(
    input_dir: str,
    output_dir: str,
    detector: MTCNNDetector | None = None,
    image_size: int = 182,
    margin: int = 44,
    minsize: int = 20,
    thresholds=(0.6, 0.7, 0.7),
    factor: float = 0.709,
    detect_multiple: bool = False,
    device_cascade: bool = False,
    device=None,
) -> AlignResult:
    """Align every image under input_dir/<class>/<img>; mirrors the
    reference CLI behavior including the bounding_boxes log and
    skip-unalignable accounting (align_dataset_mtcnn.py:51-121). Without a
    ``detector``, a random-init one on ``device`` (``cuda`` unless
    given)."""
    import cv2

    detector = detector or MTCNNDetector(device=device)
    cascade = None
    if device_cascade:
        from .device_cascade import DeviceCascade

        cascade = DeviceCascade(detector, minsize=minsize, factor=factor,
                                thresholds=tuple(thresholds))
    os.makedirs(output_dir, exist_ok=True)
    res = AlignResult()
    log_path = os.path.join(output_dir, "bounding_boxes.txt")
    with open(log_path, "w") as log:
        for cls in sorted(os.listdir(input_dir)):
            cdir = os.path.join(input_dir, cls)
            if not os.path.isdir(cdir):
                continue
            out_cdir = os.path.join(output_dir, cls)
            os.makedirs(out_cdir, exist_ok=True)
            for fname in sorted(os.listdir(cdir)):
                path = os.path.join(cdir, fname)
                img = cv2.imread(path)
                res.total += 1
                if img is None:
                    res.skipped += 1
                    log.write(f"{path}\n")
                    continue
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                if cascade is not None:
                    boxes, _ = cascade.detect(img)
                else:
                    boxes, _ = detector.detect(img, minsize, thresholds,
                                               factor)
                if boxes.shape[0] == 0:
                    res.skipped += 1
                    log.write(f"{path}\n")
                    continue
                dets = select_main_face(boxes, img.shape, detect_multiple)
                for i, det in enumerate(dets):
                    crop = crop_face(img, det, image_size, margin)
                    stem = os.path.splitext(fname)[0]
                    suffix = f"_{i}" if detect_multiple and len(dets) > 1 else ""
                    out_path = os.path.join(out_cdir, f"{stem}{suffix}.png")
                    cv2.imwrite(out_path,
                                cv2.cvtColor(crop, cv2.COLOR_RGB2BGR))
                    bb = det.astype(int)
                    log.write(f"{out_path} {bb[0]} {bb[1]} {bb[2]} {bb[3]}\n")
                res.aligned += 1
    return res
