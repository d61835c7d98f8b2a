"""Numpy box math of the MTCNN cascade (copies, not imports).

Near-line copies of the JAX package's ``ops/oracles.py`` (itself a port of
the vendored facenet ``detect_face.py:626-744``, MIT-licensed): greedy
``nms``, the numeric spec that the port's keep-mask NMS and kernel B5 are
tested against, and ``bbreg``, ``rerec``, ``pad`` and
``generate_bounding_box``. The host cascade (``detect/pipeline.py``) runs
all five on the host, as the reference does; no device path calls them.
"""

from __future__ import annotations

import numpy as np


def nms(boxes: np.ndarray, threshold: float, method: str = "Union") -> np.ndarray:
    """Greedy NMS; method 'Union' = IoU, 'Min' = inter/min-area
    (detect_face.py:668-698). Returns kept indices in score order."""
    if boxes.size == 0:
        return np.zeros((0,), dtype=np.int64)
    x1, y1, x2, y2, s = (boxes[:, i] for i in range(5))
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(s)
    pick = []
    while order.size > 0:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        if method == "Min":
            o = inter / np.minimum(area[i], area[rest])
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = rest[o <= threshold]
    return np.asarray(pick, dtype=np.int64)


def bbreg(boundingbox: np.ndarray, reg: np.ndarray) -> np.ndarray:
    """Calibrate boxes by regression offsets (detect_face.py:627-639)."""
    boundingbox = boundingbox.copy()
    if reg.shape[1] == 1:
        reg = np.reshape(reg, (reg.shape[2], reg.shape[3]))
    w = boundingbox[:, 2] - boundingbox[:, 0] + 1
    h = boundingbox[:, 3] - boundingbox[:, 1] + 1
    boundingbox[:, 0] = boundingbox[:, 0] + reg[:, 0] * w
    boundingbox[:, 1] = boundingbox[:, 1] + reg[:, 1] * h
    boundingbox[:, 2] = boundingbox[:, 2] + reg[:, 2] * w
    boundingbox[:, 3] = boundingbox[:, 3] + reg[:, 3] * h
    return boundingbox


def rerec(bbox: np.ndarray) -> np.ndarray:
    """Expand boxes to squares about their centers (detect_face.py:736-744)."""
    bbox = bbox.copy()
    h = bbox[:, 3] - bbox[:, 1]
    w = bbox[:, 2] - bbox[:, 0]
    l = np.maximum(w, h)
    bbox[:, 0] = bbox[:, 0] + w * 0.5 - l * 0.5
    bbox[:, 1] = bbox[:, 1] + h * 0.5 - l * 0.5
    bbox[:, 2:4] = bbox[:, 0:2] + np.tile(l, (2, 1)).T
    return bbox


def pad(total_boxes: np.ndarray, w: int, h: int):
    """Clip boxes to the image, returning source/dest crop coordinates
    (1-indexed, detect_face.py:701-733)."""
    tmpw = (total_boxes[:, 2] - total_boxes[:, 0] + 1).astype(np.int32)
    tmph = (total_boxes[:, 3] - total_boxes[:, 1] + 1).astype(np.int32)
    numbox = total_boxes.shape[0]

    dx = np.ones((numbox,), dtype=np.int32)
    dy = np.ones((numbox,), dtype=np.int32)
    edx = tmpw.copy()
    edy = tmph.copy()
    x = total_boxes[:, 0].astype(np.int32)
    y = total_boxes[:, 1].astype(np.int32)
    ex = total_boxes[:, 2].astype(np.int32)
    ey = total_boxes[:, 3].astype(np.int32)

    t = ex > w
    edx[t] = -ex[t] + w + tmpw[t]
    ex[t] = w
    t = ey > h
    edy[t] = -ey[t] + h + tmph[t]
    ey[t] = h
    t = x < 1
    dx[t] = 2 - x[t]
    x[t] = 1
    t = y < 1
    dy[t] = 2 - y[t]
    y[t] = 1
    return dy, edy, dx, edx, y, ey, x, ex, tmpw, tmph


def generate_bounding_box(imap: np.ndarray, reg: np.ndarray, scale: float,
                          t: float):
    """Decode PNet heatmap to boxes (detect_face.py:641-665).

    Args:
      imap: [H', W'] face-probability map (already in image orientation).
      reg: [H', W', 4] regression maps.

    Returns ([N, 9] boxes: q1(2) q2(2) score reg(4), reg [N, 4]).
    """
    stride = 2
    cellsize = 12
    imap = np.transpose(imap)
    dx1 = np.transpose(reg[:, :, 0])
    dy1 = np.transpose(reg[:, :, 1])
    dx2 = np.transpose(reg[:, :, 2])
    dy2 = np.transpose(reg[:, :, 3])
    y, x = np.where(imap >= t)
    if y.shape[0] == 1:
        dx1 = np.flipud(dx1)
        dy1 = np.flipud(dy1)
        dx2 = np.flipud(dx2)
        dy2 = np.flipud(dy2)
    score = imap[(y, x)]
    regs = np.transpose(np.vstack([dx1[(y, x)], dy1[(y, x)], dx2[(y, x)],
                                   dy2[(y, x)]]))
    if regs.size == 0:
        regs = np.empty((0, 3))
    bb = np.transpose(np.vstack([y, x]))
    q1 = np.fix((stride * bb + 1) / scale)
    q2 = np.fix((stride * bb + cellsize - 1 + 1) / scale)
    boundingbox = np.hstack([q1, q2, np.expand_dims(score, 1), regs])
    return boundingbox, regs
