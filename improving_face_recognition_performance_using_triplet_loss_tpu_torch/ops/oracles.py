"""Numpy golden oracle for greedy NMS (a copy, not an import).

A near-line copy of ``nms`` in the JAX package's ``ops/oracles.py`` (itself
a port of the vendored facenet ``detect_face.py:668-698``, MIT-licensed):
the numeric spec that the port's keep-mask NMS and kernel B5 are tested
against. No serving path calls it.
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
