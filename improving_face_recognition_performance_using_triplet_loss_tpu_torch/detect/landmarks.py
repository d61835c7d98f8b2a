"""Landmark-based face alignment (reference C16 capability).

A copy of the JAX package's ``detect/landmarks.py`` (numpy; cv2 imported
only by ``align_face``): the port keeps its own so it never imports the
JAX package.

The reference fuses MTCNN 5-point landmarks with a dlib 68-point shape
predictor via an affine warp of the initial shape (MTCNN.hpp:924-988, using
the absent TransformLandmark.hpp). dlib is not in this image; the capability
— geometric normalization of a face crop from detected landmarks — is
provided by the standard similarity-transform alignment used by ArcFace-
style pipelines: least-squares similarity transform from the 5 detected
points to a canonical template, then an affine warp.
"""

from __future__ import annotations

import numpy as np

# Canonical 5-point template for a 112x112 crop (widely used ArcFace layout:
# eyes, nose tip, mouth corners), scaled at use time.
ARCFACE_TEMPLATE_112 = np.asarray([
    [38.2946, 51.6963],
    [73.5318, 51.5014],
    [56.0252, 71.7366],
    [41.5493, 92.3655],
    [70.7299, 92.2041],
], np.float32)


def mtcnn_points_to_xy(points: np.ndarray, face_index: int = 0) -> np.ndarray:
    """MTCNN landmark layout (5 xs then 5 ys per column,
    detect_face.py:383-392) -> [5, 2] (x, y) array."""
    col = np.asarray(points)[:, face_index]
    return np.stack([col[0:5], col[5:10]], axis=1).astype(np.float32)


def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (scale+rotation+translation) mapping
    src [N, 2] -> dst [N, 2]; returns a 2x3 affine matrix (Umeyama)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, d])
    var_s = (sc ** 2).sum() / src.shape[0]
    scale = np.trace(np.diag(s) @ diag) / var_s
    rot = scale * (u @ diag @ vt)
    t = mu_d - rot @ mu_s
    return np.hstack([rot, t[:, None]]).astype(np.float32)


def apply_affine(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    """[N, 2] points through a 2x3 affine."""
    points = np.asarray(points, np.float32)
    return points @ m[:, :2].T + m[:, 2]


def align_face(img: np.ndarray, landmarks_xy: np.ndarray,
               size: int = 112) -> np.ndarray:
    """Warp a face to the canonical template using its 5 landmarks."""
    import cv2

    template = ARCFACE_TEMPLATE_112 * (size / 112.0)
    m = similarity_transform(landmarks_xy, template)
    return cv2.warpAffine(img, m, (size, size))
