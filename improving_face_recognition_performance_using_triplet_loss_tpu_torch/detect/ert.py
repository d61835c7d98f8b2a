"""68-point ERT shape regression (reference capability C16).

Port of the JAX package's ``detect/ert.py``, a copy of its numpy code: the
same ``np.random.default_rng(seed)`` draws in the same order, so one seed
trains the same predictor bit for bit, and the same ``.npz`` format, read
and written by either package. ``mtcnn_ert_detect`` runs the port's host
cascade (``detect/pipeline.py``), whose nets run on the detector's device.

The reference refines MTCNN detections to 68 dlib landmarks: seed the shape
predictor's mean shape with an affine warp computed from MTCNN's 5 points,
then run dlib's ensemble-of-regression-trees cascade
(``MTCNN_Dlib_Detection``, MTCNN.hpp:1326-1421 and 924-988; the
getInitShape/LandmarksToROI_/warpAffineLandmarks helpers live in the
author's modified dlib and ship no source).

dlib is absent from this environment and no shape_predictor .dat exists to
parse, so the capability is rebuilt self-sufficiently: the Kazemi & Sullivan
(CVPR 2014) algorithm — the exact method inside dlib's shape_predictor —
implemented here as vectorized numpy **inference** (`ShapePredictor`) plus a
gradient-boosting **trainer** (`train_shape_predictor`), with a documented
.npz model format. This is a host-side scalar/branchy workload in dlib too
(it runs on CPU there); the batched tree traversal here is fully vectorized
across trees and faces.

Coordinate convention (dlib's): shapes live in the unit square of the
detection rectangle; feature-pixel locations are indexed relative to the
mean shape and re-mapped through the current shape's similarity transform
each cascade level.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .landmarks import apply_affine, similarity_transform

# the 5 MTCNN points (left eye, right eye, nose, mouth-L, mouth-R) as
# indices into the 68-point iBUG-68 layout used by dlib models: eye centers
# are the mean of the 6 eye-contour points.
IBUG68_LEFT_EYE = list(range(36, 42))
IBUG68_RIGHT_EYE = list(range(42, 48))
IBUG68_NOSE_TIP = 30
IBUG68_MOUTH_L = 48
IBUG68_MOUTH_R = 54


def five_points_from_68(shape68: np.ndarray) -> np.ndarray:
    """Collapse a [68, 2] shape to the MTCNN 5-point layout [5, 2]."""
    return np.stack([
        shape68[IBUG68_LEFT_EYE].mean(0),
        shape68[IBUG68_RIGHT_EYE].mean(0),
        shape68[IBUG68_NOSE_TIP],
        shape68[IBUG68_MOUTH_L],
        shape68[IBUG68_MOUTH_R],
    ]).astype(np.float32)


@dataclass
class CascadeLevel:
    """One boosting stage: P feature pixels + K depth-D trees.

    split arrays are [K, 2**D - 1] (heap-ordered internal nodes); leaf
    values are [K, 2**D, 2L] and already include the shrinkage factor.
    """

    anchors: np.ndarray      # [P] nearest-landmark index per feature pixel
    deltas: np.ndarray       # [P, 2] offset from that landmark (mean-shape coords)
    split_idx1: np.ndarray   # [K, 2**D - 1]
    split_idx2: np.ndarray   # [K, 2**D - 1]
    split_thresh: np.ndarray  # [K, 2**D - 1]
    leaf_values: np.ndarray  # [K, 2**D, 2L]

    @property
    def depth(self) -> int:
        return int(np.log2(self.leaf_values.shape[1]) + 0.5)


@dataclass
class ShapePredictor:
    """ERT cascade: mean shape + T boosting levels."""

    mean_shape: np.ndarray          # [L, 2] in the unit square
    levels: list[CascadeLevel] = field(default_factory=list)

    @property
    def num_points(self) -> int:
        return self.mean_shape.shape[0]

    # ------------------------------------------------------------- io

    def save(self, path: str) -> None:
        arrays = {"mean_shape": self.mean_shape,
                  "num_levels": np.asarray(len(self.levels))}
        for t, lv in enumerate(self.levels):
            for name in ("anchors", "deltas", "split_idx1", "split_idx2",
                         "split_thresh", "leaf_values"):
                arrays[f"level{t}/{name}"] = getattr(lv, name)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "ShapePredictor":
        with np.load(path) as z:
            mean_shape = z["mean_shape"]
            levels = []
            for t in range(int(z["num_levels"])):
                levels.append(CascadeLevel(
                    *(z[f"level{t}/{n}"]
                      for n in ("anchors", "deltas", "split_idx1",
                                "split_idx2", "split_thresh",
                                "leaf_values"))))
        return cls(mean_shape=mean_shape, levels=levels)

    # ------------------------------------------------------- inference

    def init_shape_from_5pt(self, five_xy: np.ndarray,
                            rect: np.ndarray) -> np.ndarray:
        """The reference's MTCNN seeding (MTCNN.hpp:1391-1396): similarity
        transform from the mean shape's canonical 5 points to the detected
        5 points (both box-normalized), applied to all 68 mean points."""
        x1, y1, x2, y2 = [float(v) for v in rect]
        w, h = max(x2 - x1, 1e-6), max(y2 - y1, 1e-6)
        five_norm = (np.asarray(five_xy, np.float32)
                     - np.asarray([x1, y1], np.float32)) / [w, h]
        m = similarity_transform(five_points_from_68(self.mean_shape),
                                 five_norm)
        return apply_affine(self.mean_shape, m)

    def _features(self, img: np.ndarray, rect, shape: np.ndarray,
                  level: CascadeLevel) -> np.ndarray:
        """Sample P pixel intensities at shape-indexed locations."""
        x1, y1, x2, y2 = [float(v) for v in rect]
        w, h = max(x2 - x1, 1e-6), max(y2 - y1, 1e-6)
        # re-map mean-shape-relative deltas through the current shape's
        # similarity transform (rotation/scale part only, dlib semantics)
        m = similarity_transform(self.mean_shape, shape)
        pts = shape[level.anchors] + level.deltas @ m[:, :2].T
        xs = np.clip((pts[:, 0] * w + x1).astype(np.int64), 0,
                     img.shape[1] - 1)
        ys = np.clip((pts[:, 1] * h + y1).astype(np.int64), 0,
                     img.shape[0] - 1)
        return img[ys, xs].astype(np.float32)

    @staticmethod
    def _traverse(feats: np.ndarray, level: CascadeLevel) -> np.ndarray:
        """All K trees at once -> summed leaf vector [2L]."""
        k = level.leaf_values.shape[0]
        node = np.zeros(k, np.int64)
        rows = np.arange(k)
        for _ in range(level.depth):
            f1 = feats[level.split_idx1[rows, node]]
            f2 = feats[level.split_idx2[rows, node]]
            go_left = (f1 - f2) > level.split_thresh[rows, node]
            node = 2 * node + np.where(go_left, 1, 2)
        leaf = node - (level.split_thresh.shape[1])  # 2**D - 1 internal nodes
        return level.leaf_values[rows, leaf].sum(0)

    def predict(self, img: np.ndarray, rect, init_shape: np.ndarray | None
                = None) -> np.ndarray:
        """Refine: grayscale image + rect (+ optional seeded init, box-
        normalized) -> [L, 2] landmark coordinates in IMAGE space
        (full_object_detection.part() contract)."""
        img = np.asarray(img)
        if img.ndim == 3:
            img = img.mean(-1)
        shape = (self.mean_shape if init_shape is None
                 else np.asarray(init_shape, np.float32)).copy()
        for level in self.levels:
            feats = self._features(img, rect, shape, level)
            shape = shape + self._traverse(feats, level).reshape(-1, 2)
        x1, y1, x2, y2 = [float(v) for v in rect]
        return (shape * [x2 - x1, y2 - y1] + [x1, y1]).astype(np.float32)


def mtcnn_ert_detect(
    img: np.ndarray,
    predictor: ShapePredictor,
    detector=None,
    *,
    minsize: int = 20,
    thresholds=(0.6, 0.7, 0.7),
    factor: float = 0.709,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """The ``MTCNN_Dlib_Detection`` contract (MTCNN.hpp:1326-1421): detect
    with the MTCNN cascade, seed each face's 68-point init from its 5 MTCNN
    landmarks, refine with the ERT cascade.

    Returns (boxes [N, 4] x1y1x2y2, landmarks [N, 68, 2] image coords) —
    the reference's (Bounding_Box, LMK) out-params. Without a
    ``detector``, a random-init ``MTCNNDetector`` on ``device`` (``cuda``
    unless given).
    """
    from .landmarks import mtcnn_points_to_xy
    from .pipeline import MTCNNDetector

    detector = detector or MTCNNDetector(device=device)
    img = np.asarray(img)
    boxes, points = detector.detect(img, minsize, thresholds, factor)
    if boxes.shape[0] == 0:
        return (np.zeros((0, 4), np.float32),
                np.zeros((0, predictor.num_points, 2), np.float32))
    gray = img.mean(-1) if img.ndim == 3 else img
    out = np.empty((boxes.shape[0], predictor.num_points, 2), np.float32)
    for i in range(boxes.shape[0]):
        rect = boxes[i, :4]
        five = mtcnn_points_to_xy(points, i)
        init = predictor.init_shape_from_5pt(five, rect)
        out[i] = predictor.predict(gray, rect, init)
    return boxes[:, :4].astype(np.float32), out


# ------------------------------------------------------------------ training


def _normalize_shapes(shapes: np.ndarray, rects: np.ndarray) -> np.ndarray:
    wh = np.maximum(rects[:, 2:4] - rects[:, 0:2], 1e-6)
    return (shapes - rects[:, None, 0:2]) / wh[:, None, :]


def _fit_tree(feats, residuals, depth, n_candidates, rng, nu):
    """One greedy regression tree on pixel-difference features.

    feats: [N, P]; residuals: [N, 2L] (updated in place by the returned
    leaf assignment). Returns (idx1, idx2, thresh, leaf_values).
    """
    n_internal = 2 ** depth - 1
    n_leaves = 2 ** depth
    idx1 = np.zeros(n_internal, np.int64)
    idx2 = np.zeros(n_internal, np.int64)
    thresh = np.zeros(n_internal, np.float32)
    leaf_values = np.zeros((n_leaves, residuals.shape[1]), np.float32)

    node_members: dict[int, np.ndarray] = {0: np.arange(feats.shape[0])}
    for node in range(n_internal):
        members = node_members.pop(node, np.empty(0, np.int64))
        best = None
        if members.size >= 2:
            p = feats.shape[1]
            c1 = rng.integers(0, p, n_candidates)
            c2 = rng.integers(0, p, n_candidates)
            diffs = feats[members][:, c1] - feats[members][:, c2]  # [M, C]
            lo, hi = diffs.min(0), diffs.max(0)
            ths = rng.uniform(lo, hi).astype(np.float32)
            r = residuals[members]  # [M, 2L]
            r_sum = r.sum(0)
            r_sq = float((r_sum ** 2).sum())
            for c in range(n_candidates):
                left = diffs[:, c] > ths[c]
                nl = int(left.sum())
                nr = members.size - nl
                if nl == 0 or nr == 0:
                    continue
                sl = r[left].sum(0)
                # split score: variance reduction ∝ |sum_l|²/n_l + |sum_r|²/n_r
                sr = r_sum - sl
                score = (sl @ sl) / nl + (sr @ sr) / nr
                if best is None or score > best[0]:
                    best = (score, c, ths[c], left)
        if best is None:
            # degenerate node: route everything right with an impossible split
            idx1[node] = 0
            idx2[node] = 0
            thresh[node] = np.float32(np.inf)
            left = np.zeros(members.size, bool)
        else:
            _, c, th, left = best
            idx1[node], idx2[node], thresh[node] = c1[c], c2[c], th
        node_members[2 * node + 1] = members[left]
        node_members[2 * node + 2] = members[~left]

    for leaf in range(n_leaves):
        members = node_members.get(n_internal + leaf, np.empty(0, np.int64))
        if members.size:
            value = nu * residuals[members].mean(0)
            leaf_values[leaf] = value
            residuals[members] -= value
    assignment = np.zeros(feats.shape[0], np.int64)
    for leaf in range(n_leaves):
        m = node_members.get(n_internal + leaf)
        if m is not None and m.size:
            assignment[m] = leaf
    return idx1, idx2, thresh, leaf_values, assignment


def _batched_features(pred: ShapePredictor, grays, rects, ex_img, cur,
                      level: CascadeLevel) -> np.ndarray:
    """Feature extraction for every training sample at once: the per-sample
    similarity transforms stay a (cheap, 2x2-SVD) loop so numerics match
    inference exactly, but the pixel GATHER — the hot part at dlib-scale
    settings — vectorizes when all images share a shape."""
    s = cur.shape[0]
    ms = np.stack([similarity_transform(pred.mean_shape, cur[i])
                   for i in range(s)])                  # [S, 2, 3]
    shapes = {g.shape for g in grays}
    if len(shapes) != 1:
        return np.stack([
            pred._features(grays[ex_img[i]], rects[ex_img[i]], cur[i], level)
            for i in range(s)
        ])
    imgs = np.stack([np.asarray(g, np.float32) for g in grays])  # [N, H, W]
    h_img, w_img = imgs.shape[1:3]
    # pts[s] = cur[s][anchors] + deltas @ rot[s]^T  (ShapePredictor._features)
    pts = cur[:, level.anchors] + np.einsum(
        "pd,sed->spe", level.deltas, ms[:, :, :2])       # [S, P, 2]
    r = rects[ex_img]                                    # [S, 4]
    w = np.maximum(r[:, 2] - r[:, 0], 1e-6)[:, None]
    h = np.maximum(r[:, 3] - r[:, 1], 1e-6)[:, None]
    xs = np.clip((pts[:, :, 0] * w + r[:, 0:1]).astype(np.int64), 0,
                 w_img - 1)
    ys = np.clip((pts[:, :, 1] * h + r[:, 1:2]).astype(np.int64), 0,
                 h_img - 1)
    return imgs[ex_img[:, None], ys, xs].astype(np.float32)


def train_shape_predictor(
    images: list[np.ndarray],
    rects: np.ndarray,
    shapes: np.ndarray,
    *,
    cascades: int = 6,
    trees_per_cascade: int = 50,
    tree_depth: int = 3,
    feature_pool: int = 200,
    n_split_candidates: int = 20,
    nu: float = 0.1,
    oversampling: int = 4,
    feature_lambda: float = 0.1,
    seed: int = 0,
) -> ShapePredictor:
    """Gradient-boosted ERT training (Kazemi & Sullivan 2014, dlib's
    shape_predictor_trainer defaults scaled down).

    images: grayscale arrays; rects: [N, 4] x1y1x2y2; shapes: [N, L, 2]
    image-coordinate landmarks.
    """
    rng = np.random.default_rng(seed)
    rects = np.asarray(rects, np.float32)
    shapes = np.asarray(shapes, np.float32)
    targets = _normalize_shapes(shapes, rects)  # [N, L, 2]
    n, num_l = targets.shape[0], targets.shape[1]
    mean_shape = targets.mean(0)

    # oversample: each image contributes `oversampling` training shapes
    # initialized from other examples' ground truth (dlib's init scheme)
    ex_img = np.repeat(np.arange(n), oversampling)
    cur = np.empty((n * oversampling, num_l, 2), np.float32)
    tgt = np.repeat(targets, oversampling, axis=0)
    for i in range(cur.shape[0]):
        j = rng.integers(0, n)
        cur[i] = mean_shape if j == ex_img[i] else targets[j]

    pred = ShapePredictor(mean_shape=mean_shape.astype(np.float32))
    grays = [np.asarray(im).mean(-1) if np.asarray(im).ndim == 3
             else np.asarray(im) for im in images]

    for _ in range(cascades):
        # sample the feature-pixel pool around the mean shape
        pool = rng.uniform(-0.1, 1.1, size=(feature_pool, 2)).astype(
            np.float32)
        # bias toward landmarks (dlib uses an exponential prior): blend each
        # point toward its nearest landmark
        d2 = ((pool[:, None, :] - mean_shape[None]) ** 2).sum(-1)
        anchors = d2.argmin(1).astype(np.int64)
        blend = 1.0 - np.exp(-np.sqrt(d2[np.arange(feature_pool), anchors])
                             / max(feature_lambda, 1e-6))
        pool = (pool * (1 - blend[:, None])
                + mean_shape[anchors] * blend[:, None])
        deltas = (pool - mean_shape[anchors]).astype(np.float32)

        level = CascadeLevel(
            anchors=anchors, deltas=deltas,
            split_idx1=np.zeros((trees_per_cascade, 2 ** tree_depth - 1),
                                np.int64),
            split_idx2=np.zeros((trees_per_cascade, 2 ** tree_depth - 1),
                                np.int64),
            split_thresh=np.zeros((trees_per_cascade, 2 ** tree_depth - 1),
                                  np.float32),
            leaf_values=np.zeros(
                (trees_per_cascade, 2 ** tree_depth, 2 * num_l), np.float32),
        )
        feats = _batched_features(pred, grays, rects, ex_img, cur, level)
        residuals = (tgt - cur).reshape(cur.shape[0], -1).astype(np.float32)
        for k in range(trees_per_cascade):
            i1, i2, th, lv, assign = _fit_tree(
                feats, residuals, tree_depth, n_split_candidates, rng, nu)
            level.split_idx1[k], level.split_idx2[k] = i1, i2
            level.split_thresh[k], level.leaf_values[k] = th, lv
            cur += lv[assign].reshape(cur.shape[0], num_l, 2)
        pred.levels.append(level)
    return pred
