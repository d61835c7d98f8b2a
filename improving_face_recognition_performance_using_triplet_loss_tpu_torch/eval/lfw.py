"""LFW 10-fold verification protocol (reference facenet.py:412-520 semantics).

Implements ``distance`` (squared-L2 and arccos-cosine metrics),
``calculate_roc`` (per-fold best-threshold accuracy), and ``calculate_val``
(VAL @ FAR target with slinear threshold interpolation) with the exact
reference semantics — including the non-shuffled contiguous K-fold split —
so accuracies are comparable to numbers produced by the facenet evaluator.

This is the harness that generates the repo's LFW baseline numbers
(BASELINE.md: the reference publishes none). A line-for-line copy of the
JAX package's ``eval/lfw.py`` (numpy only): the port imports nothing of
that package, and both must score the same embeddings identically.
"""

from __future__ import annotations

import math
import warnings

import numpy as np


def distance(embeddings1: np.ndarray, embeddings2: np.ndarray,
             distance_metric: int = 0) -> np.ndarray:
    """Pair distances: 0 = squared euclidean, 1 = arccos(cos)/pi
    (facenet.py:412-426)."""
    if distance_metric == 0:
        diff = np.subtract(embeddings1, embeddings2)
        return np.sum(np.square(diff), 1)
    if distance_metric == 1:
        dot = np.sum(np.multiply(embeddings1, embeddings2), axis=1)
        norm = (np.linalg.norm(embeddings1, axis=1)
                * np.linalg.norm(embeddings2, axis=1))
        similarity = np.clip(dot / norm, -1.0, 1.0)
        return np.arccos(similarity) / math.pi
    raise ValueError(f"Undefined distance metric {distance_metric}")


def kfold_indices(n: int, n_folds: int):
    """Contiguous, unshuffled K-fold (sklearn KFold(shuffle=False) semantics,
    as used at facenet.py:433)."""
    fold_sizes = np.full(n_folds, n // n_folds, dtype=np.int64)
    fold_sizes[: n % n_folds] += 1
    indices = np.arange(n)
    current = 0
    for size in fold_sizes:
        test = indices[current:current + size]
        train = np.concatenate([indices[:current], indices[current + size:]])
        current += size
        yield train, test


def calculate_accuracy(threshold: float, dist: np.ndarray,
                       actual_issame: np.ndarray):
    """(tpr, fpr, acc) at a threshold (facenet.py:461-471)."""
    predict = np.less(dist, threshold)
    tp = np.sum(np.logical_and(predict, actual_issame))
    fp = np.sum(np.logical_and(predict, np.logical_not(actual_issame)))
    tn = np.sum(np.logical_and(np.logical_not(predict),
                               np.logical_not(actual_issame)))
    fn = np.sum(np.logical_and(np.logical_not(predict), actual_issame))
    tpr = 0.0 if (tp + fn == 0) else float(tp) / float(tp + fn)
    fpr = 0.0 if (fp + tn == 0) else float(fp) / float(fp + tn)
    acc = float(tp + tn) / dist.size
    return tpr, fpr, acc


def calculate_val_far(threshold: float, dist: np.ndarray,
                      actual_issame: np.ndarray):
    """(VAL, FAR) at a threshold (facenet.py:512-520)."""
    predict = np.less(dist, threshold)
    true_accept = np.sum(np.logical_and(predict, actual_issame))
    false_accept = np.sum(np.logical_and(predict,
                                         np.logical_not(actual_issame)))
    n_same = np.sum(actual_issame)
    n_diff = np.sum(np.logical_not(actual_issame))
    val = float(true_accept) / max(float(n_same), 1.0)
    far = float(false_accept) / max(float(n_diff), 1.0)
    return val, far


def calculate_roc(thresholds, embeddings1, embeddings2, actual_issame,
                  nrof_folds: int = 10, distance_metric: int = 0,
                  subtract_mean: bool = False):
    """Per-fold best-threshold protocol (facenet.py:428-459).

    Returns (tpr[nthr], fpr[nthr], accuracy[folds]).
    """
    assert embeddings1.shape == embeddings2.shape
    actual_issame = np.asarray(actual_issame, bool)
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    nrof_thresholds = len(thresholds)
    tprs = np.zeros((nrof_folds, nrof_thresholds))
    fprs = np.zeros((nrof_folds, nrof_thresholds))
    accuracy = np.zeros(nrof_folds)

    for fold_idx, (train_set, test_set) in enumerate(
            kfold_indices(nrof_pairs, nrof_folds)):
        if subtract_mean:
            mean = np.mean(np.concatenate([embeddings1[train_set],
                                           embeddings2[train_set]]), axis=0)
        else:
            mean = 0.0
        dist = distance(embeddings1 - mean, embeddings2 - mean,
                        distance_metric)
        acc_train = np.zeros(nrof_thresholds)
        for ti, threshold in enumerate(thresholds):
            _, _, acc_train[ti] = calculate_accuracy(
                threshold, dist[train_set], actual_issame[train_set])
        best = int(np.argmax(acc_train))
        for ti, threshold in enumerate(thresholds):
            tprs[fold_idx, ti], fprs[fold_idx, ti], _ = calculate_accuracy(
                threshold, dist[test_set], actual_issame[test_set])
        _, _, accuracy[fold_idx] = calculate_accuracy(
            thresholds[best], dist[test_set], actual_issame[test_set])
    return np.mean(tprs, 0), np.mean(fprs, 0), accuracy


def calculate_val(thresholds, embeddings1, embeddings2, actual_issame,
                  far_target: float = 1e-3, nrof_folds: int = 10,
                  distance_metric: int = 0, subtract_mean: bool = False):
    """VAL @ FAR=target with per-fold threshold interpolation
    (facenet.py:475-509). Returns (val_mean, val_std, far_mean)."""
    actual_issame = np.asarray(actual_issame, bool)
    nrof_pairs = min(len(actual_issame), embeddings1.shape[0])
    nrof_thresholds = len(thresholds)
    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)

    for fold_idx, (train_set, test_set) in enumerate(
            kfold_indices(nrof_pairs, nrof_folds)):
        if subtract_mean:
            mean = np.mean(np.concatenate([embeddings1[train_set],
                                           embeddings2[train_set]]), axis=0)
        else:
            mean = 0.0
        dist = distance(embeddings1 - mean, embeddings2 - mean,
                        distance_metric)
        far_train = np.zeros(nrof_thresholds)
        for ti, threshold in enumerate(thresholds):
            _, far_train[ti] = calculate_val_far(
                threshold, dist[train_set], actual_issame[train_set])
        if np.max(far_train) >= far_target:
            # slinear interpolation of threshold(far), facenet.py:499-500
            threshold = float(np.interp(far_target, far_train, thresholds))
        else:
            # the reference falls back silently (facenet.py:501); on a tiny
            # gallery FAR may never reach the target and VAL=0 looks like a
            # model failure rather than a protocol artifact — warn loudly
            warnings.warn(
                f"calculate_val fold {fold_idx}: FAR never reached the "
                f"target {far_target:g} on the train split (max "
                f"{np.max(far_train):g}) — falling back to threshold 0.0, "
                "which forces VAL=0 for this fold. The pair set is likely "
                "too small for this FAR target.",
                stacklevel=2)
            threshold = 0.0
        val[fold_idx], far[fold_idx] = calculate_val_far(
            threshold, dist[test_set], actual_issame[test_set])
    return float(np.mean(val)), float(np.std(val)), float(np.mean(far))


def evaluate(embeddings1, embeddings2, actual_issame, nrof_folds: int = 10,
             distance_metric: int = 0, subtract_mean: bool = False,
             far_target: float = 1e-3):
    """Full LFW evaluation: (tpr, fpr, acc_mean, acc_std, val, val_std, far).

    Threshold grids match the facenet evaluator's conventions
    (0..4 step .01 for ROC; 0..4 step .001 for VAL with metric 0;
    0..1 ranges arccos-cosine metric since it is bounded by 1)."""
    hi = 4 if distance_metric == 0 else 1
    thr_roc = np.arange(0, hi, 0.01 * hi / 4)
    thr_val = np.arange(0, hi, 0.001 * hi / 4)
    tpr, fpr, accuracy = calculate_roc(
        thr_roc, embeddings1, embeddings2, actual_issame,
        nrof_folds=nrof_folds, distance_metric=distance_metric,
        subtract_mean=subtract_mean)
    val, val_std, far = calculate_val(
        thr_val, embeddings1, embeddings2, actual_issame,
        far_target=far_target, nrof_folds=nrof_folds,
        distance_metric=distance_metric, subtract_mean=subtract_mean)
    return (tpr, fpr, float(np.mean(accuracy)), float(np.std(accuracy)),
            val, val_std, far)
