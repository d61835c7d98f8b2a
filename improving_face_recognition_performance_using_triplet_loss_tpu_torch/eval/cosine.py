"""Cosine-similarity distribution sink + PDF/CDF computation.

A numpy copy of the JAX package's ``eval/cosine.py``.

The reference's primary experiment metric is ``cosine_similarity.csv``: one
space-delimited ``pos_cos neg_cos`` row per example appended every batch
(train_efm.py:250-255, test_efm_v2.py:176-181), consumed by
draw_cos_dis_real.py which keeps the last 1/N of the file (≈ the last epoch),
builds 100-bin histograms, and plots PDF lines plus pos-CDF / 1 - neg-CDF
(draw_cos_dis_real.py:9-34).

Here the per-row values come out of the jitted step as two device arrays per
batch; the sink buffers them on host and writes in large chunks (the
reference re-opened the file and wrote row-by-row every batch — a host hot
loop, SURVEY.md §3.1).
"""

from __future__ import annotations

import os

import numpy as np


class CosineSimilaritySink:
    """Buffered, reference-format-compatible similarity CSV writer."""

    def __init__(self, path: str, flush_every_rows: int = 65536):
        self.path = path
        self.flush_every_rows = flush_every_rows
        self._pos: list[np.ndarray] = []
        self._neg: list[np.ndarray] = []
        self._buffered = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def append(self, pos_cos, neg_cos) -> None:
        pos = np.asarray(pos_cos).ravel()
        neg = np.asarray(neg_cos).ravel()
        if pos.shape != neg.shape:
            raise ValueError("pos/neg length mismatch")
        self._pos.append(pos)
        self._neg.append(neg)
        self._buffered += pos.size
        if self._buffered >= self.flush_every_rows:
            self.flush()

    def flush(self) -> None:
        if not self._pos:
            return
        pos = np.concatenate(self._pos)
        neg = np.concatenate(self._neg)
        with open(self.path, "a+") as f:
            f.write("\n".join(f"{p} {n}" for p, n in zip(pos, neg)))
            f.write("\n")
        self._pos, self._neg, self._buffered = [], [], 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        return False


def read_similarity_csv(path: str, desire_epoch: int = 1):
    """Read the last ``1/desire_epoch`` fraction of rows — the reference's
    exact ``i > len - len/desire_epoch`` slice (draw_cos_dis_real.py:16-21),
    including its off-by-one: at ``desire_epoch=1`` the cutoff is 0, so the
    FIRST row is skipped."""
    with open(path) as f:
        data = [l for l in f if l.strip()]
    pos, neg = [], []
    cutoff = len(data) - int(len(data) / desire_epoch)
    for i, line in enumerate(data):
        if i > cutoff:
            a, b = line.split(" ")[:2]
            pos.append(float(a))
            neg.append(float(b))
    return np.asarray(pos), np.asarray(neg)


def pdf_cdf(pos: np.ndarray, neg: np.ndarray, bins: int = 100):
    """100-bin histogram PDF + cumulative curves (draw_cos_dis_real.py:23-34).

    Returns (pos_pdf, neg_pdf, pos_cdf, neg_inv_cdf, pos_bins, neg_bins) with
    ``neg_inv_cdf = 1 - cumsum(neg_pdf)`` exactly as the reference plots.
    """
    pos_count, pos_bins = np.histogram(np.asarray(pos, np.float64), bins=bins)
    neg_count, neg_bins = np.histogram(np.asarray(neg, np.float64), bins=bins)
    pos_pdf = pos_count / max(pos_count.sum(), 1)
    neg_pdf = neg_count / max(neg_count.sum(), 1)
    pos_cdf = np.cumsum(pos_pdf)
    neg_inv_cdf = 1.0 - np.cumsum(neg_pdf)
    return pos_pdf, neg_pdf, pos_cdf, neg_inv_cdf, pos_bins, neg_bins


def separation_score(pos: np.ndarray, neg: np.ndarray) -> float:
    """Scalar summary of distribution separation: P(pos > neg) over random
    pairs, computed exactly via sorted ranks (AUC). Not in the reference —
    used by the benchmarks to track the thesis's qualitative 'separated
    distributions' goal numerically."""
    pos = np.sort(np.asarray(pos))
    neg = np.sort(np.asarray(neg))
    idx = np.searchsorted(neg, pos, side="left")
    return float(idx.sum()) / (len(pos) * len(neg)) if len(pos) and len(neg) else 0.0
