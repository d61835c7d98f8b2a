"""Feature store: the CSV formats of the reference + one canonical format.

A numpy copy of the JAX package's ``data/feature_store.py``.

The reference writes L2-normalized feature rows as trailing-comma CSV
(extract_feacture_v2.py:68-79: ``"{},".format(ele)`` per element, newline per
row) with labels in a parallel file, then re-splits identities 0.7/0.3
(slice_celeb1m.py:49-80). The CSVIter trainers read ``train_img.csv`` /
``train_id.csv`` (pre-trained_efm_v3.py:155-156). SURVEY.md §3.3 notes the
reference's own format mismatch between its writer and slicer; this rebuild
defines ONE canonical binary store (.npz) and keeps CSV readers/writers
byte-compatible with the reference layout for interop.
"""

from __future__ import annotations

import os

import numpy as np


def write_feature_csv(path: str, features: np.ndarray) -> None:
    """Reference-compatible feature CSV: comma-separated values with a
    trailing comma per row (extract_feacture_v2.py:70-73)."""
    features = np.asarray(features)
    with open(path, "a+") as f:
        for row in features:
            f.write(",".join(repr(float(v)) for v in row))
            f.write(",\n")


def read_feature_csv(path: str) -> np.ndarray:
    """Read either reference-style (trailing comma) or plain CSV rows."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line:
                continue
            rows.append([float(v) for v in line.split(",")])
    return np.asarray(rows, dtype=np.float32)


def write_labels_csv(path: str, labels: np.ndarray) -> None:
    """One label per line (extract_feacture_v2.py:76-79)."""
    with open(path, "a+") as f:
        for v in np.asarray(labels).ravel():
            f.write(f"{float(v)}\n")


def read_labels_csv(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([float(l) for l in f if l.strip()], dtype=np.float32)


def save_feature_store(path: str, features: np.ndarray, labels: np.ndarray) -> None:
    """Canonical binary store: one .npz with features + labels."""
    np.savez_compressed(path, features=np.asarray(features, np.float32),
                        labels=np.asarray(labels, np.int64))


def load_feature_store(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["features"], z["labels"]


def split_identities(
    labels: np.ndarray,
    train_frac: float = 0.7,
    seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Split by IDENTITY (not by row) into train/test row masks.

    Reference semantics (slice_celeb1m.py:49-80 driven by slice_celeb1m.sh:5,
    README.md:25): the first 70% of identities go to train, the rest to test.
    Pass ``seed`` to shuffle identity order first (the reference keeps
    first-seen order).
    """
    labels = np.asarray(labels).astype(np.int64).ravel()
    # unique in first-seen order
    _, first_pos = np.unique(labels, return_index=True)
    ident = labels[np.sort(first_pos)]
    if seed is not None:
        ident = np.random.default_rng(seed).permutation(ident)
    n_train = int(len(ident) * train_frac)
    train_ids = set(ident[:n_train].tolist())
    train_mask = np.asarray([l in train_ids for l in labels])
    return train_mask, ~train_mask


def export_split_csvs(
    out_dir: str,
    features: np.ndarray,
    labels: np.ndarray,
    train_frac: float = 0.7,
) -> None:
    """Produce the reference CSVIter file quartet (train_img.csv,
    train_id.csv, test_img.csv, test_id.csv; slice_celeb1m.py:49-80)."""
    os.makedirs(out_dir, exist_ok=True)
    train_mask, test_mask = split_identities(labels, train_frac)
    for name, mask in (("train", train_mask), ("test", test_mask)):
        fp = os.path.join(out_dir, f"{name}_img.csv")
        lp = os.path.join(out_dir, f"{name}_id.csv")
        for p in (fp, lp):
            if os.path.exists(p):
                os.remove(p)
        write_feature_csv(fp, features[mask])
        write_labels_csv(lp, labels[mask])
