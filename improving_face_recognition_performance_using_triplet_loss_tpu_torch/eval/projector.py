"""Embedding-projector export (reference C13, efm_symbol.py:243-257).

The reference wrote TF1 checkpoint + ``metadata.tsv`` for the TensorBoard
embedding projector. TF1's API is dead; the portable equivalent is the TSV
pair (``vectors.tsv`` + ``metadata.tsv``) that both TensorBoard and
projector.tensorflow.org load directly — same before/after-triplet visual,
no TF dependency.

A copy of the JAX package's ``eval/projector.py`` (numpy only): both
packages write the same bytes.
"""

from __future__ import annotations

import os

import numpy as np


def export_projector(embeddings: np.ndarray, labels: np.ndarray,
                     log_dir: str, names: list[str] | None = None) -> str:
    """Write vectors.tsv + metadata.tsv under ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    embeddings = np.asarray(embeddings)
    labels = np.asarray(labels).ravel()
    with open(os.path.join(log_dir, "vectors.tsv"), "w") as f:
        for row in embeddings:
            f.write("\t".join(f"{v:.6g}" for v in row) + "\n")
    with open(os.path.join(log_dir, "metadata.tsv"), "w") as f:
        for lab in labels:
            f.write((names[int(lab)] if names else f"{int(lab)}") + "\n")
    return log_dir


def load_projector(log_dir: str):
    vectors = np.loadtxt(os.path.join(log_dir, "vectors.tsv"),
                         delimiter="\t", ndmin=2)
    with open(os.path.join(log_dir, "metadata.tsv")) as f:
        metadata = [l.strip() for l in f if l.strip()]
    return vectors, metadata
