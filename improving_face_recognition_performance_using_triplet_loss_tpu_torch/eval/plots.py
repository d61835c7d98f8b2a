"""Matplotlib artifact plots (reference C10 + draw_figure helpers).

A copy of the JAX package's ``eval/plots.py``. matplotlib is imported
only when a figure is drawn, so the rest of the port runs without it.

Mirrors draw_cos_dis_real.py:37-56 (PDF + CDF side-by-side jpg) and the
accuracy/loss-vs-epoch figures (train_efm.py:119-129, final_efm.py:118-128 —
note the reference's final_efm draw_figure plots the wrong variables, a
defect not replicated; SURVEY.md §2.3).
"""

from __future__ import annotations

import numpy as np

from .cosine import pdf_cdf


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_similarity_figures(pos, neg, out_path: str = "cosine_similarity_cdf.jpg",
                            bins: int = 100) -> str:
    """PDF + CDF panel, reference layout (draw_cos_dis_real.py:37-56)."""
    plt = _plt()
    pos_pdf, neg_pdf, pos_cdf, neg_inv_cdf, pos_bins, neg_bins = pdf_cdf(
        pos, neg, bins=bins)
    fig = plt.figure(figsize=(10, 4))
    ax = fig.add_subplot(1, 2, 1)
    ax.set_xlabel("cosine similarity")
    ax.set_ylim(0, max(0.2, float(max(pos_pdf.max(), neg_pdf.max())) * 1.1))
    ax.set_xlim(-1, 1)
    ax.plot(pos_bins[1:], pos_pdf, color="red", label="pos distance")
    ax.plot(neg_bins[1:], neg_pdf, label="neg distance")
    ax.legend()
    ax = fig.add_subplot(1, 2, 2)
    ax.set_title("CDF")
    ax.set_xlabel("cosine similarity")
    ax.set_ylim(0, 1)
    ax.set_xlim(-1, 1)
    ax.plot(pos_bins[1:], pos_cdf, color="red", label="pos cdf")
    ax.plot(neg_bins[1:], neg_inv_cdf, label="neg cdf")
    ax.legend()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def draw_curve(values_by_series: dict[str, list[float]], ylabel: str,
               out_path: str, title: str | None = None) -> str:
    """Per-epoch curve figure (train_acc.jpg / train_loss.jpg equivalents)."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.set_xlabel("epoch")
    ax.set_ylabel(ylabel)
    ax.set_title(title or f"{ylabel} of each epoch")
    ax.grid(True)
    colors = ["r-", "b-", "g-", "k-"]
    for (name, vals), c in zip(values_by_series.items(), colors):
        ax.plot(np.arange(len(vals)), vals, c, label=name)
    ax.legend()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
