"""Cosine-similarity distribution plotter (reference draw_cos_dis_real.py).

Reads cosine_similarity.csv (space-delimited pos/neg rows), keeps the last
1/desire_epoch of rows, and renders the PDF + CDF panel jpg.

The port's copy of the JAX package's ``cli/draw_cos.py``.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--csv", default="cosine_similarity.csv")
    p.add_argument("--desire-epoch", type=int, default=5,
                   help="keep last 1/N rows (draw_cos_dis_real.py:61)")
    p.add_argument("--out", default="cosine_similarity_cdf.jpg")
    p.add_argument("--bins", type=int, default=100)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..eval.cosine import read_similarity_csv, separation_score
    from ..eval.plots import draw_similarity_figures

    import os

    if not os.path.exists(args.csv):
        raise SystemExit(f"similarity csv not found: {args.csv}")
    pos, neg = read_similarity_csv(args.csv, desire_epoch=args.desire_epoch)
    out = draw_similarity_figures(pos, neg, args.out, bins=args.bins)
    print(f"wrote {out}; separation AUC = {separation_score(pos, neg):.4f} "
          f"({len(pos)} rows)")
    return out


if __name__ == "__main__":
    main()
