"""Identity-split feature slicer (reference slice_celeb1m.py + .sh).

Splits a feature store 0.7/0.3 BY IDENTITY (README.md:25) and emits the
CSVIter quartet (train_img.csv/train_id.csv/test_img.csv/test_id.csv,
slice_celeb1m.py:49-80) plus canonical .npz stores.

The port's copy of the JAX package's ``cli/slice_dataset.py``.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--features", required=True, help=".npz feature store")
    p.add_argument("--out-dir", default="sliced")
    p.add_argument("--train-frac", type=float, default=0.7)
    p.add_argument("--shuffle-identities", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..data import load_feature_store, save_feature_store, split_identities
    from ..data.feature_store import export_split_csvs

    feats, labels = load_feature_store(args.features)
    train_mask, test_mask = split_identities(
        labels, args.train_frac,
        seed=args.seed if args.shuffle_identities else None)
    os.makedirs(args.out_dir, exist_ok=True)
    export_split_csvs(args.out_dir, feats, labels, args.train_frac)
    save_feature_store(os.path.join(args.out_dir, "train.npz"),
                       feats[train_mask], labels[train_mask])
    save_feature_store(os.path.join(args.out_dir, "test.npz"),
                       feats[test_mask], labels[test_mask])
    print(f"train rows: {int(train_mask.sum())}, "
          f"test rows: {int(test_mask.sum())} -> {args.out_dir}")


if __name__ == "__main__":
    main()
