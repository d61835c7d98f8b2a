"""No-training cosine-distance measurement (reference test_efm_v2.py).

The port's ``eval_cos``: loads a feature store, L2-normalizes rows, pairs
anchors with canonical positives and uniform random different-label
negatives, and appends the per-row cosine similarities to
``cosine_similarity.csv``. Runs on ``cuda`` unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--features", help=".npz feature store")
    p.add_argument("--train-img-csv")
    p.add_argument("--train-id-csv")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out-dir", default="runs/eval_cos")
    p.add_argument("--batch-size", type=int, default=16384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None):
    """Returns the ``(pos_cos, neg_cos)`` arrays of every row."""
    args = build_parser().parse_args(argv)
    from ..data import PairBatcher
    from ..device import full_f32, resolve_device
    from ..eval.cosine import CosineSimilaritySink, separation_score
    from ..models.heads import LinearHead
    from ..train import create_train_state, make_head_eval_step, sgd_wd
    from ._common import log_config, setup_logging
    from .train_head import load_features

    full_f32()
    device = resolve_device(args.device)
    log = setup_logging(os.path.join(args.out_dir, "log"), "eval_cos")
    log_config(log, args)
    feats, labels = load_features(args)
    batch = min(args.batch_size, feats.shape[0])

    # identity "head": outputs are the normalized inputs
    d = feats.shape[1]
    model = LinearHead(d, d).load_flax_params(
        {"proj": {"kernel": np.eye(d, dtype=np.float32)}}).to(device)
    state = create_train_state(model, sgd_wd(), args.seed)
    step = make_head_eval_step(normalize_inputs=True)

    sink = CosineSimilaritySink(
        os.path.join(args.out_dir, "cosine_similarity.csv"))
    batcher = PairBatcher(feats, labels, batch, shuffle=False)
    all_pos, all_neg = [], []
    with sink:
        for anchor, positive, lab in batcher:
            m = step(state, anchor, positive, lab)
            pos, neg = m["pos_cos"].cpu().numpy(), m["neg_cos"].cpu().numpy()
            sink.append(pos, neg)
            all_pos.append(pos)
            all_neg.append(neg)
    pos = np.concatenate(all_pos) if all_pos else np.zeros(0)
    neg = np.concatenate(all_neg) if all_neg else np.zeros(0)
    log.info("rows=%d mean_pos=%.4f mean_neg=%.4f separation=%.4f",
             len(pos), pos.mean() if len(pos) else 0,
             neg.mean() if len(neg) else 0, separation_score(pos, neg))
    return pos, neg


if __name__ == "__main__":
    main()
