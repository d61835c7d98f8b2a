#!/usr/bin/env python3
"""How far bf16 moves the LFW cell's random-weight embeddings, against how
far they differ across images, on the plain PyTorch route (CPU, no kernel).

Builds the nets of ``chip_smoke.py``'s lfw phase (LightCNN29 at 128x128
with shared res weights and seeded ``fc1_bn`` statistics, as its export
before the ``.params`` round trip; LightCNN9 at 128x128; random weights
from seed 0) and embeds the first IMAGES pair images of
``chip_smoke.lfw_pairs(seed=0)`` in f32 and in bf16. Prints one JSON line
per model: the median spread ``|e - mean| / |e|`` of the f32 embeddings,
the median bf16 move ``|e_bf16 - e| / |e|``, and the least and median
cosine of bf16 to f32, raw and centered (less the f32 mean: the part that
varies across images). For LightCNN29 also the same bf16 net with a stem
that sums in f32 and rounds once to bf16, as kernel B3 does on the card,
against the plain bf16 net: the centered cosine that a rounding
difference at the stem alone gives.

    python tools/bf16_spread_torch.py [--images 64]
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _exports(tmp: str) -> dict:
    import numpy as np
    import torch

    from chip_smoke import LFW_CLASSES, LFW_SIDE
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        build_lightcnn9,
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        export_model,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.export import (
        export_params,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils.mxnet_import import (
        expand_shared_res,
    )

    hw = (LFW_SIDE, LFW_SIDE)
    rng = np.random.default_rng(0)
    stats = {"fc1_bn": {"mean": rng.normal(0, 0.5, 684).astype(np.float32),
                        "var": rng.uniform(0.5, 2, 684).astype(np.float32)}}
    m29 = model_by_name("lightcnn29", LFW_CLASSES, input_hw=hw,
                        share_weights=True,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    dirs = {"lightcnn29": os.path.join(tmp, "lightcnn29"),
            "lightcnn9": os.path.join(tmp, "lightcnn9")}
    export_params(dirs["lightcnn29"], expand_shared_res(m29.flax_params()),
                  model_name="lightcnn29", feature_dim=684, input_hw=hw,
                  batch_stats=stats)
    export_model(dirs["lightcnn9"], build_lightcnn9(
        LFW_CLASSES, input_hw=hw, generator=torch.Generator().manual_seed(0),
        device="cpu"))
    return dirs


def main(argv=None) -> int:
    import numpy as np
    import torch

    from chip_smoke import LFW_BATCH, _cosines, lfw_pairs
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        lfw_eval,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        lightcnn,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        from_jax_params,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", type=int, default=64)
    args = p.parse_args(argv)
    images = lfw_pairs(seed=0)[0][:args.images]

    def stats(a, b, mean):
        raw, cen = _cosines(a, b), _cosines(a - mean, b - mean)
        return {"cos_min": float(raw.min()),
                "centered_cos_min": float(cen.min()),
                "centered_cos_median": float(np.median(cen))}

    with tempfile.TemporaryDirectory() as tmp:
        for name, export in _exports(tmp).items():
            def embed(dtype):
                net = from_jax_params(export, dtype=dtype, device="cpu")
                return lfw_eval.pair_embeddings(
                    net, images, LFW_BATCH).astype(np.float64)

            f32, bf16 = embed(torch.float32), embed(torch.bfloat16)
            mean, norm = f32.mean(0), np.linalg.norm(f32, axis=1)
            out = {"model": name, "images": int(images.shape[0]),
                   "spread_median": float(np.median(
                       np.linalg.norm(f32 - mean, axis=1) / norm)),
                   "bf16_move_median": float(np.median(
                       np.linalg.norm(bf16 - f32, axis=1) / norm)),
                   "bf16_vs_f32": stats(bf16, f32, mean)}
            if name == "lightcnn29":
                plain = lightcnn.reference_stem
                lightcnn.reference_stem = lambda x, w, b, maxout: plain(
                    x.float(), w.float(), b.float(), maxout=maxout).to(x.dtype)
                try:
                    once = embed(torch.bfloat16)
                finally:
                    lightcnn.reference_stem = plain
                out["stem_rounded_once_vs_bf16"] = stats(once, bf16,
                                                         bf16.mean(0))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
