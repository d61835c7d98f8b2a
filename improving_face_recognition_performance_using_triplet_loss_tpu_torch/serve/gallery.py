"""Device-side gallery matcher (the bulk complement to the native matcher).

Port of the JAX package's ``serve/gallery.py``. For camera-scale galleries
the C++ AVX scan (``serve/native.py``) wins on latency; for bulk
identification (N queries x M gallery rows) one matrix product on the card
wins. Same semantics as ``Compare_Face_From_DB`` (Feature.hpp:295-343):
cosine similarity, NaN-safe, threshold filter, argmax index. The
mesh-sharded matchers are not ported (ROADMAP.md queue A, item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distances import (gallery_sims, l2_normalize, l2_normalize_np,
                             narrow_gallery_np)

_SHARDED = ("the mesh-sharded gallery matchers are not ported; queued in "
            "ROADMAP.md queue A, item 10")


def make_gallery_matcher(gallery: np.ndarray, dtype=torch.float32,
                         device=None):
    """Returns a matcher (queries [N, D]) -> (idx [N] int32, sim [N]) on the
    device (``cuda`` unless given). ``dtype=torch.bfloat16`` /
    ``torch.int8`` narrows the stored rows (and the upload), see
    ``ops.distances.gallery_sims`` for the exact schemes."""
    dev = resolve_device(device)
    gallery_n = narrow_gallery_np(
        l2_normalize_np(np.asarray(gallery, np.float32)), dtype).to(dev)

    @torch.inference_mode()
    def match(queries):
        q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        sims = gallery_sims(l2_normalize(q), gallery_n)          # [N, M]
        sims = torch.where(torch.isnan(sims), -2.0, sims)
        idx = torch.argmax(sims, dim=-1)         # the first maximum, as JAX
        best = torch.gather(sims, -1, idx[:, None])[:, 0]
        return idx.to(torch.int32), best

    return match


def match_gallery_tpu(gallery: np.ndarray, queries: np.ndarray,
                      sim_th: float = 0.0, dtype=torch.float32,
                      device=None):
    """One-shot helper: returns (idx [N] with -1 below threshold, sim [N])
    as numpy. The name is the JAX package's; the product runs on
    ``device``."""
    idx, sim = make_gallery_matcher(gallery, dtype=dtype,
                                    device=device)(queries)
    idx = idx.cpu().numpy().astype(np.int64)
    sim = sim.cpu().numpy()
    idx[sim < sim_th] = -1
    return idx, sim


def make_sharded_gallery_matcher(gallery: np.ndarray, mesh=None):
    raise NotImplementedError(_SHARDED)


def match_gallery_sharded(gallery: np.ndarray, queries: np.ndarray,
                          sim_th: float = 0.0, mesh=None):
    raise NotImplementedError(_SHARDED)
