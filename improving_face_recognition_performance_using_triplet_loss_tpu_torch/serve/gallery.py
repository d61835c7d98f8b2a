"""Device-side gallery matcher (the bulk complement to the native matcher).

Port of the JAX package's ``serve/gallery.py``. For camera-scale galleries
the C++ AVX scan (``serve/native.py``) wins on latency; for bulk
identification (N queries x M gallery rows) one matrix product on the card
wins. Same semantics as ``Compare_Face_From_DB`` (Feature.hpp:295-343):
cosine similarity, NaN-safe, threshold filter, argmax index. The sharded matcher
(``make_sharded_gallery_matcher``) holds a block of the gallery rows on
each rank of a mesh, takes each block's argmax there and reduces the
winners over the ranks (a MAX of the similarity, then a MIN of the
global row among the ranks that hold it: a tie goes to the smallest
row, as the one-card matcher's first maximum).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distances import (gallery_sims, l2_normalize, l2_normalize_np,
                             narrow_gallery_np)
from ..parallel.collectives import global_argmax
from ..parallel.mesh import axis_group, axis_index, axis_size, make_mesh


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


def make_sharded_gallery_matcher(gallery: np.ndarray, mesh=None,
                                 device=None):
    """Gallery rows sharded over the ranks of ``mesh``'s first axis (a
    1-D mesh over the world by default): each rank holds ``ceil(M / k)``
    rows, normalized on its device (the last block padded with rows that
    can never win), scans its block and the winners are reduced over the
    ranks. Returns ``(queries [N, D]) -> (global idx [N] int32, sim [N])``,
    the same on every rank and per query as ``make_gallery_matcher``."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh(device=dev)
    axis = mesh.mesh_dim_names[0]
    k, i = axis_size(mesh, axis), axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    gallery = np.asarray(gallery, np.float32)
    m = gallery.shape[0]
    shard = -(-m // k)
    row0 = i * shard
    block = l2_normalize(torch.as_tensor(gallery[row0:row0 + shard],
                                         device=dev))
    valid = row0 + torch.arange(shard, device=dev) < m
    if block.shape[0] < shard:
        block = torch.cat([block, block.new_zeros(
            (shard - block.shape[0], block.shape[1]))])

    @torch.inference_mode()
    def match(queries):
        q = l2_normalize(torch.as_tensor(queries, dtype=torch.float32,
                                         device=dev))
        sims = q @ block.T                                    # [N, shard]
        sims = torch.where(torch.isnan(sims), -2.0, sims)
        sims = torch.where(valid, sims, float("-inf"))
        loc = torch.argmax(sims, dim=-1)
        idx, best = global_argmax(
            loc, torch.gather(sims, -1, loc[:, None])[:, 0], row0, group)
        return idx.to(torch.int32), best

    return match


def match_gallery_sharded(gallery: np.ndarray, queries: np.ndarray,
                          sim_th: float = 0.0, mesh=None, device=None):
    """One-shot sharded helper mirroring ``match_gallery_tpu``."""
    idx, sim = make_sharded_gallery_matcher(gallery, mesh,
                                            device=device)(queries)
    idx = idx.cpu().numpy().astype(np.int64)
    sim = sim.cpu().numpy()
    idx[sim < sim_th] = -1
    return idx, sim
