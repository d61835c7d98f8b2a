"""The gallery match, and the device-side gallery matchers (the bulk
complement to the native matcher).

Port of the JAX package's ``serve/gallery.py``. :func:`gallery_match` is
the one match of the port: the serving pipelines, the matchers and
``PersonGalleryService.match_batch`` all run it. For camera-scale galleries
the C++ AVX scan (``serve/native.py``) wins on latency; for bulk
identification (N queries x M gallery rows) one matrix product on the card
wins. Same semantics as ``Compare_Face_From_DB`` (Feature.hpp:295-343):
cosine similarity, NaN-safe, threshold filter, argmax index. On a gallery
sharded by rows each rank scans its block, takes the block's argmax and
the winners are reduced over the ranks (a MAX of the similarity, then a
MIN of the global row among the ranks that hold it: a tie goes to the
smallest row, as the one-card match's first maximum).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distances import (gallery_sims, l2_normalize, l2_normalize_np,
                             narrow_gallery_np)
from ..parallel.collectives import global_argmax
from ..parallel.mesh import axis_group, axis_index, axis_size, make_mesh


def gallery_match(probes: torch.Tensor, gallery_n: torch.Tensor, rows=None,
                  row0: int = 0, group=None):
    """``[..., D]`` normalized probes against ``[G, D]`` stored rows
    (:func:`~..ops.distances.gallery_sims`): the masked cosine argmax over
    the rows. A NaN similarity counts as -2.0; with ``rows`` (an int or a
    0-d tensor), the rows at or past it are -inf, so padding never wins;
    the first maximum wins. With ``group``, ``gallery_n`` is this rank's
    block of a gallery sharded by rows, whose first row is global row
    ``row0``, and the block winners are reduced over ``group``
    (:func:`~..parallel.collectives.global_argmax`). Returns ``(idx, sim,
    real)`` over ``[...]``, ``real`` False where every row is masked (an
    empty gallery)."""
    sims = gallery_sims(probes, gallery_n)
    sims = torch.where(torch.isnan(sims), -2.0, sims)
    if rows is not None:
        cols = torch.arange(sims.shape[-1], device=sims.device)
        sims = torch.where(cols < (rows if group is None else rows - row0),
                           sims, float("-inf"))
    idx = torch.argmax(sims, dim=-1)             # the first maximum, as JAX
    sim = torch.amax(sims, dim=-1)
    if group is not None:
        idx, sim = global_argmax(idx, sim, row0, group)
    return idx, sim, sim > float("-inf")


def normalize_gallery(gallery, dtype=torch.float32, device=None) -> torch.Tensor:
    """Gallery rows -> the L2-normalized ``[G, D]`` tensor the
    ``dynamic_gallery`` pipelines and :func:`make_gallery_matcher` take,
    stored as float32, bfloat16 or int8 on the 127 scale (normalized in
    float32 on the host, narrowed before the upload)."""
    rows = narrow_gallery_np(l2_normalize_np(np.asarray(gallery, np.float32)),
                             dtype)
    return rows.to(resolve_device(device))


def make_gallery_matcher(gallery: np.ndarray, dtype=torch.float32,
                         device=None):
    """Returns a matcher (queries [N, D]) -> (idx [N] int32, sim [N]) on the
    device (``cuda`` unless given). ``dtype=torch.bfloat16`` /
    ``torch.int8`` narrows the stored rows (and the upload), see
    ``ops.distances.gallery_sims`` for the exact schemes."""
    dev = resolve_device(device)
    gallery_n = normalize_gallery(gallery, dtype, dev)

    @torch.inference_mode()
    def match(queries):
        q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        idx, best, _ = gallery_match(l2_normalize(q), gallery_n)
        return idx.to(torch.int32), best

    return match


def match_gallery_tpu(gallery: np.ndarray, queries: np.ndarray,
                      sim_th: float = 0.0, dtype=torch.float32,
                      device=None):
    """One-shot helper: returns (idx [N] with -1 below threshold, sim [N])
    as numpy. The name is the JAX package's; the product runs on
    ``device``."""
    return _on_host(*make_gallery_matcher(gallery, dtype=dtype,
                                          device=device)(queries), sim_th)


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
    if block.shape[0] < shard:
        block = torch.cat([block, block.new_zeros(
            (shard - block.shape[0], block.shape[1]))])

    @torch.inference_mode()
    def match(queries):
        q = l2_normalize(torch.as_tensor(queries, dtype=torch.float32,
                                         device=dev))
        idx, best, _ = gallery_match(q, block, m, row0, group)
        return idx.to(torch.int32), best

    return match


def match_gallery_sharded(gallery: np.ndarray, queries: np.ndarray,
                          sim_th: float = 0.0, mesh=None, device=None):
    """One-shot sharded helper mirroring ``match_gallery_tpu``."""
    return _on_host(*make_sharded_gallery_matcher(gallery, mesh,
                                                  device=device)(queries),
                    sim_th)


def _on_host(idx: torch.Tensor, sim: torch.Tensor, sim_th: float):
    """A matcher's answer as numpy, the index -1 below ``sim_th``."""
    idx = idx.cpu().numpy().astype(np.int64)
    sim = sim.cpu().numpy()
    idx[sim < sim_th] = -1
    return idx, sim
