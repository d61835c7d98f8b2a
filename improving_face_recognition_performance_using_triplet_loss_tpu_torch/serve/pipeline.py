"""The fused recognition pipeline: detect -> crop -> embed -> match.

Port of the JAX package's ``serve/pipeline.py`` single-frame and
multi-stream pipelines: the MTCNN cascade, the largest-centered face, its
margin crop resized to the embedding input in grayscale, the embedding net,
L2 normalization and the cosine gallery argmax, for a batch of frames at
once. The JAX package compiles this into one XLA program and ``vmap``-s it
over streams; here each stage runs eagerly over the frame axis, and the
kernels of the path (NMS, the fused stem, EFM3) launch once per stage for
all frames. ``int8_embed=True`` runs the embedding net (never MTCNN) on
the int8 conv route of ``ops/quantized.py`` with one activation scale a
frame: the JAX package embeds each frame's crops (one, or ``max_faces``
with the empty slots) in its own call under ``vmap``. The mesh-sharded
pipelines split the frames over a mesh's ranks
(:func:`make_sharded_multistream_pipeline`) or the gallery's rows as well
(:func:`shard_gallery`, :func:`make_gallery_sharded_multistream_pipeline`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..detect.device_cascade import crop_resize_boxes, make_device_cascade
from ..device import resolve_device
from ..models.mtcnn import conv_route
from ..ops.boxes import stable_topk
from ..ops.distances import (gallery_sims, l2_normalize, l2_normalize_np,
                             narrow_gallery_np)
from ..ops.quantized import Int8ConvRoute
from ..parallel.collectives import gather_rows, global_argmax
from ..parallel.mesh import axis_group, axis_index, axis_size, local_block
# the device cascade's output capacity: the most faces a frame can yield
MAX_FACES = 64


def _match_gallery(sims: torch.Tensor, rows=None):
    """Masked cosine argmax over the last (gallery) axis. NaNs map to -2.0;
    with ``rows``, columns >= rows are -inf so padding never wins. Returns
    ``(idx, sim, real)``, ``real`` False where every column is masked."""
    sims = torch.where(torch.isnan(sims), -2.0, sims)
    if rows is not None:
        cols = torch.arange(sims.shape[-1], device=sims.device)
        sims = torch.where(cols < rows, sims, float("-inf"))
    idx = torch.argmax(sims, dim=-1)         # the first maximum, as in JAX
    sim = torch.amax(sims, dim=-1)
    return idx, sim, sim > float("-inf")


def _embed_fn(embed_model, int8_embed: bool):
    """``fn(x [F*K, S, S, 1], frames=F) -> features``: the embedding net,
    on the int8 conv route with one activation scale a frame when
    ``int8_embed`` (a route for each frame count, kept across calls)."""
    routes: dict[int, Int8ConvRoute] = {}

    def embed(x: torch.Tensor, frames: int):
        if not int8_embed:
            return embed_model(x)[1]
        if frames not in routes:
            routes[frames] = Int8ConvRoute(groups=frames)
        route = routes[frames]
        with conv_route(route):
            return embed_model(x)[1]

    return embed


def _make_detect_embed(detector, embed_model, *, frame_h, frame_w,
                       embed_size, margin, minsize, thresholds, device,
                       int8_embed=False):
    """The gallery-independent front: cascade -> largest-centered face ->
    margin crop -> grayscale resize -> embed -> L2 norm, over a batch of
    frames. Returns fn(frames [F, H, W, 3]) -> (found [F], box [F, 4],
    score [F], emb [F, D], cap_dropped [F])."""
    cascade = make_device_cascade(
        detector.pnet, detector.rnet, detector.onet, frame_h, frame_w,
        minsize=minsize, thresholds=thresholds, device=device)
    embed = _embed_fn(embed_model, int8_embed)
    half = margin / 2

    def detect_embed(frames: torch.Tensor):
        boxes, _, counts = cascade(frames)                 # [F, cap, 5]
        valid = torch.isfinite(boxes[..., 4])
        found = valid.any(-1)
        # largest-centered selection (area - 2 * center offset^2)
        area = ((boxes[..., 2] - boxes[..., 0])
                * (boxes[..., 3] - boxes[..., 1]))
        cx = (boxes[..., 0] + boxes[..., 2]) * 0.5 - frame_w / 2.0
        cy = (boxes[..., 1] + boxes[..., 3]) * 0.5 - frame_h / 2.0
        rank = torch.where(valid, area - 2.0 * (cx * cx + cy * cy),
                           float("-inf"))
        best = torch.argmax(rank, dim=-1)
        sel = torch.gather(boxes, 1, best[:, None, None].expand(-1, 1, 5))[:, 0]
        # margin pad + clip (crop_face semantics)
        box = torch.stack([
            torch.clamp(sel[:, 0] - half, min=0.0),
            torch.clamp(sel[:, 1] - half, min=0.0),
            torch.clamp(sel[:, 2] + half, max=float(frame_w)),
            torch.clamp(sel[:, 3] + half, max=float(frame_h)),
        ], dim=-1)
        crop = crop_resize_boxes(frames, box[:, None], embed_size)[:, 0]
        gray = crop.mean(dim=-1, keepdim=True) / 255.0
        emb = l2_normalize(embed(gray, frames.shape[0]))
        cap_dropped = counts[:, 0] + counts[:, 1] + counts[:, 2]
        return found, box, sel[:, 4], emb, cap_dropped

    return detect_embed


def make_multistream_pipeline(detector, embed_model, gallery=None, *,
                              frame_h: int, frame_w: int,
                              embed_size: int = 128, margin: int = 16,
                              minsize: int = 20, thresholds=(0.6, 0.7, 0.7),
                              sim_threshold: float = 0.5,
                              dynamic_gallery: bool = False,
                              max_faces: int = 0, int8_embed: bool = False,
                              device=None):
    """Identify the best face in every frame of a same-shape batch
    ``[N, frame_h, frame_w, 3]`` (0-255).

    ``detector`` is an ``MTCNNDetector`` and ``embed_model`` an embedding
    net (``EFMNet342``), both on ``device`` (``cuda`` unless given).
    Returns fn(frames) -> dict with a leading N axis on ``found``, ``box``
    [N, 4], ``score``, ``index`` (gallery row, -1 below ``sim_threshold``),
    ``similarity``, ``embedding`` [N, D] and ``cap_dropped``.

    ``dynamic_gallery=True`` returns fn(frames, gallery_n[, rows]) instead,
    with the L2-normalized gallery (:func:`normalize_gallery`) passed at
    call time; columns >= ``rows`` are masked out of the argmax.

    ``max_faces`` > 0 runs :func:`make_multiface_pipeline` over the batch
    instead: every field gains a leading N axis over its per-face arrays."""
    if max_faces:
        return _make_multiface_batched(
            detector, embed_model, gallery, frame_h=frame_h,
            frame_w=frame_w, embed_size=embed_size, margin=margin,
            minsize=minsize, thresholds=thresholds,
            sim_threshold=sim_threshold, max_faces=max_faces,
            int8_embed=int8_embed, dynamic_gallery=dynamic_gallery,
            device=device)
    dev = resolve_device(device)
    detect_embed = _make_detect_embed(
        detector, embed_model, frame_h=frame_h, frame_w=frame_w,
        embed_size=embed_size, margin=margin, minsize=minsize,
        thresholds=thresholds, device=dev, int8_embed=int8_embed)
    baked = None if dynamic_gallery else l2_normalize(
        torch.as_tensor(np.asarray(gallery, np.float32), device=dev))

    @torch.inference_mode()
    def pipeline(frames, gallery_n=baked, rows=None):
        frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        found, box, score, emb, cap_dropped = detect_embed(frames)
        idx, sim, real = _match_gallery(gallery_sims(emb, gallery_n), rows)
        matched = found & real & (sim >= sim_threshold)
        return {
            "found": found,
            "box": box,
            "score": score,
            "index": torch.where(matched, idx, -1).to(torch.int32),
            "similarity": torch.where(found & real, sim, -2.0),
            "embedding": emb,
            "cap_dropped": cap_dropped,
        }

    return pipeline


def _single(multi):
    """A batched pipeline as fn(frame [H, W, 3], *gallery args) -> its dict
    without the leading axis."""

    def pipeline(frame, *args):
        frame = torch.as_tensor(frame, dtype=torch.float32)
        out = multi(frame[None], *args)
        return {k: v[0] for k, v in out.items()}

    return pipeline


def make_recognition_pipeline(detector, embed_model, gallery=None, **kwargs):
    """The single-frame pipeline: fn(frame [H, W, 3]) -> the
    :func:`make_multistream_pipeline` dict without the leading axis (with
    ``dynamic_gallery=True``: fn(frame, gallery_n[, rows]))."""
    return _single(make_multistream_pipeline(detector, embed_model, gallery,
                                             **kwargs))


def make_multiface_pipeline(detector, embed_model, gallery=None, **kwargs):
    """Identify every detected face of a frame: the top-``max_faces``
    detections (by score, ties to the lower row as ``lax.top_k``) are
    margin-cropped and resized as one batch, embedded as one batch and
    matched with one gallery product.

    Returns fn(frame [H, W, 3]) -> dict of per-face arrays (length
    ``max_faces``): ``found`` (bool mask), ``boxes`` [K, 4], ``scores``,
    ``indices`` (gallery row, -1 below threshold or not found),
    ``similarities``, ``embeddings`` [K, D], plus the scalars
    ``cap_dropped`` (the cascade's capacity drops) and ``topk_dropped``
    (valid detections beyond ``max_faces``). ``dynamic_gallery=True``:
    fn(frame, gallery_n[, rows]). Takes :func:`_make_multiface_batched`'s
    keywords (``frame_h``, ``frame_w``, ``embed_size``, ``margin``,
    ``minsize``, ``thresholds``, ``sim_threshold``, ``max_faces`` = 8,
    ``int8_embed``, ``dynamic_gallery``, ``device``)."""
    return _single(_make_multiface_batched(detector, embed_model, gallery,
                                           **kwargs))


def _make_multiface_batched(detector, embed_model, gallery=None, *,
                            frame_h: int, frame_w: int, embed_size: int = 128,
                            margin: int = 16, minsize: int = 20,
                            thresholds=(0.6, 0.7, 0.7),
                            sim_threshold: float = 0.5, max_faces: int = 8,
                            int8_embed: bool = False,
                            dynamic_gallery: bool = False, device=None):
    """:func:`make_multiface_pipeline` over a batch of frames
    ``[N, H, W, 3]``: every output gains a leading N axis."""
    if max_faces > MAX_FACES:   # the cascade's out_cap; no silent truncation
        raise ValueError(
            f"max_faces ({max_faces}) exceeds the device cascade's output "
            f"capacity ({MAX_FACES})")
    dev = resolve_device(device)
    embed = _embed_fn(embed_model, int8_embed)
    cascade = make_device_cascade(
        detector.pnet, detector.rnet, detector.onet, frame_h, frame_w,
        minsize=minsize, thresholds=thresholds, device=dev)
    baked = None if dynamic_gallery else l2_normalize(
        torch.as_tensor(np.asarray(gallery, np.float32), device=dev))
    half = margin / 2

    @torch.inference_mode()
    def pipeline(frames, gallery_n=baked, rows=None):
        frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        nf = frames.shape[0]
        boxes, _, counts = cascade(frames)                 # [F, cap, 5]
        valid = torch.isfinite(boxes[..., 4])
        score = torch.where(valid, boxes[..., 4], float("-inf"))
        k = min(max_faces, boxes.shape[1])
        top_s, top_i = stable_topk(score, k)               # [F, K]
        found = torch.isfinite(top_s)
        sel = torch.gather(boxes[..., :4], 1,
                           top_i[..., None].expand(nf, k, 4))
        # margin pad + clip per face (crop_face semantics); rows of invalid
        # faces may be non-finite and are masked by `found`
        bxs = torch.stack([
            torch.clamp(sel[..., 0] - half, min=0.0),
            torch.clamp(sel[..., 1] - half, min=0.0),
            torch.clamp(sel[..., 2] + half, max=float(frame_w)),
            torch.clamp(sel[..., 3] + half, max=float(frame_h)),
        ], dim=-1)
        safe = torch.where(torch.isfinite(bxs), bxs, 0.0)
        crops = crop_resize_boxes(frames, safe, embed_size)  # [F, K, S, S, 3]
        gray = crops.mean(dim=-1, keepdim=True) / 255.0
        feats = embed(gray.reshape(nf * k, embed_size, embed_size, 1), nf)
        embs = l2_normalize(feats).reshape(nf, k, -1)       # [F, K, D]
        idx, sim, real = _match_gallery(gallery_sims(embs, gallery_n), rows)
        matched = found & real & (sim >= sim_threshold)
        return {
            "found": found,
            "boxes": bxs,
            "scores": top_s,
            "indices": torch.where(matched, idx, -1).to(torch.int32),
            "similarities": torch.where(found & real, sim, -2.0),
            "embeddings": embs,
            "cap_dropped": counts[:, 0] + counts[:, 1] + counts[:, 2],
            "topk_dropped": torch.clamp(
                valid.sum(-1, dtype=torch.int32) - k, min=0),
        }

    return pipeline


def make_sharded_multistream_pipeline(detector, embed_model, gallery, mesh,
                                      *, axis: str = "data", **kwargs):
    """Multi-stream serving over the ranks of ``mesh``'s ``axis``: frames
    ``[N, H, W, 3]`` split along the stream axis in rank order, the nets
    and the gallery on every rank. Takes
    :func:`make_multistream_pipeline`'s keywords; returns fn(frames) ->
    its dict, whole on every rank. N must be a multiple of the axis
    size."""
    multi = make_multistream_pipeline(detector, embed_model, gallery,
                                      **kwargs)
    group, d = axis_group(mesh, axis), axis_size(mesh, axis)

    def run(frames):
        n = frames.shape[0]
        if n % d != 0:
            raise ValueError(
                f"stream count ({n}) must be a multiple of the mesh "
                f"'{axis}' axis size ({d})")
        out = multi(local_block(frames, mesh, axis))
        return {k: gather_rows(v, group) for k, v in out.items()}

    return run


def shard_gallery(gallery: np.ndarray, mesh, *, gallery_axis: str = "model",
                  dtype=torch.float32, device=None):
    """L2-normalize the gallery on the host, zero-pad its rows to a
    ``gallery_axis`` multiple, narrow it to ``dtype`` and keep this
    rank's block on the device. Returns ``(gal_n, rows)`` for
    :func:`make_gallery_sharded_multistream_pipeline`, whose ``rows``
    masks the padding out of every match."""
    k, i = axis_size(mesh, gallery_axis), axis_index(mesh, gallery_axis)
    g, d = gallery.shape
    gal = l2_normalize_np(np.asarray(gallery, np.float32))
    pad = (-g) % k
    if pad:
        gal = np.concatenate([gal, np.zeros((pad, d), np.float32)])
    block = (g + pad) // k
    rows = narrow_gallery_np(gal[i * block:(i + 1) * block], dtype)
    return rows.to(resolve_device(device)), g


def make_gallery_sharded_multistream_pipeline(
        detector, embed_model, mesh, *, stream_axis: str = "data",
        gallery_axis: str = "model", frame_h: int, frame_w: int,
        embed_size: int = 128, margin: int = 16, minsize: int = 20,
        thresholds=(0.6, 0.7, 0.7), sim_threshold: float = 0.5,
        int8_embed: bool = False, device=None):
    """Serve a gallery sharded by rows over ``gallery_axis``: the frames
    ``[N, H, W, 3]`` split over the flattened mesh for detection and
    embedding, the ``[N, D]`` embeddings gathered on every rank, each
    rank's gallery block scanned and the winners reduced over the gallery
    axis. Call as ``fn(frames, gal_n, rows)`` with this rank's block
    (:func:`shard_gallery` or ``DeviceGallery(mesh=...)``); the dict of
    :func:`make_multistream_pipeline`, whole on every rank. N must be a
    multiple of the mesh size. ``stream_axis`` names the mesh's other
    axis (the frames span both)."""
    del stream_axis
    dev = resolve_device(device)
    detect_embed = _make_detect_embed(
        detector, embed_model, frame_h=frame_h, frame_w=frame_w,
        embed_size=embed_size, margin=margin, minsize=minsize,
        thresholds=thresholds, device=dev, int8_embed=int8_embed)
    world, ndev = axis_group(mesh, None), axis_size(mesh, None)
    ggroup = axis_group(mesh, gallery_axis)
    gindex = axis_index(mesh, gallery_axis)

    @torch.inference_mode()
    def run(frames, gal_n, rows):
        n = frames.shape[0]
        if n % ndev != 0:
            raise ValueError(
                f"stream count ({n}) must be a multiple of the mesh size "
                f"({ndev}) — frames shard over the whole mesh")
        frames = torch.as_tensor(local_block(frames, mesh, None),
                                 dtype=torch.float32, device=dev)
        found, box, score, emb, cap_dropped = (
            gather_rows(t, world) for t in detect_embed(frames))
        row0 = gindex * gal_n.shape[0]
        sims = gallery_sims(emb, gal_n)                   # [N, block]
        idx, sim, _ = _match_gallery(
            sims, torch.as_tensor(rows, device=sims.device) - row0)
        idx, sim = global_argmax(idx, sim, row0, ggroup)
        real = sim > float("-inf")
        matched = found & real & (sim >= sim_threshold)
        return {
            "found": found,
            "box": box,
            "score": score,
            "index": torch.where(matched, idx, -1).to(torch.int32),
            "similarity": torch.where(found & real, sim, -2.0),
            "embedding": emb,
            "cap_dropped": cap_dropped,
        }

    return run


def normalize_gallery(gallery, dtype=torch.float32, device=None) -> torch.Tensor:
    """Gallery rows -> the L2-normalized ``[G, D]`` tensor the
    ``dynamic_gallery`` pipelines take, stored as float32, bfloat16 or int8
    on the 127 scale (normalized in float32 on the host, narrowed before
    the upload)."""
    rows = narrow_gallery_np(l2_normalize_np(np.asarray(gallery, np.float32)),
                             dtype)
    return rows.to(resolve_device(device))
