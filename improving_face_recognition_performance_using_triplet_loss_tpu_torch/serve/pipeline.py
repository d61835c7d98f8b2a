"""The fused recognition pipeline: detect -> crop -> embed -> match.

Port of the JAX package's ``serve/pipeline.py`` single-frame and
multi-stream pipelines: the MTCNN cascade, the largest-centered face, its
margin crop resized to the embedding input in grayscale, the embedding net,
L2 normalization and the cosine gallery argmax, for a batch of frames at
once. The JAX package compiles this into one XLA program and ``vmap``-s it
over streams; here each stage runs eagerly over the frame axis, and the
kernels of the path (NMS, the fused stem, EFM3) launch once per stage for
all frames. The multi-face and mesh-sharded pipelines are not ported yet
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from ..detect.device_cascade import crop_resize_boxes, make_device_cascade
from ..device import resolve_device
from ..ops.distances import (gallery_sims, l2_normalize, l2_normalize_np,
                             narrow_gallery_np)


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


def _make_detect_embed(detector, embed_model, *, frame_h, frame_w,
                       embed_size, margin, minsize, thresholds, device):
    """The gallery-independent front: cascade -> largest-centered face ->
    margin crop -> grayscale resize -> embed -> L2 norm, over a batch of
    frames. Returns fn(frames [F, H, W, 3]) -> (found [F], box [F, 4],
    score [F], emb [F, D], cap_dropped [F])."""
    cascade = make_device_cascade(
        detector.pnet, detector.rnet, detector.onet, frame_h, frame_w,
        minsize=minsize, thresholds=thresholds, device=device)
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
        _, feat = embed_model(gray)
        emb = l2_normalize(feat)
        cap_dropped = counts[:, 0] + counts[:, 1] + counts[:, 2]
        return found, box, sel[:, 4], emb, cap_dropped

    return detect_embed


def make_multistream_pipeline(detector, embed_model, gallery=None, *,
                              frame_h: int, frame_w: int,
                              embed_size: int = 128, margin: int = 16,
                              minsize: int = 20, thresholds=(0.6, 0.7, 0.7),
                              sim_threshold: float = 0.5,
                              dynamic_gallery: bool = False, device=None):
    """Identify the best face in every frame of a same-shape batch
    ``[N, frame_h, frame_w, 3]`` (0-255).

    ``detector`` is an ``MTCNNDetector`` and ``embed_model`` an embedding
    net (``EFMNet342``), both on ``device`` (``cuda`` unless given).
    Returns fn(frames) -> dict with a leading N axis on ``found``, ``box``
    [N, 4], ``score``, ``index`` (gallery row, -1 below ``sim_threshold``),
    ``similarity``, ``embedding`` [N, D] and ``cap_dropped``.

    ``dynamic_gallery=True`` returns fn(frames, gallery_n[, rows]) instead,
    with the L2-normalized gallery (:func:`normalize_gallery`) passed at
    call time; columns >= ``rows`` are masked out of the argmax."""
    dev = resolve_device(device)
    detect_embed = _make_detect_embed(
        detector, embed_model, frame_h=frame_h, frame_w=frame_w,
        embed_size=embed_size, margin=margin, minsize=minsize,
        thresholds=thresholds, device=dev)
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


def make_recognition_pipeline(detector, embed_model, gallery=None, **kwargs):
    """The single-frame pipeline: fn(frame [H, W, 3]) -> the
    :func:`make_multistream_pipeline` dict without the leading axis (with
    ``dynamic_gallery=True``: fn(frame, gallery_n[, rows]))."""
    multi = make_multistream_pipeline(detector, embed_model, gallery,
                                      **kwargs)

    def pipeline(frame, *args):
        frame = torch.as_tensor(frame, dtype=torch.float32)
        out = multi(frame[None], *args)
        return {k: v[0] for k, v in out.items()}

    return pipeline


def normalize_gallery(gallery, dtype=torch.float32, device=None) -> torch.Tensor:
    """Gallery rows -> the L2-normalized ``[G, D]`` tensor the
    ``dynamic_gallery`` pipelines take, stored as float32 or bfloat16
    (normalized in float32 on the host, narrowed before the upload)."""
    rows = narrow_gallery_np(l2_normalize_np(np.asarray(gallery, np.float32)),
                             dtype)
    return rows.to(resolve_device(device))
