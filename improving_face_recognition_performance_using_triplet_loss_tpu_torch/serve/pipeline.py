"""The fused recognition pipeline: detect -> crop -> embed -> match.

Port of the JAX package's ``serve/pipeline.py`` single-frame, multi-stream
and multiface pipelines, for a batch of frames at once. Every pipeline is
one front and one match. The front (:func:`_make_front`) uploads the
frames, runs the MTCNN cascade, picks each frame's faces (a selection: the
largest-centered face, or the top ``max_faces`` by score), margin-crops
them resized to the embedding input in grayscale, runs the embedding net
and L2-normalizes; the match is the gallery's one cosine argmax
(:func:`~.gallery.gallery_match`). The JAX package compiles this into one
XLA program and ``vmap``-s it over streams; here each stage runs eagerly
over the frame axis, and the kernels of the path (NMS, the fused stem,
EFM3) launch once per stage for all frames. ``int8_embed=True`` runs the
embedding net (never MTCNN) on the int8 conv route of ``ops/quantized.py``
with one activation scale a frame: the JAX package embeds each frame's
crops (one, or ``max_faces`` with the empty slots) in its own call under
``vmap``. The mesh-sharded pipelines split the frames over a mesh's ranks
(:func:`make_sharded_multistream_pipeline`) or the gallery's rows as well
(:func:`shard_gallery`, :func:`make_gallery_sharded_multistream_pipeline`).
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..detect.device_cascade import crop_resize_boxes, make_device_cascade
from ..device import resolve_device
from ..models.mtcnn import conv_route
from ..ops.boxes import stable_topk
from ..ops.distances import l2_normalize, l2_normalize_np, narrow_gallery_np
from ..ops.quantized import Int8ConvRoute
from ..parallel.collectives import gather_rows
from ..parallel.mesh import axis_group, axis_index, axis_size, local_block
from ..utils.profiling import count, span
from .gallery import gallery_match, normalize_gallery  # noqa: F401

# the device cascade's output capacity: the most faces a frame can yield
MAX_FACES = 64
# the result fields of the single-face pipelines, and of the multiface ones
_FIELDS = ("found", "box", "score", "index", "similarity", "embedding",
           "cap_dropped")
_FACE_FIELDS = ("found", "boxes", "scores", "indices", "similarities",
                "embeddings", "cap_dropped")


def _host_uint8(frames) -> bool:
    """Whether host frames (a numpy array or a CPU tensor) are uint8."""
    if isinstance(frames, torch.Tensor):
        return frames.dtype == torch.uint8
    return isinstance(frames, np.ndarray) and frames.dtype == np.uint8


class _Uploader:
    """A pipeline's frame upload: fn(frames) -> the frames as float32 on
    ``dev``.

    Host uint8 frames (a numpy array or a CPU tensor) cross in uint8 and
    are widened on ``dev`` (exact, so the float32 frames are those a
    host conversion gives). On a card they cross from a page-locked
    staging buffer, one a frame shape, kept with a device buffer of that
    shape: the frames are copied into it on the host, the copy to the
    card is enqueued without blocking and the widening after it, on the
    current stream, so the host goes on to the next stage while the copy
    runs. An event recorded after the widening marks the end of both
    buffers' use; the next call of that shape waits on it before it
    overwrites them. The caller's array is free once the call returns.
    Other host frames cross as float32; frames on a device are not
    copied. ``serve.upload_bytes`` counts the bytes of host frames in the
    dtype they cross in."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.staged: dict = {}   # shape -> (host buffer, device buffer, event)
        self.lock = threading.Lock()

    def __call__(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor) and frames.device.type != "cpu":
            return torch.as_tensor(frames, dtype=torch.float32,
                                   device=self.dev)
        uint8 = _host_uint8(frames)
        if uint8 and self.dev.type == "cuda":
            out = self._staged(frames)
        else:
            out = torch.as_tensor(frames, dtype=torch.float32,
                                  device=self.dev)
        count("serve.upload_bytes", frames.nbytes if uint8 else out.nbytes)
        return out

    def _staged(self, frames) -> torch.Tensor:
        shape = tuple(frames.shape)
        with self.lock:
            if shape not in self.staged:
                self.staged[shape] = (
                    torch.empty(shape, dtype=torch.uint8, pin_memory=True),
                    torch.empty(shape, dtype=torch.uint8, device=self.dev),
                    torch.cuda.Event())
            host, dev_buf, done = self.staged[shape]
            done.synchronize()
            if isinstance(frames, np.ndarray):
                np.copyto(host.numpy(), frames)
            else:
                host.copy_(frames)
            dev_buf.copy_(host, non_blocking=True)
            out = dev_buf.to(torch.float32)
            done.record(torch.cuda.current_stream(self.dev))
        return out


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


class _Selection(NamedTuple):
    """How the front picks K faces a frame from the cascade's rows:
    ``pick(boxes [F, cap, 5]) -> (found [F, K], box [F, K, 4], score
    [F, K], extra result fields)``. ``zero_nonfinite`` crops the
    margin-padded boxes that are not finite as zeros."""
    pick: Callable
    zero_nonfinite: bool


def _largest_centered(frame_h: int, frame_w: int) -> _Selection:
    """The single-face selection (K = 1): each frame's valid face of
    largest ``area - 2 * center offset^2``. A frame with none keeps the
    cascade's first row, ``found`` False, cropped as it is."""

    def pick(boxes):
        valid = torch.isfinite(boxes[..., 4])
        found = valid.any(-1, keepdim=True)
        area = ((boxes[..., 2] - boxes[..., 0])
                * (boxes[..., 3] - boxes[..., 1]))
        cx = (boxes[..., 0] + boxes[..., 2]) * 0.5 - frame_w / 2.0
        cy = (boxes[..., 1] + boxes[..., 3]) * 0.5 - frame_h / 2.0
        rank = torch.where(valid, area - 2.0 * (cx * cx + cy * cy),
                           float("-inf"))
        best = torch.argmax(rank, dim=-1)
        sel = torch.gather(boxes, 1, best[:, None, None].expand(-1, 1, 5))
        return found, sel[..., :4], sel[..., 4], {}

    return _Selection(pick, zero_nonfinite=False)


def _top_scores(max_faces: int) -> _Selection:
    """The multiface selection: each frame's ``max_faces`` valid faces of
    highest score (ties to the lower row, as ``lax.top_k``). The empty
    slots score -inf with ``found`` False, and their boxes, which may not
    be finite, crop as zeros. Adds ``topk_dropped``, the valid faces
    beyond ``max_faces``."""

    def pick(boxes):
        valid = torch.isfinite(boxes[..., 4])
        score = torch.where(valid, boxes[..., 4], float("-inf"))
        k = min(max_faces, boxes.shape[1])
        top_s, top_i = stable_topk(score, k)               # [F, K]
        sel = torch.gather(boxes[..., :4], 1,
                           top_i[..., None].expand(-1, k, 4))
        dropped = torch.clamp(valid.sum(-1, dtype=torch.int32) - k, min=0)
        return torch.isfinite(top_s), sel, top_s, {"topk_dropped": dropped}

    return _Selection(pick, zero_nonfinite=True)


def _make_front(detector, embed_model, select: _Selection, *, frame_h,
                frame_w, embed_size, margin, minsize, thresholds,
                int8_embed, device):
    """The gallery-independent front of every pipeline: upload -> cascade
    -> ``select``'s K faces a frame -> margin pad and clip -> crop resized
    to the embedding input in grayscale -> embed -> L2 norm. Returns
    fn(frames [F, H, W, 3]) -> (found [F, K], box [F, K, 4], score
    [F, K], emb [F, K, D], cap_dropped [F], extra result fields)."""
    upload = _Uploader(device)
    cascade = make_device_cascade(
        detector.pnet, detector.rnet, detector.onet, frame_h, frame_w,
        minsize=minsize, thresholds=thresholds, device=device)
    embed = _embed_fn(embed_model, int8_embed)
    half = margin / 2

    def front(frames):
        with span("serve.upload"):
            frames = upload(frames)
        nf = frames.shape[0]
        boxes, _, counts = cascade(frames)                 # [F, cap, 5]
        with span("serve.crop"):
            found, sel, score, extra = select.pick(boxes)
            k = sel.shape[1]
            # margin pad + clip (crop_face semantics)
            box = torch.stack([
                torch.clamp(sel[..., 0] - half, min=0.0),
                torch.clamp(sel[..., 1] - half, min=0.0),
                torch.clamp(sel[..., 2] + half, max=float(frame_w)),
                torch.clamp(sel[..., 3] + half, max=float(frame_h)),
            ], dim=-1)
            crop_box = (torch.where(torch.isfinite(box), box, 0.0)
                        if select.zero_nonfinite else box)
            crops = crop_resize_boxes(frames, crop_box, embed_size)
            gray = crops.mean(dim=-1, keepdim=True) / 255.0  # [F, K, S, S, 1]
            cap_dropped = counts[:, 0] + counts[:, 1] + counts[:, 2]
        with span("serve.embed"):
            feats = embed(gray.reshape(nf * k, embed_size, embed_size, 1), nf)
            emb = l2_normalize(feats).reshape(nf, k, -1)    # [F, K, D]
        return found, box, score, emb, cap_dropped, extra

    return front


def _result(fields, found, box, score, idx, sim, real, emb, cap_dropped,
            sim_threshold: float, extra: dict) -> dict:
    """A pipeline's dict, under ``fields``' names, from its faces'
    detections, embeddings and gallery match."""
    matched = found & real & (sim >= sim_threshold)
    return dict(zip(fields, (
        found, box, score, torch.where(matched, idx, -1).to(torch.int32),
        torch.where(found & real, sim, -2.0), emb, cap_dropped)), **extra)


def _first_face(found, box, score, emb):
    """The front's K = 1 fields without the face axis."""
    return found[:, 0], box[:, 0], score[:, 0], emb[:, 0]


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

    ``max_faces`` > 0 identifies the top ``max_faces`` faces of every
    frame instead: :func:`make_multiface_pipeline`'s dict, every field
    with a leading N axis over its per-face arrays."""
    if max_faces > MAX_FACES:   # the cascade's out_cap; no silent truncation
        raise ValueError(
            f"max_faces ({max_faces}) exceeds the device cascade's output "
            f"capacity ({MAX_FACES})")
    dev = resolve_device(device)
    select = (_top_scores(max_faces) if max_faces
              else _largest_centered(frame_h, frame_w))
    front = _make_front(
        detector, embed_model, select, frame_h=frame_h, frame_w=frame_w,
        embed_size=embed_size, margin=margin, minsize=minsize,
        thresholds=thresholds, int8_embed=int8_embed, device=dev)
    baked = None if dynamic_gallery else l2_normalize(
        torch.as_tensor(np.asarray(gallery, np.float32), device=dev))

    @torch.inference_mode()
    def pipeline(frames, gallery_n=baked, rows=None):
        *faces, cap_dropped, extra = front(frames)
        with span("serve.match"):
            found, box, score, emb = (faces if max_faces
                                      else _first_face(*faces))
            idx, sim, real = gallery_match(emb, gallery_n, rows)
            return _result(_FACE_FIELDS if max_faces else _FIELDS, found,
                           box, score, idx, sim, real, emb, cap_dropped,
                           sim_threshold, extra)

    return pipeline


def _single(multi):
    """A batched pipeline as fn(frame [H, W, 3], *gallery args) -> its dict
    without the leading axis."""

    def pipeline(frame, *args):
        if not isinstance(frame, torch.Tensor):
            frame = np.asarray(frame)
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
    fn(frame, gallery_n[, rows]). Takes :func:`make_multistream_pipeline`'s
    keywords, ``max_faces`` 8 unless given (at most :data:`MAX_FACES`)."""
    kwargs.setdefault("max_faces", 8)
    return _single(make_multistream_pipeline(detector, embed_model, gallery,
                                             **kwargs))


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
    front = _make_front(
        detector, embed_model, _largest_centered(frame_h, frame_w),
        frame_h=frame_h, frame_w=frame_w, embed_size=embed_size,
        margin=margin, minsize=minsize, thresholds=thresholds,
        int8_embed=int8_embed, device=resolve_device(device))
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
        *faces, cap_dropped, extra = front(local_block(frames, mesh, None))
        with span("serve.match"):
            found, box, score, emb, cap_dropped = (
                gather_rows(t, world)
                for t in (*_first_face(*faces), cap_dropped))
            idx, sim, real = gallery_match(
                emb, gal_n, rows, gindex * gal_n.shape[0], ggroup)
            return _result(_FIELDS, found, box, score, idx, sim, real, emb,
                           cap_dropped, sim_threshold, extra)

    return run
