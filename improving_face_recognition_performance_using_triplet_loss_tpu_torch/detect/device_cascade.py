"""The whole MTCNN cascade on the device, batched over frames.

Port of the JAX package's ``detect/device_cascade.py``: stage 1
(``device_pnet``), then fixed-capacity box sets flow through a crop-resize
on the device (zero outside the image, like the reference's ``pad`` copy),
RNet and ONet, thresholds, box regression and squaring, and the stage-2
(0.7 Union) and stage-3 (0.7 Min) NMS, each one launch of kernel B5 for all
frames. The JAX version maps one frame and is ``vmap``-ed; here the frame
axis is written out, and the sorts are stable as ``jnp.argsort`` is.
``DeviceCascade`` keeps one cascade per frame shape and takes numpy frames
in and out, for ``detect/align.py``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..ops.boxes import nms_mask_batched, stable_topk
from ..utils.profiling import span
from .device_pnet import _f32, compute_weight_mat, make_device_stage1

_NEG_INF = float("-inf")


def bbreg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Box regression of ``[..., N, >=5]`` boxes by ``[..., N, 4]``
    offsets; columns past the fourth are kept."""
    w = boxes[..., 2] - boxes[..., 0] + 1
    h = boxes[..., 3] - boxes[..., 1] + 1
    xy = torch.stack([boxes[..., 0] + reg[..., 0] * w,
                      boxes[..., 1] + reg[..., 1] * h,
                      boxes[..., 2] + reg[..., 2] * w,
                      boxes[..., 3] + reg[..., 3] * h], dim=-1)
    return torch.cat([xy, boxes[..., 4:]], dim=-1)


def rerec(boxes: torch.Tensor) -> torch.Tensor:
    """Expand ``[..., N, >=5]`` boxes to squares about their centers."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    xy = torch.stack([x1, y1, x1 + side, y1 + side], dim=-1)
    return torch.cat([xy, boxes[..., 4:]], dim=-1)


def crop_resize_boxes(frames: torch.Tensor, boxes: torch.Tensor,
                      size: int) -> torch.Tensor:
    """``[F, H, W, 3]`` frames + ``[F, N, >=4]`` boxes (1-based inclusive
    corners) -> ``[F, N, size, size, 3]`` crops.

    ``jax.image.scale_and_translate`` of each box, linear and antialiased,
    zero outside the image, as two batched contractions against the shared
    frame with per-box weight matrices (the JAX version's formulation)."""
    h, w = frames.shape[1], frames.shape[2]
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    # size / extent as a tensor division: a Python scalar over a tensor
    # would run as a reciprocal and a multiply, off by an ulp; the filled
    # numerator is made on the device, with no host-to-device copy
    size_t = torch.full_like(y1, float(size))
    sy = size_t / (y2 - y1 + 1.0)
    sx = size_t / (x2 - x1 + 1.0)
    wy = compute_weight_mat(h, size, sy, -(y1 - 1.0) * sy)   # [F, N, H, S]
    wx = compute_weight_mat(w, size, sx, -(x1 - 1.0) * sx)   # [F, N, W, S]
    tmp = torch.einsum("fhwc,fnhy->fnywc", frames, wy.to(frames.dtype))
    return torch.einsum("fnywc,fnwx->fnyxc", tmp, wx.to(frames.dtype))


def _sorted_rows(boxes: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` rows of highest score of ``[F, N, C]`` boxes, ties in row
    order (``jnp.argsort(-score)[:k]``)."""
    _, idx = stable_topk(boxes[..., 4], k)
    return torch.gather(boxes, 1, idx[..., None].expand(*idx.shape,
                                                       boxes.shape[-1]))


def _masked(boxes, score, valid):
    return torch.cat([boxes[..., :4],
                      torch.where(valid, score, _NEG_INF)[..., None],
                      boxes[..., 5:]], dim=-1)


def _norm_crops(crops: torch.Tensor) -> torch.Tensor:
    """``[F, N, S, S, 3]`` 0-255 crops -> ``[F*N, S, S, 3]`` net input in
    the TF-caffe orientation."""
    s = crops.shape[2]
    crops = (crops.reshape(-1, s, s, 3) - 127.5) * 0.0078125
    return crops.transpose(1, 2)


def make_device_cascade(pnet, rnet, onet, h: int, w: int, *,
                        minsize: int = 20, factor: float = 0.709,
                        thresholds=(0.6, 0.7, 0.7), stage1_cap: int = 256,
                        stage2_cap: int = 128, out_cap: int = 64,
                        k_per_scale: int = 128, device=None):
    """Build the cascade for frames of shape ``[h, w, 3]``.

    Returns ``fn(frames [F, h, w, 3] float32 0-255) -> (boxes [F, out_cap,
    5], points [F, out_cap, 10], counts [F, 4])``: invalid rows score
    -inf; counts are the candidates the fixed capacities dropped (stage-1
    per-scale caps, stage-2 input, stage-3 input) and the detections."""
    if not (out_cap <= stage2_cap <= stage1_cap):
        raise ValueError(
            f"capacities must narrow through the cascade: out_cap "
            f"({out_cap}) <= stage2_cap ({stage2_cap}) <= stage1_cap "
            f"({stage1_cap})")
    dev = resolve_device(device)
    stage1 = make_device_stage1(pnet, h, w, minsize=minsize, factor=factor,
                                threshold=thresholds[0], out_cap=stage1_cap,
                                with_counts=True, k_per_scale=k_per_scale,
                                device=dev)

    @torch.inference_mode()
    def cascade(frames: torch.Tensor):
        with span("serve.stage1"):
            frames = _f32(frames, dev)
            nf = frames.shape[0]
            cand, s1_dropped = stage1(frames)               # [F, S1, 9]
            valid = torch.isfinite(cand[..., 4])
            n1 = valid.sum(-1, dtype=torch.int32)
            regw = cand[..., 2] - cand[..., 0]
            regh = cand[..., 3] - cand[..., 1]
            boxes = torch.stack([cand[..., 0] + cand[..., 5] * regw,
                                 cand[..., 1] + cand[..., 6] * regh,
                                 cand[..., 2] + cand[..., 7] * regw,
                                 cand[..., 3] + cand[..., 8] * regh,
                                 cand[..., 4]], dim=-1)
            boxes = rerec(boxes)
            boxes = torch.cat([torch.trunc(boxes[..., :4]), boxes[..., 4:]],
                              -1)
            boxes = _masked(boxes, boxes[..., 4], valid)

        with span("serve.stage2"):
            # stage 2: RNet over the top stage2_cap stage-1 candidates
            boxes2 = _sorted_rows(boxes, stage2_cap)
            prob, reg = rnet(_norm_crops(crop_resize_boxes(frames, boxes2,
                                                           24)))
            score2 = prob[:, 1].reshape(nf, -1)
            reg = reg.reshape(nf, -1, 4)
            valid2 = ((score2 > thresholds[1])
                      & torch.isfinite(boxes2[..., 4]))
            boxes2 = _masked(boxes2, score2, valid2)
            mask2 = nms_mask_batched(boxes2[..., :5].contiguous(), 0.7,
                                     "Union")
            kept = _masked(boxes2, boxes2[..., 4],
                           mask2 & torch.isfinite(boxes2[..., 4]))
            boxes2 = rerec(bbreg(kept, reg))
            boxes2 = torch.cat([torch.trunc(boxes2[..., :4]),
                                boxes2[..., 4:]], -1)

        with span("serve.stage3"):
            # stage 3: ONet over the top out_cap stage-2 survivors
            n2 = torch.isfinite(boxes2[..., 4]).sum(-1, dtype=torch.int32)
            boxes3 = _sorted_rows(boxes2, out_cap)
            prob3, reg3, lmk = onet(
                _norm_crops(crop_resize_boxes(frames, boxes3, 48)))
            score3 = prob3[:, 1].reshape(nf, -1)
            reg3 = reg3.reshape(nf, -1, 4)
            lmk = lmk.reshape(nf, -1, 10)
            valid3 = ((score3 > thresholds[2])
                      & torch.isfinite(boxes3[..., 4]))
            boxes3 = _masked(boxes3, score3, valid3)
            bw = boxes3[..., 2] - boxes3[..., 0] + 1
            bh = boxes3[..., 3] - boxes3[..., 1] + 1
            pts = torch.cat(
                [bw[..., None] * lmk[..., 0:5] + boxes3[..., 0:1] - 1,
                 bh[..., None] * lmk[..., 5:10] + boxes3[..., 1:2] - 1],
                dim=-1)
            boxes3 = bbreg(boxes3, reg3)
            mask3 = nms_mask_batched(boxes3[..., :5].contiguous(), 0.7,
                                     "Min")
            out_boxes = _masked(boxes3, boxes3[..., 4],
                                mask3 & torch.isfinite(boxes3[..., 4]))
            counts = torch.stack([
                s1_dropped,
                torch.clamp(n1 - stage2_cap, min=0),
                torch.clamp(n2 - out_cap, min=0),
                torch.isfinite(out_boxes[..., 4]).sum(-1, dtype=torch.int32),
            ], dim=-1)
            return out_boxes, pts, counts

    return cascade


class DeviceCascade:
    """Per-shape cache of the batched device cascade; numpy in and out.

    ``detect(img)`` runs it with one frame, ``detect_batch(images)`` with
    the whole same-shape batch; each call launches kernel B5 four times
    (the per-scale sets, the cross-scale set, stage 2 and stage 3).
    ``config`` is :func:`make_device_cascade`'s keywords (``minsize``,
    ``factor``, ``thresholds``, the capacities); the nets and the device
    are the detector's.

    Saturation is never silent: after every call ``last_stats`` holds the
    drop counters summed over the frames, and a ``RuntimeWarning`` fires
    when a fixed capacity truncated candidates the unbounded host path
    would have kept (the JAX package's accounting, text and counts)."""

    def __init__(self, detector, **config):
        self.det = detector
        self.config = config
        self._cache: dict = {}
        self.last_stats: dict | None = None

    def _fn(self, h: int, w: int):
        if (h, w) not in self._cache:
            self._cache[(h, w)] = make_device_cascade(
                self.det.pnet, self.det.rnet, self.det.onet, h, w,
                device=self.det.device, **self.config)
        return self._cache[(h, w)]

    def _account(self, counts: np.ndarray) -> dict:
        counts = np.asarray(counts).reshape(-1, 4)
        stats = {
            "stage1_k_dropped": int(counts[:, 0].sum()),
            "stage2_input_dropped": int(counts[:, 1].sum()),
            "stage3_input_dropped": int(counts[:, 2].sum()),
            "detections": int(counts[:, 3].sum()),
        }
        self.last_stats = stats
        total_dropped = (stats["stage1_k_dropped"]
                         + stats["stage2_input_dropped"]
                         + stats["stage3_input_dropped"])
        if total_dropped:
            warnings.warn(
                f"DeviceCascade capacity saturation: {total_dropped} "
                f"candidate(s) dropped by fixed stage caps ({stats}); "
                "raise stage1_cap/stage2_cap/out_cap or use the unbounded "
                "host path for this frame", RuntimeWarning, stacklevel=3)
        return stats

    def _run(self, frames: np.ndarray):
        """``[F, H, W, 3]`` frames -> numpy boxes ``[F, cap, 5]``, points
        ``[F, cap, 10]``, with the counts accounted."""
        boxes, pts, counts = self._fn(*frames.shape[1:3])(
            np.asarray(frames, np.float32))
        self._account(counts.cpu().numpy())
        return boxes.cpu().numpy(), pts.cpu().numpy()

    def detect(self, img: np.ndarray):
        """One frame ``[H, W, 3]`` (or grayscale ``[H, W]``) -> ``(boxes
        [N, 5], points [10, N])``, as the host cascade returns them."""
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        boxes, pts = self._run(img[None])
        sel = np.isfinite(boxes[0, :, 4])
        return boxes[0][sel], pts[0][sel].T  # points as [10, N]

    def detect_batch(self, images: np.ndarray):
        """Same-shape frames ``[N, H, W, 3]`` (or grayscale ``[N, H, W]``)
        in one batched call; returns a list of ``(boxes, points [10, k])``
        per frame."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = np.repeat(images[..., None], 3, axis=-1)
        boxes, pts = self._run(images)
        out = []
        for i in range(images.shape[0]):
            sel = np.isfinite(boxes[i, :, 4])
            out.append((boxes[i][sel], pts[i][sel].T))
        return out
