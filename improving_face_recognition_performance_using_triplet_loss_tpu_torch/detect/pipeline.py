"""MTCNN pyramid cascade (reference detect_face.py:279-399, MTCNN.hpp:993).

Port of the JAX package's ``detect/pipeline.py``: ``pyramid_scales``, an
``MTCNNDetector`` that holds PNet, RNet and ONet, its host cascade
``detect`` and the functional ``detect_faces``. The host cascade follows
the reference exactly: an image pyramid with factor 0.709 from 12/minsize
down to 12 px resampled with cv2 ``INTER_AREA``, the PNet heatmap decode,
per-scale NMS 0.5 and cross-scale NMS 0.7, box regression and squaring,
RNet on 24x24 crops (threshold[1], NMS 0.7, bbreg, square) and ONet on
48x48 crops (threshold[2], landmark decode, bbreg, NMS-Min 0.7), with the
TF version's (x, y) transposition so converted-Caffe det*.npy weights stay
drop-in compatible.

The nets run on the detector's device; the variable-length box lists, the
crops and NMS stay in numpy on the host, as in the JAX package, so this
path launches no kernel of the port (``device_pyramid=True`` runs stage 1
on the device instead, whose two NMS passes launch B5). The JAX detector
pads RNet/ONet
batches to a power of two to bound its compiles; PyTorch compiles nothing,
so the port runs each batch as it is. cv2 is imported only where an image
is resampled.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models import mtcnn as nets
from ..ops.boxes import bbreg, generate_bounding_box, nms, pad, rerec


def imresample(img: np.ndarray, sz: tuple[int, int]) -> np.ndarray:
    """cv2 INTER_AREA resample, exactly the reference's imresample
    (detect_face.py:746-748)."""
    import cv2

    return cv2.resize(img, (sz[1], sz[0]), interpolation=cv2.INTER_AREA)


def pyramid_scales(h: int, w: int, minsize: int, factor: float) -> list[float]:
    """Scale pyramid: from 12/minsize down while the short side stays at
    least 12 px (detect_face.py:287-300 of the reference)."""
    minl = min(h, w)
    m = 12.0 / minsize
    minl = minl * m
    scales = []
    count = 0
    while minl >= 12:
        scales.append(m * (factor ** count))
        minl = minl * factor
        count += 1
    return scales


class MTCNNDetector:
    """The three cascade nets on one device (``cuda`` unless given).

    Params are det*.npy-layout dicts (``models.mtcnn.load_npy_params``);
    any net left out gets the JAX package's random init, drawn from one
    CPU ``torch.Generator`` seeded with ``seed`` (PNet, then RNet, then
    ONet), so a seed gives the same weights on every device."""

    def __init__(self, pnet_params=None, rnet_params=None, onet_params=None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.pnet = nets.build(nets.PNet, pnet_params, generator=gen,
                               device=self.device)
        self.rnet = nets.build(nets.RNet, rnet_params, generator=gen,
                               device=self.device)
        self.onet = nets.build(nets.ONet, onet_params, generator=gen,
                               device=self.device)
        self._device_stage1: dict = {}

    @classmethod
    def from_npy(cls, det1: str, det2: str, det3: str,
                 device=None) -> "MTCNNDetector":
        return cls(nets.load_npy_params(det1), nets.load_npy_params(det2),
                   nets.load_npy_params(det3), device=device)

    # stage helpers -------------------------------------------------------

    @torch.inference_mode()
    def _run(self, net, x: np.ndarray) -> tuple[np.ndarray, ...]:
        """A net over a float32 NHWC numpy batch, the outputs as numpy."""
        outs = net(torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(self.device))
        return tuple(o.cpu().numpy() for o in outs)

    def _run_pnet(self, img: np.ndarray, scale: float, threshold: float):
        h, w = img.shape[:2]
        hs = int(np.ceil(h * scale))
        ws = int(np.ceil(w * scale))
        im_data = (imresample(img, (hs, ws)) - 127.5) * 0.0078125
        # transpose to the TF-caffe orientation (detect_face.py:308-312)
        img_y = np.transpose(im_data[None], (0, 2, 1, 3))
        prob, reg = self._run(self.pnet, img_y)
        out0 = np.transpose(reg, (0, 2, 1, 3))
        out1 = np.transpose(prob, (0, 2, 1, 3))
        boxes, _ = generate_bounding_box(out1[0, :, :, 1].copy(),
                                         out0[0].copy(), scale, threshold)
        pick = nms(boxes.copy(), 0.5, "Union")
        return boxes[pick] if boxes.size and pick.size else np.empty((0, 9))

    def _crops(self, img: np.ndarray, total_boxes: np.ndarray, size: int):
        """Build padded square crops (detect_face.py:340-348,368-376)."""
        h, w = img.shape[:2]
        dy, edy, dx, edx, y, ey, x, ex, tmpw, tmph = pad(total_boxes.copy(),
                                                         w, h)
        numbox = total_boxes.shape[0]
        tempimg = np.zeros((numbox, size, size, 3), np.float32)
        for k in range(numbox):
            tmp = np.zeros((int(tmph[k]), int(tmpw[k]), 3))
            tmp[dy[k] - 1:edy[k], dx[k] - 1:edx[k], :] = (
                img[y[k] - 1:ey[k], x[k] - 1:ex[k], :])
            if tmp.shape[0] > 0 and tmp.shape[1] > 0:
                tempimg[k] = imresample(tmp, (size, size))
        tempimg = (tempimg - 127.5) * 0.0078125
        # (x, y) transpose for weight compatibility (detect_face.py:349)
        return np.transpose(tempimg, (0, 2, 1, 3))

    def _stage1_device(self, img: np.ndarray, minsize: int, factor: float,
                       threshold: float) -> np.ndarray:
        """Stage 1 as the port's batched device pyramid with one frame
        (``detect/device_pnet.py``), cached per image shape and setting."""
        from .device_pnet import make_device_stage1

        h, w = img.shape[:2]
        key = (h, w, minsize, factor, threshold)
        if key not in self._device_stage1:
            self._device_stage1[key] = make_device_stage1(
                self.pnet, h, w, minsize=minsize, factor=factor,
                threshold=threshold, device=self.device)
        out = self._device_stage1[key](img[None].astype(np.float32))
        out = out[0].cpu().numpy()
        return out[np.isfinite(out[:, 4])].astype(np.float64)

    # full cascade --------------------------------------------------------

    def detect(self, img: np.ndarray, minsize: int = 20,
               thresholds: Sequence[float] = (0.6, 0.7, 0.7),
               factor: float = 0.709, device_pyramid: bool = False):
        """Returns (boxes [N, 5], points [10, N]) — the reference's outputs
        (x1 y1 x2 y2 score; landmarks as 5 xs then 5 ys).

        ``device_pyramid=True`` runs the whole stage-1 pyramid on the device
        (detect/device_pnet.py, kernel B5 for its two NMS passes): bilinear
        device resize instead of INTER_AREA (documented deviation)."""
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        h, w = img.shape[:2]
        total_boxes = np.empty((0, 9))
        points = np.empty((10, 0))

        if device_pyramid:
            total_boxes = self._stage1_device(img, minsize, factor,
                                              thresholds[0])
        else:
            # stage 1: PNet over the pyramid (host path, reference-exact)
            for scale in pyramid_scales(h, w, minsize, factor):
                boxes = self._run_pnet(img, scale, thresholds[0])
                if boxes.size:
                    total_boxes = np.append(total_boxes, boxes, axis=0)
            if total_boxes.shape[0] > 0:
                pick = nms(total_boxes.copy(), 0.7, "Union")
                total_boxes = total_boxes[pick]

        if total_boxes.shape[0] > 0:
            regw = total_boxes[:, 2] - total_boxes[:, 0]
            regh = total_boxes[:, 3] - total_boxes[:, 1]
            qq1 = total_boxes[:, 0] + total_boxes[:, 5] * regw
            qq2 = total_boxes[:, 1] + total_boxes[:, 6] * regh
            qq3 = total_boxes[:, 2] + total_boxes[:, 7] * regw
            qq4 = total_boxes[:, 3] + total_boxes[:, 8] * regh
            total_boxes = np.transpose(np.vstack([qq1, qq2, qq3, qq4,
                                                  total_boxes[:, 4]]))
            total_boxes = rerec(total_boxes.copy())
            total_boxes[:, 0:4] = np.fix(total_boxes[:, 0:4]).astype(np.int32)

        # stage 2: RNet
        if total_boxes.shape[0] > 0:
            crops = self._crops(img, total_boxes, 24)
            prob, reg = self._run(self.rnet, crops)
            score = prob[:, 1]
            ipass = score > thresholds[1]
            total_boxes = np.hstack([total_boxes[ipass, 0:4],
                                     score[ipass, None]])
            mv = reg[ipass].T
            if total_boxes.shape[0] > 0:
                pick = nms(total_boxes, 0.7, "Union")
                total_boxes = total_boxes[pick]
                total_boxes = bbreg(total_boxes.copy(), np.transpose(mv[:, pick]))
                total_boxes = rerec(total_boxes.copy())

        # stage 3: ONet
        if total_boxes.shape[0] > 0:
            total_boxes = np.fix(total_boxes).astype(np.int32).astype(np.float64)
            crops = self._crops(img, total_boxes, 48)
            prob, reg, lmk = self._run(self.onet, crops)
            score = prob[:, 1]
            pts = lmk.T
            ipass = score > thresholds[2]
            pts = pts[:, ipass]
            total_boxes = np.hstack([total_boxes[ipass, 0:4],
                                     score[ipass, None]])
            mv = reg[ipass].T
            bw = total_boxes[:, 2] - total_boxes[:, 0] + 1
            bh = total_boxes[:, 3] - total_boxes[:, 1] + 1
            pts = pts.copy()
            pts[0:5, :] = (np.tile(bw, (5, 1)) * pts[0:5, :]
                           + np.tile(total_boxes[:, 0], (5, 1)) - 1)
            pts[5:10, :] = (np.tile(bh, (5, 1)) * pts[5:10, :]
                            + np.tile(total_boxes[:, 1], (5, 1)) - 1)
            points = pts
            if total_boxes.shape[0] > 0:
                total_boxes = bbreg(total_boxes.copy(), np.transpose(mv))
                pick = nms(total_boxes.copy(), 0.7, "Min")
                total_boxes = total_boxes[pick]
                points = points[:, pick]

        return total_boxes, points


@functools.lru_cache(maxsize=1)
def _default_detector() -> MTCNNDetector:
    return MTCNNDetector()


def detect_faces(img: np.ndarray, minsize: int = 20,
                 thresholds: Sequence[float] = (0.6, 0.7, 0.7),
                 factor: float = 0.709, detector: MTCNNDetector | None = None):
    """Functional wrapper (reference detect_face signature); without a
    ``detector``, one random-init detector on ``cuda`` per process."""
    det = detector or _default_detector()
    return det.detect(img, minsize, thresholds, factor)
