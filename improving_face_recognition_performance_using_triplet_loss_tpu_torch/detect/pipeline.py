"""The MTCNN detector: the three cascade nets and the image pyramid.

Port of the part of the JAX package's ``detect/pipeline.py`` that the
on-device cascade uses: ``pyramid_scales`` and an ``MTCNNDetector`` that
holds PNet, RNet and ONet. The host cascade (cv2 resampling, numpy box
lists) is not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import mtcnn as nets


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

    @classmethod
    def from_npy(cls, det1: str, det2: str, det3: str,
                 device=None) -> "MTCNNDetector":
        return cls(nets.load_npy_params(det1), nets.load_npy_params(det2),
                   nets.load_npy_params(det3), device=device)
