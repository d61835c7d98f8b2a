"""The MTCNN cascade and the serving pipeline, plain.

MTCNN (Zhang et al. 2016, arXiv:1604.02878; the facenet ``detect_face``
graph): PNet over an image pyramid (factor 0.709 from 12 / minsize), its
heatmap decoded to candidate windows (stride 2, cell 12), NMS 0.5 within a
scale and 0.7 across scales, then RNet on 24x24 and ONet on 48x48 crops,
each with its threshold, box regression, squaring and NMS (0.7 Union, 0.7
Min). This is the fixed-capacity form that runs on a device: the top 128
cells a scale, 256 stage-1 survivors, 128 RNet and 64 ONet inputs, ties in
score broken toward the lower row, and images resampled with the linear
antialiased kernel (zero outside the image). The pipeline then takes each
frame's largest-centered face, pads it by the margin, crops it to the
embedding size in grayscale, embeds it, L2-normalizes the embedding and
takes the cosine argmax over the gallery.

Everything is a plain PyTorch operation on float32 tensors; NMS is the
greedy rule written as a fixed point over score-ordered rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import efmnet342
from .plain import l2n, maxpool_tf

_F32_EPS = 1.1920928955078125e-07
_NEG_INF = float("-inf")

# (layer, kind, (kh, kw, cin, cout) | channels) of each net
PNET = [("conv1", "conv", (3, 3, 3, 10)), ("PReLU1", "prelu", 10),
        ("conv2", "conv", (3, 3, 10, 16)), ("PReLU2", "prelu", 16),
        ("conv3", "conv", (3, 3, 16, 32)), ("PReLU3", "prelu", 32),
        ("conv4-1", "conv", (1, 1, 32, 2)), ("conv4-2", "conv", (1, 1, 32, 4))]
RNET = [("conv1", "conv", (3, 3, 3, 28)), ("prelu1", "prelu", 28),
        ("conv2", "conv", (3, 3, 28, 48)), ("prelu2", "prelu", 48),
        ("conv3", "conv", (2, 2, 48, 64)), ("prelu3", "prelu", 64),
        ("conv4", "fc", (576, 128)), ("prelu4", "prelu", 128),
        ("conv5-1", "fc", (128, 2)), ("conv5-2", "fc", (128, 4))]
ONET = [("conv1", "conv", (3, 3, 3, 32)), ("prelu1", "prelu", 32),
        ("conv2", "conv", (3, 3, 32, 64)), ("prelu2", "prelu", 64),
        ("conv3", "conv", (3, 3, 64, 64)), ("prelu3", "prelu", 64),
        ("conv4", "conv", (2, 2, 64, 128)), ("prelu4", "prelu", 128),
        ("conv5", "fc", (1152, 256)), ("prelu5", "prelu", 256),
        ("conv6-1", "fc", (256, 2)), ("conv6-2", "fc", (256, 4)),
        ("conv6-3", "fc", (256, 10))]
NETS = {"pnet": PNET, "rnet": RNET, "onet": ONET}


def specs(cfg: dict) -> list:
    """The cascade nets' entries (``pnet.layers.conv1.weight``, ...) and
    the embedding net's (``embed.``), for the serving configuration."""
    out = []
    for net, layers in NETS.items():
        for name, kind, shape in layers:
            key = f"{net}.layers.{name}"
            if kind == "prelu":
                out.append((f"{key}.alpha", (shape,), "alpha", 0))
            elif kind == "conv":
                kh, kw, cin, cout = shape
                out += [(f"{key}.weight", (cout, cin, kh, kw), "w",
                         kh * kw * cin), (f"{key}.bias", (cout,), "b", 0)]
            else:
                cin, cout = shape
                out += [(f"{key}.weight", (cout, cin), "w", cin),
                        (f"{key}.bias", (cout,), "b", 0)]
    return out + [("embed." + k, *rest)
                  for k, *rest in efmnet342.specs(cfg["embed"])]


def _net(p: dict, net: str, x: torch.Tensor):
    """One cascade net over ``[B, H, W, 3]``: its outputs before the heads'
    softmax, as a list (prob logits, box regression[, landmarks])."""
    def c(x, name):
        k = f"{net}.layers.{name}"
        return F.conv2d(x.permute(0, 3, 1, 2), p[k + ".weight"],
                        p[k + ".bias"]).permute(0, 2, 3, 1)

    def fc(x, name):
        k = f"{net}.layers.{name}"
        return x.reshape(x.shape[0], -1) @ p[k + ".weight"].T + p[k + ".bias"]

    def act(x, name):
        a = p[f"{net}.layers.{name}.alpha"]
        return x.clamp(min=0) + a * x.clamp(max=0)

    if net == "pnet":
        x = maxpool_tf(act(c(x, "conv1"), "PReLU1"), 2, 2, "SAME")
        x = act(c(x, "conv2"), "PReLU2")
        x = act(c(x, "conv3"), "PReLU3")
        return [torch.softmax(c(x, "conv4-1"), -1), c(x, "conv4-2")]
    if net == "rnet":
        x = maxpool_tf(act(c(x, "conv1"), "prelu1"), 3, 2, "SAME")
        x = maxpool_tf(act(c(x, "conv2"), "prelu2"), 3, 2, "VALID")
        x = act(c(x, "conv3"), "prelu3")
        x = act(fc(x, "conv4"), "prelu4")
        return [torch.softmax(fc(x, "conv5-1"), -1), fc(x, "conv5-2")]
    x = maxpool_tf(act(c(x, "conv1"), "prelu1"), 3, 2, "SAME")
    x = maxpool_tf(act(c(x, "conv2"), "prelu2"), 3, 2, "VALID")
    x = maxpool_tf(act(c(x, "conv3"), "prelu3"), 2, 2, "SAME")
    x = act(c(x, "conv4"), "prelu4")
    x = act(fc(x, "conv5"), "prelu5")
    return [torch.softmax(fc(x, "conv6-1"), -1), fc(x, "conv6-2"),
            fc(x, "conv6-3")]


def pyramid(h: int, w: int, minsize: int, factor: float) -> list[float]:
    minl, m, scales, count = min(h, w), 12.0 / minsize, [], 0
    minl = minl * m
    while minl >= 12:
        scales.append(m * factor ** count)
        minl *= factor
        count += 1
    return scales


def weight_mat(n_in: int, n_out: int, scale, translation, device=None):
    """``[..., n_in, n_out]`` weights of the antialiased triangle kernel
    (linear resampling); columns sampling outside the input are zero.
    A float scale is inverted in double and rounded once, a tensor scale
    inverted in float32."""
    if isinstance(scale, torch.Tensor):
        device = scale.device
        inv = torch.reciprocal(scale)
        shift = translation * inv
    else:
        inv = torch.tensor(1.0 / scale, dtype=torch.float32, device=device)
        shift = torch.tensor(translation * (1.0 / scale), dtype=torch.float32,
                             device=device)
    kscale = torch.clamp(inv, min=1.0)
    out_i = torch.arange(n_out, dtype=torch.float32, device=device)
    sample = (out_i + 0.5) * inv[..., None] - shift[..., None] - 0.5
    in_i = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.abs(sample[..., None, :] - in_i[:, None]) / kscale[..., None,
                                                                  None]
    wts = torch.clamp(1.0 - torch.abs(x), min=0.0)
    tot = wts.sum(dim=-2, keepdim=True)
    wts = torch.where(torch.abs(tot) > 1000.0 * _F32_EPS,
                      wts / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[..., None, :], wts, 0.0)


def resize(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    h, w = img.shape[1], img.shape[2]
    if oh != h:
        img = torch.einsum("fhwc,hy->fywc", img,
                           weight_mat(h, oh, oh / h, 0.0, img.device))
    if ow != w:
        img = torch.einsum("fywc,wx->fyxc", img,
                           weight_mat(w, ow, ow / w, 0.0, img.device))
    return img


def crop_resize(frames: torch.Tensor, boxes: torch.Tensor, size: int):
    """``[F, H, W, 3]`` + ``[F, N, >=4]`` boxes (1-based inclusive
    corners) -> ``[F, N, size, size, 3]``, zero outside the frame."""
    h, w = frames.shape[1], frames.shape[2]
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    st = torch.full_like(y1, float(size))
    sy, sx = st / (y2 - y1 + 1.0), st / (x2 - x1 + 1.0)
    wy = weight_mat(h, size, sy, -(y1 - 1.0) * sy)
    wx = weight_mat(w, size, sx, -(x1 - 1.0) * sx)
    tmp = torch.einsum("fhwc,fnhy->fnywc", frames, wy)
    return torch.einsum("fnywc,fnwx->fnyxc", tmp, wx)


def topk(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nms(boxes: torch.Tensor, threshold: float, method: str) -> torch.Tensor:
    """Greedy NMS keep masks of ``[S, N, 5]`` sets (score -inf = absent),
    in the original row order. Rows are ranked by descending score, ties to
    the highest row; a row is kept iff no kept row ranked before it
    overlaps it by more than ``threshold``."""
    s, n = boxes.shape[:2]
    order = n - 1 - torch.sort(-boxes[..., 4].flip(-1), dim=-1,
                               stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(s, n, 5))
    x1, y1, x2, y2, sc = (b[..., i] for i in range(5))
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    iw = torch.clamp(torch.minimum(x2[:, :, None], x2[:, None, :])
                     - torch.maximum(x1[:, :, None], x1[:, None, :]) + 1,
                     min=0.0)
    ih = torch.clamp(torch.minimum(y2[:, :, None], y2[:, None, :])
                     - torch.maximum(y1[:, :, None], y1[:, None, :]) + 1,
                     min=0.0)
    inter = iw * ih
    if method == "Min":
        o = inter / torch.minimum(area[:, :, None], area[:, None, :])
    else:
        o = inter / (area[:, :, None] + area[:, None, :] - inter)
    idx = torch.arange(n, device=boxes.device)
    suppr = (o > threshold) & (idx[:, None] < idx[None, :]) & torch.isfinite(o)
    valid = torch.isfinite(sc)
    keep = valid.clone()
    # the greedy decisions are the fixed point of keep[j] = valid[j] and
    # no kept i < j suppresses j; iterating from "all valid" reaches it in
    # at most n passes (row j is final after pass j)
    for _ in range(n):
        new = valid & ~(suppr & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            break
        keep = new
    out = torch.zeros_like(keep)
    return out.scatter(1, order, keep)


def _decode(prob, reg, scale, threshold, k):
    """PNet heatmap ``[F, H', W']`` + reg ``[F, H', W', 4]`` -> ``[F, k,
    9]`` windows (q1 q2 score reg) of the k best cells >= threshold."""
    imap_t = prob.transpose(-1, -2)
    reg_t = reg.transpose(-2, -3)
    flat = imap_t.reshape(imap_t.shape[0], -1)
    masked = torch.where(flat >= threshold, flat, _NEG_INF)
    k = min(k, flat.shape[-1])
    scores, idx = topk(masked, k)
    wdim = imap_t.shape[-1]
    ys = torch.div(idx, wdim, rounding_mode="floor").float()
    xs = (idx % wdim).float()
    regs = torch.gather(reg_t.reshape(reg_t.shape[0], -1, 4), 1,
                        idx[..., None].expand(*idx.shape, 4))
    # a float32 product with the reciprocal of the scale, which the
    # truncation below sees
    inv = float(np.float32(1.0) / np.float32(scale))
    q = [torch.trunc((2.0 * ys + 1.0) * inv), torch.trunc((2.0 * xs + 1.0) * inv),
         torch.trunc((2.0 * ys + 12.0) * inv),
         torch.trunc((2.0 * xs + 12.0) * inv)]
    return torch.cat([torch.stack([*q, scores], -1), regs], -1)


def _pad_rows(c: torch.Tensor, k: int) -> torch.Tensor:
    n = c.shape[1]
    if n >= k:
        return c
    pad = c.new_zeros((c.shape[0], k - n, c.shape[2]))
    pad[..., 4] = _NEG_INF
    return torch.cat([c, pad], 1)


def _bbreg(boxes, reg):
    w = boxes[..., 2] - boxes[..., 0] + 1
    h = boxes[..., 3] - boxes[..., 1] + 1
    xy = torch.stack([boxes[..., 0] + reg[..., 0] * w,
                      boxes[..., 1] + reg[..., 1] * h,
                      boxes[..., 2] + reg[..., 2] * w,
                      boxes[..., 3] + reg[..., 3] * h], -1)
    return torch.cat([xy, boxes[..., 4:]], -1)


def _rerec(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    x1 = boxes[..., 0] + w * 0.5 - side * 0.5
    y1 = boxes[..., 1] + h * 0.5 - side * 0.5
    return torch.cat([torch.stack([x1, y1, x1 + side, y1 + side], -1),
                      boxes[..., 4:]], -1)


def _masked(boxes, score, valid):
    return torch.cat([boxes[..., :4],
                      torch.where(valid, score, _NEG_INF)[..., None],
                      boxes[..., 5:]], -1)


def _sorted_rows(boxes, k):
    _, idx = topk(boxes[..., 4], k)
    return torch.gather(boxes, 1, idx[..., None].expand(*idx.shape,
                                                       boxes.shape[-1]))


def _net_input(crops):
    s = crops.shape[2]
    return ((crops.reshape(-1, s, s, 3) - 127.5) * 0.0078125).transpose(1, 2)


def cascade(p: dict, frames: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``[F, H, W, 3]`` float32 frames (0-255) -> ``[F, out_cap, 5]``
    faces (score -inf where absent)."""
    th = cfg["thresholds"]
    k1, cap1, cap2, cap3 = (cfg["k_per_scale"], cfg["stage1_cap"],
                            cfg["stage2_cap"], cfg["out_cap"])
    nf, h, w = frames.shape[:3]
    per_scale = []
    scales = pyramid(h, w, cfg["minsize"], cfg["factor"])
    for scale in scales:
        hs, ws = math.ceil(h * scale), math.ceil(w * scale)
        im = (resize(frames, hs, ws) - 127.5) * 0.0078125
        prob, reg = _net(p, "pnet", im.transpose(1, 2))
        cand = _decode(prob.transpose(1, 2)[..., 1], reg.transpose(1, 2),
                       scale, th[0], k1)
        per_scale.append(_pad_rows(cand, k1))
    st = torch.stack(per_scale, 1)
    ns = len(scales)
    m = nms(st[..., :5].reshape(nf * ns, k1, 5), 0.5, "Union")
    st[..., 4] = torch.where(m.reshape(nf, ns, k1), st[..., 4], _NEG_INF)
    allc = st.reshape(nf, ns * k1, 9)
    m = nms(allc[..., :5].contiguous(), 0.7, "Union")
    top_s, top_i = topk(torch.where(m, allc[..., 4], _NEG_INF),
                        min(cap1, allc.shape[1]))
    cand = torch.gather(allc, 1, top_i[..., None].expand(*top_i.shape, 9))
    cand[..., 4] = top_s
    cand = _pad_rows(cand, cap1)

    valid = torch.isfinite(cand[..., 4])
    rw, rh = cand[..., 2] - cand[..., 0], cand[..., 3] - cand[..., 1]
    boxes = torch.stack([cand[..., 0] + cand[..., 5] * rw,
                         cand[..., 1] + cand[..., 6] * rh,
                         cand[..., 2] + cand[..., 7] * rw,
                         cand[..., 3] + cand[..., 8] * rh, cand[..., 4]], -1)
    boxes = _rerec(boxes)
    boxes = torch.cat([torch.trunc(boxes[..., :4]), boxes[..., 4:]], -1)
    boxes = _masked(boxes, boxes[..., 4], valid)

    b2 = _sorted_rows(boxes, cap2)
    prob, reg = _net(p, "rnet", _net_input(crop_resize(frames, b2, 24)))
    s2 = prob[:, 1].reshape(nf, -1)
    reg = reg.reshape(nf, -1, 4)
    b2 = _masked(b2, s2, (s2 > th[1]) & torch.isfinite(b2[..., 4]))
    m = nms(b2[..., :5].contiguous(), 0.7, "Union")
    b2 = _masked(b2, b2[..., 4], m & torch.isfinite(b2[..., 4]))
    b2 = _rerec(_bbreg(b2, reg))
    b2 = torch.cat([torch.trunc(b2[..., :4]), b2[..., 4:]], -1)

    b3 = _sorted_rows(b2, cap3)
    prob, reg, _ = _net(p, "onet", _net_input(crop_resize(frames, b3, 48)))
    s3 = prob[:, 1].reshape(nf, -1)
    reg = reg.reshape(nf, -1, 4)
    b3 = _masked(b3, s3, (s3 > th[2]) & torch.isfinite(b3[..., 4]))
    b3 = _bbreg(b3, reg)
    m = nms(b3[..., :5].contiguous(), 0.7, "Min")
    return _masked(b3, b3[..., 4], m & torch.isfinite(b3[..., 4]))[..., :5]


def select_face(boxes: torch.Tensor, frame_h: int, frame_w: int,
                margin: int):
    """Each frame's largest-centered face (area - 2 x center offset^2),
    padded by ``margin`` / 2 and clipped: ``(found [F], box [F, 4])``."""
    valid = torch.isfinite(boxes[..., 4])
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5 - frame_w / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5 - frame_h / 2.0
    rank = torch.where(valid, area - 2.0 * (cx * cx + cy * cy), _NEG_INF)
    best = torch.argmax(rank, -1)
    sel = torch.gather(boxes, 1, best[:, None, None].expand(-1, 1, 5))[:, 0]
    half = margin / 2
    box = torch.stack([torch.clamp(sel[:, 0] - half, min=0.0),
                       torch.clamp(sel[:, 1] - half, min=0.0),
                       torch.clamp(sel[:, 2] + half, max=float(frame_w)),
                       torch.clamp(sel[:, 3] + half, max=float(frame_h))], -1)
    return valid.any(-1), box


def embed_boxes(p: dict, frames: torch.Tensor, box: torch.Tensor,
                size: int) -> torch.Tensor:
    """The L2-normalized embedding of each frame's ``box`` crop: resized
    to ``size`` in grayscale (the mean of the channels) over [0, 1]."""
    crop = crop_resize(frames, box[:, None], size)[:, 0]
    gray = crop.mean(dim=-1, keepdim=True) / 255.0
    emb = efmnet342.embed({k[6:]: v for k, v in p.items()
                           if k.startswith("embed.")}, gray)
    return l2n(emb)


def match(emb: torch.Tensor, gallery_n: torch.Tensor):
    """Cosine argmax over the normalized gallery: ``(index, similarity,
    margin)``, the margin being the gap to the second best row."""
    sims = emb @ gallery_n.T
    top, idx = torch.topk(sims, 2, dim=-1)
    return idx[:, 0], top[:, 0], top[:, 0] - top[:, 1]
