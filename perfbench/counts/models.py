"""Model FLOPs from a configuration's shapes: 2 per multiply-add of every
convolution and dense layer, whatever runs them.

Each function gives the FLOPs of one forward over a batch; a training
step counts the forward and a backward of twice it, less the first
convolution's input gradient, which nothing needs. The tests hold each
count to ``torch.utils.flop_counter.FlopCounterMode`` over the plain
reference.
"""

from __future__ import annotations

import math

EFM342_LADDER = [(99, 198, 1), (198, 387, 2), (387, 261, 3), (261, 261, 4)]
LCNN29_LADDER = [(1, 99, 99, 198), (2, 198, 198, 387), (3, 387, 387, 261),
                 (4, 261, 261, 261)]


def conv(b: int, h: int, w: int, cin: int, cout: int, k: int) -> int:
    """A conv with ``h x w`` outputs."""
    return 2 * b * h * w * cin * cout * k * k


def dense(b: int, cin: int, cout: int) -> int:
    return 2 * b * cin * cout


def _res(b, hw, blocks, filters):
    out_ch = filters * 2 // 3
    return blocks * (conv(b, hw, hw, out_ch * 2 // 3, filters, 3)
                     + conv(b, hw, hw, filters * 2 // 3, out_ch, 3))


def efmnet342(b: int, size: int, stem_filters: int = 99,
              fc1: int = 513) -> int:
    """EFMNet342's embedding (no ID logits) of ``b`` crops of ``size``."""
    flops = conv(b, size, size, 1, stem_filters, 5)
    hw, cin = size // 2, stem_filters * 2 // 3
    for num_r, num, tar in EFM342_LADDER:
        flops += _res(b, hw, tar, num_r)
        flops += conv(b, hw, hw, cin, num_r, 1)
        flops += conv(b, hw, hw, num_r * 2 // 3, num, 3)
        hw, cin = hw // 2, num * 2 // 3
    return flops + dense(b, hw * hw * cin, fc1)


def lightcnn29_stem(b: int, hw) -> int:
    return conv(b, hw[0], hw[1], 1, 99, 5)


def lightcnn29(b: int, hw, num_classes: int, fc1: int = 1026) -> int:
    """LightCNN-29's forward over ``b`` images of ``hw``, with the ID
    logits."""
    h, w = hw
    flops = lightcnn29_stem(b, hw)
    h, w = h // 2, w // 2
    for nres, rf, pf, cf in LCNN29_LADDER:
        out_ch = rf * 2 // 3
        flops += nres * (conv(b, h, w, out_ch * 2 // 3, rf, 3)
                         + conv(b, h, w, rf * 2 // 3, out_ch, 3))
        flops += conv(b, h, w, rf * 2 // 3, pf, 1)
        flops += conv(b, h, w, pf * 2 // 3, cf, 3)
        h, w = h // 2, w // 2
    flops += dense(b, h * w * LCNN29_LADDER[-1][3] * 2 // 3, fc1)
    return flops + dense(b, fc1 * 2 // 3, num_classes)


def lightcnn29_train(b: int, hw, num_classes: int) -> int:
    """A training step's forward and backward over ``b`` images."""
    fwd = lightcnn29(b, hw, num_classes)
    return 3 * fwd - lightcnn29_stem(b, hw)


def _valid(n: int, k: int) -> int:
    return n - k + 1


def _pool(n: int, k: int, s: int, same: bool) -> int:
    return -(-n // s) if same else (n - k) // s + 1


def pnet(b: int, h: int, w: int) -> int:
    h1, w1 = _valid(h, 3), _valid(w, 3)
    flops = conv(b, h1, w1, 3, 10, 3)
    h1, w1 = _pool(h1, 2, 2, True), _pool(w1, 2, 2, True)
    h2, w2 = _valid(h1, 3), _valid(w1, 3)
    flops += conv(b, h2, w2, 10, 16, 3)
    h3, w3 = _valid(h2, 3), _valid(w2, 3)
    flops += conv(b, h3, w3, 16, 32, 3)
    return flops + conv(b, h3, w3, 32, 2, 1) + conv(b, h3, w3, 32, 4, 1)


def rnet(b: int) -> int:
    flops = conv(b, 22, 22, 3, 28, 3)               # 24 -> 22, pool -> 11
    flops += conv(b, 9, 9, 28, 48, 3)               # 11 -> 9, pool -> 4
    flops += conv(b, 3, 3, 48, 64, 2)               # 4 -> 3
    return flops + dense(b, 576, 128) + dense(b, 128, 2) + dense(b, 128, 4)


def onet(b: int) -> int:
    flops = conv(b, 46, 46, 3, 32, 3)               # 48 -> 46, pool -> 23
    flops += conv(b, 21, 21, 32, 64, 3)             # 23 -> 21, pool -> 10
    flops += conv(b, 8, 8, 64, 64, 3)               # 10 -> 8, pool -> 4
    flops += conv(b, 3, 3, 64, 128, 2)              # 4 -> 3
    return (flops + dense(b, 1152, 256) + dense(b, 256, 2)
            + dense(b, 256, 4) + dense(b, 256, 10))


def pyramid(h: int, w: int, minsize: int, factor: float) -> list[float]:
    minl, m, scales, count = min(h, w) * 12.0 / minsize, 12.0 / minsize, [], 0
    while minl >= 12:
        scales.append(m * factor ** count)
        minl *= factor
        count += 1
    return scales


def serve_dispatch(cfg: dict, streams: int) -> int:
    """One dispatch of the serving pipeline over ``streams`` frames: PNet
    on every pyramid level, RNet and ONet on their fixed capacities, the
    embedding of one crop a frame and the gallery product."""
    c, (h, w) = cfg["cascade"], cfg["frame_hw"]
    flops = sum(pnet(streams, math.ceil(h * s), math.ceil(w * s))
                for s in pyramid(h, w, c["minsize"], c["factor"]))
    flops += rnet(streams * c["stage2_cap"]) + onet(streams * c["out_cap"])
    e = cfg["embed"]
    flops += efmnet342(streams, e["image_size"], e["stem_filters"], e["fc1"])
    return flops + 2 * streams * cfg["gallery_rows"] * (e["fc1"] * 2 // 3)
