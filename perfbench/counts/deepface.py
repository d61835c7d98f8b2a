"""DeepFace's model FLOPs and its locally connected layers' least time,
from the configuration's shapes, whatever computes them.

FLOPs are ``models.py``'s: 2 per multiply-add of every convolution,
locally connected and dense layer; a training step is the forward and a
backward of twice it, less C1's input gradient, which nothing needs.

An LC layer's least time is that of its forward product and its two
backward products (the input's gradient and the kernel's), each the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s
(float32 outside the tensor cores, the configuration's precision). Each
tensor a product reads or writes counts once: the forward reads the
input, the kernel and the bias and writes the output; the input's
gradient reads the output's gradient and the kernel and writes the
input's; the kernel's reads the input and the output's gradient and
writes the kernel's and the bias's gradients. However the program lays
out its patches, these are the least bytes the layer has to move.
"""

from __future__ import annotations

import math

from .kernels import least_s
from .models import conv, dense

# (kernel, stride) of L4, L5, L6
LC = ((9, 1), (7, 2), (5, 1))


def ladder(cfg: dict) -> dict:
    """The sides after C1, M2 and C3, and each LC layer's ``(H_in, W_in,
    C, OH, OW, K, F)``."""
    h, w = (s - 10 for s in cfg["input_hw"])
    c1 = (h, w)
    h, w = (-(-(n - 3) // 2) + 1 for n in (h, w))
    m2 = (h, w)
    h, w = h - 8, w - 8
    c3 = (h, w)
    cin, f = cfg["c3"], cfg["lc_features"]
    lc = []
    for k, s in LC:
        oh, ow = (h - k) // s + 1, (w - k) // s + 1
        lc.append((h, w, cin, oh, ow, k, f))
        h, w, cin = oh, ow, f
    return {"c1": c1, "m2": m2, "c3": c3, "lc": lc}


def _lc_ops(b: int, layer) -> int:
    _, _, c, oh, ow, k, f = layer
    return 2 * b * oh * ow * c * k * k * f


def c1_flops(b: int, cfg: dict) -> int:
    return conv(b, *ladder(cfg)["c1"], 3, cfg["c1"], 11)


def forward(b: int, cfg: dict) -> int:
    """The forward over ``b`` images, with the ID logits."""
    lad = ladder(cfg)
    flops = c1_flops(b, cfg) + conv(b, *lad["c3"], cfg["c1"], cfg["c3"], 9)
    flops += sum(_lc_ops(b, layer) for layer in lad["lc"])
    _, _, _, oh, ow, _, f = lad["lc"][-1]
    return (flops + dense(b, oh * ow * f, cfg["f7"])
            + dense(b, cfg["f7"], cfg["num_classes"]))


def train(b: int, cfg: dict) -> int:
    """A training step's forward and backward over ``b`` images."""
    return 3 * forward(b, cfg) - c1_flops(b, cfg)


def lc_least_s(b: int, cfg: dict) -> float:
    """The LC layers' least seconds in one training step over ``b``
    images: each layer's forward and two backward products."""
    total = []
    for layer in ladder(cfg)["lc"]:
        h, w, c, oh, ow, k, f = layer
        x, y = b * h * w * c, b * oh * ow * f
        kern, bias = oh * ow * c * k * k * f, oh * ow * f
        ops = _lc_ops(b, layer)
        total += [least_s((x + kern + bias + y) * 4, ops),
                  least_s((y + kern + x) * 4, ops),
                  least_s((x + y + kern + bias) * 4, ops)]
    return math.fsum(total)
