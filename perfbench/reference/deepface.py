"""DeepFace as published, plain (Taigman et al., CVPR 2014, Sec. 3 and
Fig. 2), over channel-last ``[B, H, W, 3]`` input in [0, 1]:

C1 11x11 conv 3 -> 32, VALID, ReLU; M2 3x3/2 max-pool, its output size
rounded up (Caffe's pooling: 142 -> 71); C3 9x9 conv 32 -> 16, ReLU; L4,
L5, L6 locally connected (untied weights, one filter bank per output
position) 9x9 at stride 1, 7x7 at stride 2, 5x5 at stride 1, 16 maps
each, ReLU; F7 dense over the channel-last flatten -> 4,096, ReLU, the
feature; F8 dense -> the ID logits. At 152x152: 142, 71, 63, 55, 25, 21.

Departures, as the configuration states them: C3's filters take C1's 32
maps (the figure prints 9x9x16 without the input depth); no
frontalisation and no test-time normalisation of F7.

A locally connected layer here takes the strided windows of the input
(``Tensor.unfold`` on the two spatial axes) and contracts each output
position's window with its own kernel in one ``einsum``: not the
program's ``F.unfold`` and position-major product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .plain import conv

# (name, kernel, stride) of the locally connected layers
LC = (("l4", 9, 1), ("l5", 7, 2), ("l6", 5, 1))


def sizes(hw) -> list[tuple[int, int]]:
    """The (H, W) after C1, M2, C3, L4, L5 and L6."""
    h, w = (s - 10 for s in hw)
    out = [(h, w)]
    h, w = (-(-(n - 3) // 2) + 1 for n in (h, w))
    out.append((h, w))
    h, w = h - 8, w - 8
    out.append((h, w))
    for _, k, s in LC:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        out.append((h, w))
    return out


def specs(cfg: dict) -> list:
    c1, c3, f = cfg["c1"], cfg["c3"], cfg["lc_features"]
    s = sizes(cfg["input_hw"])
    out = [("c1.weight", (c1, 3, 11, 11), "w", 3 * 121),
           ("c1.bias", (c1,), "b", 0),
           ("c3.weight", (c3, c1, 9, 9), "w", c1 * 81),
           ("c3.bias", (c3,), "b", 0)]
    cin = c3
    for (name, k, _), (oh, ow) in zip(LC, s[3:]):
        out += [(f"{name}.kernel", (oh, ow, cin * k * k, f), "w",
                 cin * k * k),
                (f"{name}.bias", (oh, ow, f), "b", 0)]
        cin = f
    oh, ow = s[-1]
    out += [("f7.weight", (cfg["f7"], oh * ow * f), "w", oh * ow * f),
            ("f7.bias", (cfg["f7"],), "b", 0),
            ("f8.weight", (cfg["num_classes"], cfg["f7"]), "w", cfg["f7"]),
            ("f8.bias", (cfg["num_classes"],), "b", 0)]
    return out


def locally_connected(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, OH, OW, F]`` with ``kernel`` [OH, OW,
    C*K*K, F] (each position's patch ordered channel, row, column)."""
    oh, ow, _, f = kernel.shape
    win = x.unfold(1, k, s).unfold(2, k, s)           # [B, OH, OW, C, K, K]
    w = kernel.reshape(oh, ow, x.shape[3], k, k, f)
    return torch.einsum("bhwcij,hwcijf->bhwf", win, w) + bias


def embed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` -> the F7 feature (after its ReLU)."""
    x = torch.relu(conv(x, p["c1.weight"], p["c1.bias"]))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2,
                     ceil_mode=True).permute(0, 2, 3, 1)
    x = torch.relu(conv(x, p["c3.weight"], p["c3.bias"]))
    for name, k, s in LC:
        x = torch.relu(locally_connected(x, p[name + ".kernel"],
                                         p[name + ".bias"], k, s))
    x = x.reshape(x.shape[0], -1)
    return torch.relu(x @ p["f7.weight"].T + p["f7.bias"])


def logits(p: dict, feat: torch.Tensor) -> torch.Tensor:
    return feat @ p["f8.weight"].T + p["f8.bias"]
