"""EFMNet342, plain: the symbol-ladder EFM net of ``efm_symbol.py:81-110``
(stem 99 with EFM3 and a pool, stages with the 99/198/387/261/261 ladder
and residual counts [1, 2, 3, 4], fc1 513 -> EFM3 = the 342-d feature) on
``[B, S, S, 1]`` grayscale crops in [0, 1], S a multiple of 32."""

from __future__ import annotations

import torch

from .plain import conv, efm3, maxpool2, res_block, stem
from .weights import conv_spec, dense_spec, res_spec

# (res filters, conv filters, residual blocks) of stages 2-5
LADDER = [(99, 198, 1), (198, 387, 2), (387, 261, 3), (261, 261, 4)]


def specs(cfg: dict) -> list:
    """The parameter entries of the net ``cfg`` describes (``image_size``,
    ``num_classes``; the ladder is the published one)."""
    out = conv_spec("conv1.conv", 1, cfg["stem_filters"], 5)
    cin = cfg["stem_filters"] * 2 // 3
    for s, (num_r, num, tar) in enumerate(LADDER):
        out += res_spec(f"res.{s}", tar, num_r)
    for s, (num_r, num, tar) in enumerate(LADDER):
        out += conv_spec(f"conv1x1.{s}", cin, num_r, 1)
        cin = num * 2 // 3
    for s, (num_r, num, tar) in enumerate(LADDER):
        out += conv_spec(f"conv.{s}", num_r * 2 // 3, num, 3)
    side = cfg["image_size"] // 32
    out += dense_spec("fc1", side * side * cin, cfg["fc1"])
    out += dense_spec("fc2", cfg["fc1"] * 2 // 3, cfg["num_classes"])
    return out


def embed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``[B, S, S, 1]`` -> the raw 342-d feature ``[B, 342]``."""
    x = stem(x, p["conv1.conv.weight"], p["conv1.conv.bias"])
    for s, (num_r, num, tar) in enumerate(LADDER):
        x = res_block(x, p, f"res.{s}", tar)
        x = efm3(conv(x, p[f"conv1x1.{s}.weight"], p[f"conv1x1.{s}.bias"]))
        x = efm3(conv(x, p[f"conv.{s}.weight"], p[f"conv.{s}.bias"], 1))
        x = maxpool2(x)
    x = x.reshape(x.shape[0], -1)
    return efm3(x @ p["fc1.weight"].T + p["fc1.bias"])
