"""LightCNN-29 with 3-way EFM, plain (``lightcnn.py:73-133`` of the
reference): stem 99 -> EFM3 -> pool, groups 2-5 = residual EFM chains ->
1x1 conv -> EFM3 -> 3x3 conv -> EFM3 -> pool on the ladder (1,99), (2,198),
(3,387), (4,261), then fc1 1026 -> EFM3 = the 684-d feature. The ID
logits are fc2 over the dropped-out raw feature; the returned feature is
its BatchNorm (flax's: the batch's biased variance in training, the
running statistics in evaluation)."""

from __future__ import annotations

import torch

from .plain import conv, efm3, maxpool2, res_block, stem
from .weights import conv_spec, dense_spec, res_spec

# (residual blocks, res filters, 1x1 filters, 3x3 filters) of groups 2-5
LADDER = [(1, 99, 99, 198), (2, 198, 198, 387), (3, 387, 387, 261),
          (4, 261, 261, 261)]


def specs(cfg: dict) -> list:
    out = conv_spec("group1.conv", 1, cfg["stem_filters"], 5)
    for g, (nres, rf, pf, cf) in enumerate(LADDER):
        out += res_spec(f"res.{g}", nres, rf)
    for g, (nres, rf, pf, cf) in enumerate(LADDER):
        out += conv_spec(f"convs.{g}.pre_conv", rf * 2 // 3, pf, 1)
        out += conv_spec(f"convs.{g}.conv", pf * 2 // 3, cf, 3)
    h, w = (s // 32 for s in cfg["input_hw"])
    feat = cfg["fc1"] * 2 // 3
    out += dense_spec("fc1", h * w * LADDER[-1][3] * 2 // 3, cfg["fc1"])
    out += [("fc1_bn.weight", (feat,), "bn_w", 0),
            ("fc1_bn.bias", (feat,), "bn_b", 0),
            ("fc1_bn.running_mean", (feat,), "zeros", 0),
            ("fc1_bn.running_var", (feat,), "ones", 0)]
    out += dense_spec("fc2", feat, cfg["num_classes"])
    return out


def embed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 1]`` in [0, 1] -> the raw 684-d feature."""
    x = stem(x, p["group1.conv.weight"], p["group1.conv.bias"])
    for g, (nres, rf, pf, cf) in enumerate(LADDER):
        x = res_block(x, p, f"res.{g}", nres)
        k = f"convs.{g}"
        x = efm3(conv(x, p[k + ".pre_conv.weight"], p[k + ".pre_conv.bias"]))
        x = efm3(conv(x, p[k + ".conv.weight"], p[k + ".conv.bias"], 1))
        x = maxpool2(x)
    x = x.reshape(x.shape[0], -1)
    return efm3(x @ p["fc1.weight"].T + p["fc1.bias"])


def batch_norm(p: dict, feat: torch.Tensor, train: bool) -> torch.Tensor:
    """flax's BatchNorm of the feature (eps 1e-5)."""
    if train:
        mean = feat.mean(0)
        var = torch.clamp_min((feat * feat).mean(0) - mean * mean, 0.0)
    else:
        mean, var = p["fc1_bn.running_mean"], p["fc1_bn.running_var"]
    return ((feat - mean) * (torch.rsqrt(var + 1e-5) * p["fc1_bn.weight"])
            + p["fc1_bn.bias"])


def logits(p: dict, feat: torch.Tensor) -> torch.Tensor:
    return feat @ p["fc2.weight"].T + p["fc2.bias"]
